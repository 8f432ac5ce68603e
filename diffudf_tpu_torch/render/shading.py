"""Shading models, Blinn-Phong and anisotropic Ward, the RdYlBu colormap of
the curvature plots and the bwr_r colormap of the slice figure: host numpy,
a copy of ``diffudf_tpu/render/shading.py``.

Same formulas as the reference: grey albedo (0.7 diffuse / 0.7 specular /
0.2 ambient), the 0.9 clip, the Ward weight with the principal-direction
anisotropy terms.  :func:`rdylbu` and :func:`bwr_r` are this package's own
copies of matplotlib's ``RdYlBu`` and ``bwr_r`` colormaps, so neither a
render nor a figure needs matplotlib.
"""

from __future__ import annotations

import numpy as np

# matplotlib's RdYlBu: 11 colours spaced evenly over [0, 1] (ColorBrewer)
_RDYLBU_ANCHORS = np.array([
    (0.6470588235294118, 0.0, 0.14901960784313725),
    (0.8431372549019608, 0.18823529411764706, 0.15294117647058825),
    (0.9568627450980393, 0.42745098039215684, 0.2627450980392157),
    (0.9921568627450981, 0.6823529411764706, 0.3803921568627451),
    (0.996078431372549, 0.8784313725490196, 0.5647058823529412),
    (1.0, 1.0, 0.7490196078431373),
    (0.8784313725490196, 0.9529411764705882, 0.9725490196078431),
    (0.6705882352941176, 0.8509803921568627, 0.9137254901960784),
    (0.4549019607843137, 0.6784313725490196, 0.8196078431372549),
    (0.27058823529411763, 0.4588235294117647, 0.7058823529411765),
    (0.19215686274509805, 0.21176470588235294, 0.5843137254901961),
])
# matplotlib's bwr_r: bwr's three colours (blue, white, red) reversed
_BWR_R_ANCHORS = np.array([(1.0, 0.0, 0.0), (1.0, 1.0, 1.0), (0.0, 0.0, 1.0)])
_LUT_SIZE = 256


def _lut(anchors: np.ndarray, n: int = _LUT_SIZE) -> np.ndarray:
    """(n, 3) lookup table: entry i linearly interpolates the anchors, spaced
    evenly over [0, 1], at i / (n − 1), with matplotlib's arithmetic, so
    the values agree to the bit."""
    x = np.linspace(0.0, 1.0, len(anchors)) * (n - 1)
    xind = (n - 1) * np.linspace(0.0, 1.0, n)
    ind = np.searchsorted(x, xind)[1:-1]
    dist = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    cols = []
    for y in anchors.T:
        lut = np.concatenate([[y[0]], dist * (y[ind] - y[ind - 1]) + y[ind - 1], [y[-1]]])
        cols.append(np.clip(lut, 0.0, 1.0))
    return np.stack(cols, axis=-1)


def _lookup(table: np.ndarray, x) -> np.ndarray:
    """RGB (..., 3) of values in [0, 1], as a matplotlib colormap gives
    them: entry ``int(x · 256)``, 1.0 and above to the last entry, below 0
    to the first, NaN to black."""
    xa = np.array(x, copy=True)
    xa *= _LUT_SIZE
    bad = np.isnan(xa)
    with np.errstate(invalid="ignore"):
        idx = np.clip(np.where(bad, 0, xa), 0, _LUT_SIZE - 1).astype(int)
    rgb = table[idx]
    rgb[bad] = 0.0
    return rgb


def rdylbu(x) -> np.ndarray:
    """``matplotlib.colormaps["RdYlBu"](x)[..., :3]`` (see :func:`_lookup`)."""
    return _lookup(_lut(_RDYLBU_ANCHORS), x)


def bwr_r(x) -> np.ndarray:
    """``matplotlib.colormaps["bwr_r"](x)[..., :3]`` (see :func:`_lookup`):
    the slice figure's colormap."""
    return _lookup(_lut(_BWR_R_ANCHORS), x)


def _normalize(a):
    return a / np.maximum(np.linalg.norm(a, axis=-1, keepdims=True), 1e-12)


def _colors(color_map, n):
    if color_map is None:
        grey = np.tile(np.array([0.7, 0.7, 0.7]), (n, 1))
        return grey, grey.copy(), np.tile(np.array([0.2, 0.2, 0.2]), (n, 1))
    return color_map * 0.7, color_map * 0.7, color_map * 0.2


def phong_shading(light_position, shininess, hits, samples, normals, color_map=None):
    """(image colors (N_pixels, 3)); non-hit pixels stay white."""
    light_position = np.asarray(light_position, dtype=np.float64)
    pts = samples[hits]
    n = len(pts)
    light_dirs = _normalize(light_position[None, :] - pts)
    lambertian = np.maximum(np.sum(normals * light_dirs, axis=1, keepdims=True), 0.0)

    reflect = (-light_dirs) - 2.0 * np.sum(normals * (-light_dirs), axis=1, keepdims=True) * normals
    view = _normalize(pts)
    spec_angles = np.maximum(np.sum(reflect * view, axis=1), 0.0)

    specular = np.zeros_like(lambertian)
    if shininess > 0:
        s = np.power(spec_angles, shininess)[:, None]
        specular[lambertian[:, 0] > 0] = s[lambertian[:, 0] > 0]

    diffuse_c, spec_c, ambient_c = _colors(color_map, n)
    colors = np.ones_like(samples)
    colors[hits] = np.clip(
        diffuse_c * lambertian + spec_c * specular + ambient_c, 0.0, 0.9
    )
    return colors


def ward_reflectance(
    light_position, camera_position, hits, samples, normals,
    alpha1, alpha2, pc1, pc2, color_map=None,
):
    """Anisotropic Ward BRDF using principal curvature directions."""
    light_position = np.asarray(light_position, dtype=np.float64)
    camera_position = np.asarray(camera_position, dtype=np.float64)
    pts = samples[hits]
    n = len(pts)
    light_dirs = _normalize(light_position[None, :] - pts)
    lambertian = np.maximum(np.sum(normals * light_dirs, axis=1, keepdims=True), 0.0)

    viewer_dirs = _normalize(camera_position[None, :] - pts)
    H = _normalize(viewer_dirs + light_dirs)

    def dot(a, b):
        return np.sum(a * b, axis=-1)

    # reference semantics: a back-facing sqrt(negative) is left to give NaN,
    # which nan_to_num turns into a zero specular term (clamping the product
    # to 0 would send the weight to +inf and the pixel to full specular)
    with np.errstate(invalid="ignore", divide="ignore"):
        weight = 1.0 / (
            4.0 * np.pi * alpha1 * alpha2
            * np.sqrt(dot(normals, light_dirs) * dot(normals, viewer_dirs))
        )
        specular = weight * np.exp(
            -2.0 * ((dot(H, pc1) / alpha1) ** 2 + (dot(H, pc2) / alpha2) ** 2)
            / (1.0 + dot(normals, H))
        )
    specular = np.nan_to_num(specular)[:, None] * 0.1

    diffuse_c, spec_c, ambient_c = _colors(color_map, n)
    colors = np.ones_like(samples)
    colors[hits] = np.clip(
        diffuse_c * lambertian + spec_c * specular + ambient_c, 0.0, 0.9
    )
    return colors
