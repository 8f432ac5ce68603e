"""Port parity: the slice figure of ``diffudf_tpu_torch`` (``grid/slices.py``
and its bwr_r colormap) against the JAX package and matplotlib, on the
same numpy inputs, on the CPU.  On the CPU the prediction takes the plain
Taylor-mode functions; K1 is held to its plain version on a GPU
(tests/test_torch_cuda.py)."""

import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch
from PIL import Image

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from diffudf_tpu.fields import transforms as jtf  # noqa: E402
from diffudf_tpu.fields.siren import SirenSpec as JaxSpec  # noqa: E402
from diffudf_tpu.grid import slices as jsl  # noqa: E402
from diffudf_tpu_torch.fields.siren import SirenSpec, init_siren, params_from_jax  # noqa: E402
from diffudf_tpu_torch.grid import slices as tsl  # noqa: E402
from diffudf_tpu_torch.render import shading  # noqa: E402

torch.set_num_threads(2)

EPS = 1e-3  # the figure's surf_thresh
ALPHA = 10.0
WIDTH = 32


def _net(head_scale=0.15):
    """A 3x32 SIREN whose head is scaled down so that |grad f| falls below
    the 0.04 switch on part of the plane: both normal branches show."""
    spec = SirenSpec(hidden=(32,) * 3)
    params = init_siren(spec, np.random.default_rng(0))
    params[-1] = {"w": params[-1]["w"] * head_scale, "b": params[-1]["b"]}
    jparams = [{k: jnp.asarray(v) for k, v in layer.items()} for layer in params]
    return spec, params_from_jax(params, "cpu"), JaxSpec(hidden=spec.hidden), jparams


def test_plane_samples_are_the_jax_samples():
    np.testing.assert_array_equal(tsl.plane_samples(33), jsl.plane_samples(33))


@pytest.fixture(scope="module")
def slices():
    """(port prediction, JAX prediction, GT distances of a circle) at WIDTH."""
    spec, params, jspec, jparams = _net()
    r = np.sqrt((jsl.plane_samples(WIDTH)[:, 1:] ** 2).sum(1)) - 0.5
    d = np.abs(np.where(r > 0, r, -0.3 * r)).astype(np.float64)
    return (tsl.predicted_slice(params, spec, WIDTH), jsl.predicted_slice(jparams, jspec, WIDTH),
            d)


def test_predicted_slice_matches_jax(slices):
    """Width 32: f and |grad f| to 1e-5, the normals to 1e-4 on both
    branches (the unit gradient and the sign-aligned Hessian eigenvector)."""
    got, want, _ = slices
    np.testing.assert_allclose(got["f"], want["f"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=0, atol=1e-5)
    low = want["grad_norm"] < 0.04
    assert 0.05 < low.mean() < 0.95  # both branches are exercised
    steady = np.abs(want["grad_norm"] - 0.04) > 1e-4  # same branch in both packages
    np.testing.assert_allclose(got["normals"][steady], want["normals"][steady], rtol=0,
                               atol=1e-4)


def test_bwr_r_is_matplotlibs_to_the_bit():
    x = np.concatenate([np.linspace(0, 1, 10001), [-0.5, -1e-9, 1.0, 1.0 + 1e-9, 3.0, np.nan],
                        np.random.default_rng(0).random(1000)])
    cmap = matplotlib.colormaps["bwr_r"]
    for dt in (np.float64, np.float32):
        np.testing.assert_array_equal(shading.bwr_r(x.astype(dt)), cmap(x.astype(dt))[:, :3])


def _jax_panels(pred, d):
    """The JAX package's four clipped panels, computed as its
    ``render_slice_figure`` computes them."""
    gt_f = np.asarray(jtf.gt_transform("tanh", jnp.asarray(d), ALPHA))
    gt_gn = np.asarray(jtf.gt_grad_norm("tanh", jnp.asarray(d), ALPHA))
    return [np.clip(a, None, 1.5) for a in (gt_f, pred["f"], gt_gn, pred["grad_norm"])]


def _signed_panel(width):
    """A float32 field panel with every case: negative (masked), the zero
    band, and values across the 17 bands up to the 1.5 clip."""
    v = np.random.default_rng(5).uniform(-0.3, 2.0, width * width).astype(np.float32)
    v[::7] = np.float32(0.0)
    v[3::11] = np.float32(5e-4)
    return np.clip(v, None, 1.5)


def _masked(v, width):
    img = v.reshape(width, width)
    return np.ma.masked_less(np.ma.masked_inside(img, -EPS, EPS), 0)


def test_panel_colours_are_matplotlibs_on_the_jax_arrays(slices):
    """imshow panels (|grad f|): bwr_r of Normalize(-1.5, 1.5), to the bit;
    field panels: the colour contourf gives each of the 17 bands; masked
    pixels white, the zero band black."""
    _, jpred, d = slices
    width = WIDTH
    panels = _jax_panels(jpred, d)
    panels[1] = _signed_panel(width)
    cmap = matplotlib.colormaps["bwr_r"]
    norm = matplotlib.colors.Normalize(vmin=-1.5, vmax=1.5)
    levels = np.linspace(-1.5, 1.5, 18)
    fig, ax = plt.subplots()
    try:
        for i, v in enumerate(panels):
            got = tsl.panel_colors(v, width, EPS, bands=i < 2)
            img = v.reshape(width, width)
            masked = _masked(v, width)
            if i < 2:
                cs = ax.contourf(masked, levels=levels, cmap="bwr_r")
                band_rgb = cs.to_rgba(cs.cvalues)[:, :3]
                band = np.clip(np.digitize(img, levels, right=True) - 1, 0, 16)
                want = band_rgb[band]
            else:
                want = cmap(norm(img))[..., :3]
            want[np.ma.getmaskarray(masked)] = 1.0
            want[np.abs(img) <= EPS] = 0.0
            np.testing.assert_array_equal(got, want)
        assert (np.abs(panels[1]) <= EPS).any() and (panels[1] < -EPS).any()
    finally:
        plt.close(fig)


def test_figure_files_match_the_jax_figure(slices, tmp_path):
    """Both packages draw the figure of one net at width 32: pred_grad.png
    decodes to the JAX pixels, at most 1 level apart on at most 0.1% of
    them; distance_fields.png is the 2x2 mosaic of 32x32 panels."""
    pred, jpred, d = slices
    width = WIDTH
    jsl.render_slice_figure(jpred, d, "tanh", ALPHA, width, str(tmp_path / "jax"),
                            surf_thresh=EPS)
    fields, grad = tsl.render_slice_figure(pred, d, "tanh", ALPHA, width, str(tmp_path / "port"),
                                           surf_thresh=EPS)
    want = np.asarray(Image.open(tmp_path / "jax" / "pred_grad.png").convert("RGB"), np.int16)
    got = np.asarray(Image.open(tmp_path / "port" / "pred_grad.png"), np.int16)
    np.testing.assert_array_equal(got, grad)
    diff = np.abs(got - want).max(-1)
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    mosaic = np.asarray(Image.open(tmp_path / "port" / "distance_fields.png"))
    assert mosaic.shape == (2 * width, 2 * width, 3)
    np.testing.assert_array_equal(mosaic, fields)
    panels = [tsl.panel_colors(p, width, EPS, bands=i < 2) for i, p in
              enumerate(tsl.figure_panels(pred, d, "tanh", ALPHA, EPS))]
    np.testing.assert_array_equal(mosaic[width:, :width], (panels[2] * 255).astype(np.uint8))
    np.testing.assert_array_equal(mosaic[:width, width:], (panels[1] * 255).astype(np.uint8))


@pytest.mark.parametrize("mode", ["tanh", "squared", "siren"])
def test_gt_panels_follow_the_jax_transforms(mode):
    """Both run the closed forms in float32; torch's and XLA's tanh differ
    by a few ulps, hence 1e-5 relative."""
    d = np.linspace(0, 0.6, 400)
    pred = {"f": np.zeros(400, np.float32), "grad_norm": np.zeros(400, np.float32)}
    gt_f, _, gt_gn, _ = tsl.figure_panels(pred, d, mode, ALPHA, EPS)
    want_f = np.clip(np.asarray(jtf.gt_transform(mode, jnp.asarray(d), ALPHA)), None, 1.5)
    if mode == "siren":
        want_gn = (d >= EPS).astype(np.float64)
    else:
        want_gn = np.clip(np.asarray(jtf.gt_grad_norm(mode, jnp.asarray(d), ALPHA)), None, 1.5)
    np.testing.assert_allclose(gt_f, want_f, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(gt_gn, want_gn, rtol=1e-5, atol=1e-7)
