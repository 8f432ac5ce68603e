"""2D level-set slice diagnostics, the training's built-in eyeball test: the
torch counterpart of ``diffudf_tpu/grid/slices.py``.

On the x=0 plane, :func:`render_slice_figure` writes ``distance_fields.png``
(GT field / predicted field / GT |∇f| / predicted |∇f|) and the normal map
``pred_grad.png``, whose per-pixel normals come from ∇f/|∇f| where
|∇f| ≥ 0.04 and from the sign-aligned Hessian top eigenvector elsewhere
(:func:`predicted_slice`, one K1 launch on a CUDA device).

The figure is drawn without matplotlib or PIL: ``pred_grad.png`` has the
JAX package's pixels, written by :mod:`..render.png`, and
``distance_fields.png`` is a 2×2 mosaic of W×W panels, one pixel a sample,
laid out as the JAX figure's axes.  Each panel follows ``_imagen_dist``:
values clipped to ≤ 1.5, masked (white) where |v| ≤ eps or v < 0, colours
from the package's own ``bwr_r`` (:func:`..render.shading.bwr_r`) at
vmin −1.5 and vmax 1.5.  The two field panels are quantised to the 17
bands of ``linspace(-1.5, 1.5, 18)``, in the colours ``contourf`` fills
them with; the zero band |v| ≤ eps is drawn black, standing for the
zero-level contour.  Titles, axis labels and the colorbar are not drawn.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..autodiff.eigh3 import top_eigenvector
from ..fields.siren import SirenSpec
from ..fields.transforms import gt_grad_norm, gt_transform
from ..ops.evaluate import evaluate_field
from ..render.png import write_png
from ..render.shading import bwr_r

VMIN, VMAX = -1.5, 1.5
LEVELS = np.linspace(VMIN, VMAX, 18)  # the contour levels of the field panels


def plane_samples(width: int) -> np.ndarray:
    """(W², 3) samples on the x=0 plane; row = y ∈ [1,-1], col = z ∈ [1,-1]
    (the reference's plane, ``generate_df.py:62-79``)."""
    ranges = np.linspace(1.0, -1.0, width)
    zz, yy = np.meshgrid(ranges, ranges, indexing="xy")  # col→z, row→y
    samples = np.stack([np.zeros_like(zz), yy, zz], axis=-1).reshape(width * width, 3)
    return samples.astype(np.float32)


def predicted_slice(params, spec: SirenSpec, width: int) -> dict:
    """-> dict of host arrays f (W²,), grad_norm (W²,), normals (W², 3), on
    the params' device."""
    pts = torch.as_tensor(plane_samples(width), device=params[0]["w"].device)
    with torch.no_grad():
        ev = evaluate_field(params, spec, pts, want_grad=True, want_hess=True)
        gnorm = torch.linalg.norm(ev.grad, dim=-1)
        unit_grad = ev.grad / torch.clamp(gnorm[:, None], min=1e-12)
        hnormal = top_eigenvector(ev.hess)
        sign = torch.where((unit_grad * hnormal).sum(-1, keepdim=True) < 0, -1.0, 1.0)
        normals = torch.where(gnorm[:, None] < 0.04, sign * hnormal, unit_grad)
    return {"f": ev.f.cpu().numpy(), "grad_norm": gnorm.cpu().numpy(),
            "normals": normals.cpu().numpy()}


def panel_colors(values, width: int, eps: float, bands: bool = False) -> np.ndarray:
    """(W, W, 3) float RGB of one panel of (W²,) values, already clipped.

    Unbanded: ``bwr_r`` of (v − vmin) / (vmax − vmin) in the values' own
    type, as ``imshow`` normalises.  Banded: the colour of the band
    (l_i, l_{i+1}] that holds v (the lowest band closed below), taken at the
    band's midpoint, as ``contourf`` colours its layers.  Masked pixels are
    white; the zero band is black."""
    v = np.asarray(values).reshape(width, width)
    if bands:
        band = np.clip(np.searchsorted(LEVELS, v, side="left") - 1, 0, len(LEVELS) - 2)
        shown = (0.5 * (LEVELS[:-1] + LEVELS[1:]))[band]
    else:
        shown = v
    rgb = bwr_r((shown - VMIN) / (VMAX - VMIN))
    zero = np.abs(v) <= eps
    rgb[zero | (v < 0)] = 1.0
    rgb[zero] = 0.0
    return rgb


def figure_panels(pred: dict, gt_distances, gt_mode: str, alpha: float, surf_thresh: float):
    """The four clipped (W²,) panels in the JAX figure's axis order: GT f,
    predicted f, GT |∇f|, predicted |∇f|.  The GT transforms run in float32,
    as the JAX package's do."""
    d64 = np.asarray(gt_distances, np.float64)
    d = torch.as_tensor(d64, dtype=torch.float32)
    gt_f = gt_transform(gt_mode, d, alpha).numpy()
    if gt_mode == "siren":
        gt_gn = (d64 >= surf_thresh).astype(np.float64)
    else:
        gt_gn = gt_grad_norm(gt_mode, d, alpha).numpy()
    return [np.clip(a, None, 1.5) for a in (gt_f, pred["f"], gt_gn, pred["grad_norm"])]


def normal_map(normals: np.ndarray, width: int) -> np.ndarray:
    """(W, W, 3) uint8 normal map: z oriented positive, [-1, 1] → [0, 255]
    (``slices.py:120-124``)."""
    normals = np.array(normals, copy=True)
    normals[:, 2] *= np.sign(normals[:, 2] + 1e-30)
    grad_map = (normals + 1.0) / 2.0
    return (grad_map.reshape(width, width, 3) * 255).astype(np.uint8)


def render_slice_figure(pred: dict, gt_distances, gt_mode: str, alpha: float, width: int,
                        output_dir: str, surf_thresh: float = 1e-3):
    """Write distance_fields.png + pred_grad.png into ``output_dir``;
    -> (the (2W, 2W, 3) mosaic, the (W, W, 3) normal map), uint8.

    ``gt_distances``: raw Euclidean GT distances on the plane (W²,); the GT
    transform closed forms are applied here (``generate_df.py:111-122``)."""
    panels = figure_panels(pred, gt_distances, gt_mode, alpha, surf_thresh)
    tiles = [panel_colors(p, width, surf_thresh, bands=i < 2) for i, p in enumerate(panels)]
    mosaic = np.concatenate([np.concatenate(tiles[:2], axis=1),
                             np.concatenate(tiles[2:], axis=1)], axis=0)
    fields = (mosaic * 255).astype(np.uint8)  # matplotlib's bytes=True conversion
    grad = normal_map(pred["normals"], width)
    os.makedirs(output_dir, exist_ok=True)
    write_png(os.path.join(output_dir, "distance_fields.png"), fields)
    write_png(os.path.join(output_dir, "pred_grad.png"), grad)
    return fields, grad
