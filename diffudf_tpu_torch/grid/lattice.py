"""N³ lattice evaluation → pseudo-UDF + direction field: the torch
counterpart of ``diffudf_tpu/grid/lattice.py``.

  * ``udf``  — inverse-mapped pseudo Euclidean distance |g⁻¹(|f|)|,
  * ``dirs`` — unit direction field: −∇f/|∇f| where the gradient is
    informative, else the Hessian top eigenvector sign-aligned with −∇f.

Grid layout: ``udf[i, j, k]`` at coordinate (x_i, y_j, z_k), x slowest / z
fastest, over [-1, 1]³ with spacing 2/(N−1).  As in the JAX package, the
|∇f| < 0.04 Hessian fallback is tested on the raw gradient norm, before
normalisation (the reference's slice renderer's behaviour, not its mesh
extractor's).

``group`` (:mod:`..parallel.mesh`, the JAX ``mesh``): every field
evaluation is split over the ranks (``evaluate_field(group=)``), each rank
gets the gathered values, and the host band logic runs on every rank on
the same arrays.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..autodiff.eigh3 import top_eigenvector
from ..extract.cap import CAP_THRESHOLD
from ..fields.siren import SirenSpec
from ..fields.transforms import inverse_map
from ..ops.evaluate import evaluate_field

GRAD_NORM_THRESHOLD = 0.04

_CORNERS = [(di, dj, dk) for di in (0, 1) for dj in (0, 1) for dk in (0, 1)]


def _device(params) -> torch.device:
    return params[0]["w"].device


def lattice_points(N: int, origin: float = -1.0, extent: float = 2.0,
                   device="cuda") -> torch.Tensor:
    """(N³, 3) lattice, x slowest / z fastest, float32, built on ``device``."""
    axis = origin + extent / (N - 1) * torch.arange(N, dtype=torch.float32, device=device)
    x, y, z = torch.meshgrid(axis, axis, axis, indexing="ij")
    return torch.stack([x.reshape(-1), y.reshape(-1), z.reshape(-1)], dim=-1)


def _decode_points(idx: torch.Tensor, N: int) -> torch.Tensor:
    """Flat lattice indices -> (M, 3) coordinates, the same float32 values
    as :func:`lattice_points` gives at those indices."""
    h = 2.0 / (N - 1)
    ijk = torch.stack([idx // (N * N), (idx // N) % N, idx % N], dim=-1)
    return -1.0 + h * ijk.to(torch.float32)


def direction_field(grad, hess, threshold: float = GRAD_NORM_THRESHOLD):
    """Unit directions toward the surface from (∇f, H): (Q,3),(Q,3,3)->(Q,3)."""
    gnorm = torch.linalg.norm(grad, dim=-1, keepdim=True)
    ndir = -grad / torch.clamp(gnorm, min=1e-12)
    hnormal = top_eigenvector(hess)
    # sign-align the eigenvector with the inward gradient direction
    sign = torch.where(torch.sum(ndir * hnormal, dim=-1, keepdim=True) < 0, -1.0, 1.0)
    return torch.where(gnorm < threshold, sign * hnormal, ndir)


def extract_fields(params, spec: SirenSpec, N: int, gt_mode: str, alpha: float,
                   *, tile: int = 8192, use_pallas=None, group=None):
    """-> (udf (N, N, N), dirs (N, N, N, 3)) float32 tensors on the params'
    device: the dense fused pass over all N³ points."""
    pts = lattice_points(N, device=_device(params))
    ev = evaluate_field(params, spec, pts, want_grad=True, want_hess=True, tile=tile,
                        use_pallas=use_pallas, group=group)
    udf = inverse_map(gt_mode, torch.abs(ev.f), alpha)
    dirs = direction_field(ev.grad, ev.hess)
    return udf.reshape(N, N, N), dirs.reshape(N, N, N, 3)


def extract_fields_sparse(
    params,
    spec: SirenSpec,
    N: int,
    gt_mode: str,
    alpha: float,
    *,
    tile: int = 8192,
    band_voxels: float = 4.0,
    dirs_band_voxels: float = 3.5,
    coarse_stride: int | None = None,
    safety: float = 1.5,
    use_pallas=None,
    cap_threshold: float = CAP_THRESHOLD,
    stats: dict | None = None,
    group=None,
):
    """Hierarchical (coarse → band-refined) field extraction → host numpy.

    Same contract as :func:`extract_fields` but returns numpy arrays and runs
    the fused (f, ∇f, H) pass only inside a thin band around the surface;
    vertices farther out get a constant background above every gate
    threshold of the mesh extractors.  Stages:

      1. value-only pass on the stride-``s`` sub-lattice, giving a coarse
         pseudo-UDF;
      2. blocks of s³ cells whose min corner exceeds ``band + margin`` are
         surface-free and skipped (``margin = safety·(s·h·√3/2) + 2h``
         absorbs the block half-diagonal and fit noise); value-only pass on
         the remaining fine vertices;
      3. fused (f, ∇f, H) + direction-field pass only where the exact value
         sits within ``dirs_band_voxels`` (the kernel's share of the work).

    The index lists are built on the host from the host's float32 copy of
    the values, compared against float32 thresholds, and uploaded, so the
    device evaluates exactly the vertices the host scatters back.

    ``stats``: when given a dict, it receives the seconds of each stage
    (each ends in a device-to-host copy, so the device work is inside) and
    the band sizes.
    """
    dev = _device(params)
    h = 2.0 / (N - 1)
    s = coarse_stride
    if s is None:
        for cand in (6, 5, 4, 7, 3, 8, 2):
            if (N - 1) % cand == 0 and (N - 1) // cand >= 8:
                s = cand
                break
    if stats is None:
        stats = {}
    if not s or s == 1:
        udf, dirs = extract_fields(params, spec, N, gt_mode, alpha, tile=tile,
                                   use_pallas=use_pallas, group=group)
        return udf.cpu().numpy(), dirs.cpu().numpy()

    t0 = time.perf_counter()
    Nc = (N - 1) // s + 1
    # stage 1: coarse sub-lattice values (coincides with the fine lattice)
    evc = evaluate_field(params, spec, lattice_points(Nc, device=dev), tile=tile, group=group)
    ud_c = inverse_map(gt_mode, torch.abs(evc.f), alpha).cpu().numpy().reshape(Nc, Nc, Nc)

    # CAP's cell gate is absolute (min corner < threshold) and its vote
    # signing reads corner dirs out to ``threshold + 2.0·h``; the bands
    # widen to cover it at fine grids.
    dirs_band = max(dirs_band_voxels * h, cap_threshold + 2.0 * h)
    band = max(band_voxels * h, dirs_band + 0.5 * h)
    margin = safety * (s * h * np.sqrt(3.0) / 2.0) + 2.0 * h
    # float32 thresholds, compared against the float32 values on the host
    band_thresh = np.float32(band + margin)
    dirs_thresh = np.float32(dirs_band)
    background = band_thresh

    cmin = ud_c[:-1, :-1, :-1].copy()
    for di, dj, dk in _CORNERS[1:]:
        np.minimum(cmin, ud_c[di : di + Nc - 1, dj : dj + Nc - 1, dk : dk + Nc - 1],
                   out=cmin)
    active = cmin <= band_thresh  # (Nc-1)³ surface-possible blocks
    stats["stage1_s"] = time.perf_counter() - t0
    stats["coarse_points"] = Nc ** 3
    stats["active_block_share"] = float(active.mean())
    if not active.any():
        # no surface found at coarse scale — degenerate field; stay exact
        udf, dirs = extract_fields(params, spec, N, gt_mode, alpha, tile=tile,
                                   use_pallas=use_pallas, group=group)
        return udf.cpu().numpy(), dirs.cpu().numpy()

    # stage 2: exact values at every vertex of an active block
    t0 = time.perf_counter()
    cell_active = active.repeat(s, 0).repeat(s, 1).repeat(s, 2)  # (N-1)³
    vmask = np.zeros((N, N, N), bool)
    for di, dj, dk in _CORNERS:
        vmask[di : di + N - 1, dj : dj + N - 1, dk : dk + N - 1] |= cell_active
    idx = np.flatnonzero(vmask.ravel())
    idx_dev = torch.as_tensor(idx, device=dev)
    ev = evaluate_field(params, spec, _decode_points(idx_dev, N), tile=tile, group=group)
    ud_v = inverse_map(gt_mode, torch.abs(ev.f), alpha).cpu().numpy()
    stats["stage2_s"] = time.perf_counter() - t0
    stats["band_points"] = int(idx.size)

    # stage 3: directions only where the exact value needs them
    t0 = time.perf_counter()
    sel = ud_v <= dirs_thresh
    dirs_flat = np.zeros((N * N * N, 3), np.float32)
    idx2 = idx[sel]
    if idx2.size:
        ev2 = evaluate_field(
            params, spec, _decode_points(idx_dev[torch.as_tensor(sel, device=dev)], N),
            want_grad=True, want_hess=True, tile=tile, use_pallas=use_pallas, group=group,
        )
        dirs_flat[idx2] = direction_field(ev2.grad, ev2.hess).cpu().numpy()
    stats["stage3_s"] = time.perf_counter() - t0
    stats["dirs_points"] = int(idx2.size)

    udf_flat = np.full(N * N * N, background, np.float32)
    udf_flat[idx] = ud_v
    return udf_flat.reshape(N, N, N), dirs_flat.reshape(N, N, N, 3)


def extract_sdf_grid(params, spec: SirenSpec, N: int, *, tile: int = 8192, group=None):
    """Raw field values on the lattice (signed-MC baseline path)."""
    ev = evaluate_field(params, spec, lattice_points(N, device=_device(params)), tile=tile,
                        group=group)
    return ev.f.reshape(N, N, N)
