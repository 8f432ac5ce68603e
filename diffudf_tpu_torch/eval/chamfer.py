"""Chamfer distance and normal consistency: the torch counterpart of
``diffudf_tpu/eval/chamfer.py``.

pytorch3d ``chamfer_distance`` semantics (those of the reference's benchmark
script, ``cuantitative.py:10-19``):

  * per-point distance under ``norm``: Σ|Δ| (norm=1) or Σ Δ² (norm=2, the
    *squared* Euclidean distance, no root); nearest neighbours are found
    under the same norm;
  * chamfer = mean_x d(x→NN(y)) + mean_y d(y→NN(x)) (the sum of both
    directional means);
  * normal consistency loss = mean_x (1 − |cos(n_x, n_NN)|) + mean_y (…)
    (``abs_cosine=True``).

Two backends.  ``device``: a running (min, argmin) over chunks of the
reference cloud in torch, queries in tiles, so the Q×M distance matrix never
materialises; the L2 path takes |x|² − 2x·y + |y|² with a float32 matmul
(TF32 off: it would round the inputs).  ``host``: an exact scipy k-d tree
under the same Minkowski norm.  Plain torch, not a kernel: the JAX package
computes this with XLA, not Pallas.
"""

from __future__ import annotations

import numpy as np
import torch


def _nn_chunked(x: torch.Tensor, y: torch.Tensor, norm: int, y_chunk: int, x_tile: int):
    """x: (Q, 3), y: (M, 3) -> (dists (Q,), idx (Q,)) on x's device."""
    dists, idxs = [], []
    y_sq = (y * y).sum(1)
    for xt in torch.split(x, x_tile):
        best_d = torch.full((xt.shape[0],), float("inf"), dtype=x.dtype, device=x.device)
        best_i = torch.zeros(xt.shape[0], dtype=torch.int64, device=x.device)
        x_sq = (xt * xt).sum(1, keepdim=True)
        for lo in range(0, y.shape[0], y_chunk):
            yc = y[lo:lo + y_chunk]
            if norm == 2:
                d = x_sq - 2.0 * (xt @ yc.T) + y_sq[None, lo:lo + y_chunk]
            else:
                d = (xt[:, None, :] - yc[None, :, :]).abs().sum(-1)
            local_d, local_i = d.min(1)
            better = local_d < best_d
            best_d = torch.where(better, local_d, best_d)
            best_i = torch.where(better, local_i + lo, best_i)
        dists.append(torch.clamp(best_d, min=0.0))
        idxs.append(best_i)
    return torch.cat(dists), torch.cat(idxs)


def nearest_neighbor(x, y, norm: int = 2, y_chunk: int = 4096, x_tile: int = 8192,
                     device=None):
    """-> (distances (Q,) under ``norm``, indices (Q,) into y), tensors on
    ``device`` (default: x's device if x is a tensor, else cuda)."""
    if device is None:
        device = x.device if isinstance(x, torch.Tensor) else "cuda"
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    y = torch.as_tensor(y, dtype=torch.float32, device=device)
    with torch.no_grad():
        return _nn_chunked(x, y, norm, y_chunk, x_tile)


def _host_kdtree_ok() -> bool:
    try:
        from scipy.spatial import cKDTree  # noqa: F401
    except Exception:  # pragma: no cover - scipy is a dependency
        return False
    return True


def _nn_host(x, y, norm: int):
    """Exact NN through a host k-d tree (Minkowski p = norm, so the
    neighbour set matches the device scan); L2 distances are squared."""
    from scipy.spatial import cKDTree

    d, i = cKDTree(y).query(x, p=norm, workers=-1)
    if norm == 2:
        d = d * d
    return np.asarray(d, np.float32), i


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float32)


def _nc_dir(an, bn, idx):
    """mean(1 − |cos|) of each normal of ``an`` with its neighbour's in ``bn``."""
    bsel = bn[idx]
    cos = (an * bsel).sum(1) / torch.clamp(
        torch.linalg.norm(an, dim=1) * torch.linalg.norm(bsel, dim=1), min=1e-12)
    return (1.0 - cos.abs()).mean()


def _nc_dir_host(an, bn, idx):
    """:func:`_nc_dir` in numpy, the mean taken in float64."""
    bsel = bn[idx]
    cos = np.sum(an * bsel, axis=1) / np.maximum(
        np.linalg.norm(an, axis=1) * np.linalg.norm(bsel, axis=1), 1e-12)
    return np.mean(1.0 - np.abs(cos), dtype=np.float64)


def chamfer_distance(x, y, x_normals=None, y_normals=None, norm: int = 2,
                     backend: str = "auto", device=None):
    """-> (chamfer, normal_consistency_loss or None), Python floats.

    backend: ``device`` = the chunked torch scan on ``device`` (default:
    the inputs' device if they are tensors, else cuda); ``host`` = the
    exact scipy k-d tree (NN under the same Minkowski norm, the same result
    up to the order of ties); ``auto`` picks host for host arrays when scipy
    is there, device otherwise."""
    if backend == "auto":
        on_host = not (isinstance(x, torch.Tensor) or isinstance(y, torch.Tensor))
        backend = "host" if on_host and _host_kdtree_ok() else "device"
    if backend == "host":
        xh, yh = _host(x), _host(y)
        dx, ix = _nn_host(xh, yh, norm)
        dy, iy = _nn_host(yh, xh, norm)
        cd = float(np.mean(dx, dtype=np.float64) + np.mean(dy, dtype=np.float64))
        nc = None
        if x_normals is not None and y_normals is not None:
            xn, yn = _host(x_normals), _host(y_normals)
            nc = float(_nc_dir_host(xn, yn, ix) + _nc_dir_host(yn, xn, iy))
        return cd, nc
    if backend != "device":
        raise ValueError(f"backend must be 'auto', 'host' or 'device', got {backend!r}")

    if device is None:
        device = x.device if isinstance(x, torch.Tensor) else "cuda"
    dx, ix = nearest_neighbor(x, y, norm, device=device)
    dy, iy = nearest_neighbor(y, x, norm, device=device)
    cd = float(dx.mean() + dy.mean())
    nc = None
    if x_normals is not None and y_normals is not None:
        xn = torch.as_tensor(x_normals, dtype=torch.float32, device=device)
        yn = torch.as_tensor(y_normals, dtype=torch.float32, device=device)
        nc = float(_nc_dir(xn, yn, ix) + _nc_dir(yn, xn, iy))
    return cd, nc


def protocol_floor(mesh, n_samples: int = 100000, seeds=(1, 2), norm: int = 1):
    """-> (chamfer_floor, nc_floor): the metric's resolution limit on a
    shape: two independent surface samplings of the ground-truth mesh
    scored against each other under the benchmark protocol.  Nearest
    neighbours never coincide at finite density and nearby normals differ
    where the surface curves, so no reconstruction scores below it."""
    from ..data.sampling import sample_surface_points

    p1, n1 = sample_surface_points(mesh, n_samples, seed=seeds[0])
    p2, n2 = sample_surface_points(mesh, n_samples, seed=seeds[1])
    return chamfer_distance(p1, p2, n1, n2, norm=norm)
