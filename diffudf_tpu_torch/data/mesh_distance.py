"""Ground-truth distance oracle of point-cloud training: the point part of
``diffudf_tpu/data/mesh_distance.py``.

The one-time build is host numpy + scipy ``cKDTree``: for each cell of a
g³ lattice over the query domain, the k cloud points nearest the cell
center.  The per-step oracle, :func:`point_cloud_distance_cells`, is a
torch gather of one (k, 3) row per query and a min over it, on the device
of its inputs.  The brute ``point_cloud_distance`` (K5's path) and the
mesh-input oracle are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

CAND_GRID_G = 48  # lattice resolution of the candidate grid
CAND_GRID_LO = -1.08  # covers [-1,1]³ plus the near-sample fringe
CAND_GRID_HI = 1.08
CAND_PTS_K = 64  # candidate cloud points per cell


def _cell_centers(g: int, lo: float, hi: float):
    """(g³, 3) f32 numpy lattice of cell centers over [lo, hi]³."""
    cell = (hi - lo) / g
    ax = lo + (np.arange(g, dtype=np.float32) + 0.5) * cell
    cx, cy, cz = np.meshgrid(ax, ax, ax, indexing="ij")
    return np.stack([cx, cy, cz], axis=-1).reshape(-1, 3)


def build_point_candidate_indices(
    cloud,
    g: int = CAND_GRID_G,
    k: int = CAND_PTS_K,
    lo: float = CAND_GRID_LO,
    hi: float = CAND_GRID_HI,
) -> np.ndarray:
    """(g³, k) int32 numpy indices of the k cloud points nearest each cell
    center (cKDTree; tiny clouds tile up to k).  No device traffic."""
    from scipy.spatial import cKDTree

    pts = np.asarray(cloud, np.float32)
    n = len(pts)
    k_out = k
    k = min(k, n)
    centers = _cell_centers(g, lo, hi)
    _, idx = cKDTree(pts).query(centers, k=k, workers=-1)
    if k == 1:
        idx = idx[:, None]
    if idx.shape[1] < k_out:
        # tiny clouds: keep the (g³, k) shape by repeating (duplicates are
        # harmless under the min reduction)
        reps = -(-k_out // idx.shape[1])
        idx = np.tile(idx, (1, reps))[:, :k_out]
    return idx.astype(np.int32)


def build_point_candidate_grid(
    cloud,
    g: int = CAND_GRID_G,
    k: int = CAND_PTS_K,
    lo: float = CAND_GRID_LO,
    hi: float = CAND_GRID_HI,
    device="cuda",
) -> torch.Tensor:
    """One-time per-cell nearest-point table for the pc-mode training oracle:
    (g³, k, 3) float32 on ``device``, the candidate *coordinates*, so the
    per-step oracle is one contiguous row gather per query.

    Error bound: a query in a cell with center c and half-diagonal h
    returns at most d(q, NN) + 2h even when the true NN misses the list;
    exact on near-surface queries of a dense cloud."""
    pts = np.asarray(cloud, np.float32)
    idx = build_point_candidate_indices(pts, g, k, lo, hi)
    return torch.as_tensor(pts[idx], device=device)


def point_cloud_distance_cells(
    queries: torch.Tensor,
    table: torch.Tensor,
    g: int = CAND_GRID_G,
    lo: float = CAND_GRID_LO,
    hi: float = CAND_GRID_HI,
) -> torch.Tensor:
    """Exact-on-candidates nearest-point distance via the precomputed table.

    queries: (Q, 3); table: (g³, k, 3) from
    :func:`build_point_candidate_grid`.  -> (Q,) distances."""
    cell = (hi - lo) / g
    ci = torch.clamp(torch.floor((queries - lo) / cell).to(torch.int64), 0, g - 1)
    lin = (ci[:, 0] * g + ci[:, 1]) * g + ci[:, 2]
    pts = table[lin]  # (Q, k, 3) contiguous row gather
    diff = queries[:, None, :] - pts
    d2 = torch.min(torch.sum(diff * diff, dim=2), dim=1).values
    return torch.sqrt(torch.clamp(d2, min=0.0))
