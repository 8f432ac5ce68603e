"""Ground-truth distance oracles: the point part and the brute triangle
sweep of ``diffudf_tpu/data/mesh_distance.py``.

Training's oracle: the one-time build is host numpy + scipy ``cKDTree``:
for each cell of a g³ lattice over the query domain, the k cloud points
nearest the cell center.  The per-step oracle,
:func:`point_cloud_distance_cells`, is a torch gather of one (k, 3) row per
query and a min over it, on the device of its inputs.

The slice figure's oracles: :func:`point_cloud_distance`, the exact
nearest-point distance, which on a CUDA device is one launch of the kernel
K5 (:mod:`..ops.min_distance`; the JAX package keeps its Pallas twin off
this function only for a TPU compiler limit), and
:func:`point_triangle_distance`, the exact distance to a triangle soup by a
brute sweep in torch.  The mesh-input training oracle (candidate grid,
triangle table, pruned sweep) is not ported yet.
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


def _min_sq_dist_tile(q, x_sq, x):
    """q: (Tq, 3), x: (N, 3), x_sq: (N,) -> (Tq,) min squared distance.

    Rank by |x|² − 2q·x in float32 (TF32 off), return the exact elementwise
    value for the winner: the JAX function's arithmetic."""
    idx = torch.argmin(x_sq[None, :] - 2.0 * (q @ x.T), dim=1)
    diff = q - x[idx]
    return torch.sum(diff * diff, dim=1)


def point_cloud_distance(queries: torch.Tensor, cloud: torch.Tensor, tile: int = 2048):
    """Exact min Euclidean distance from each query (Q, 3) to the cloud
    (N, 3) -> (Q,), on the queries' device.

    On a CUDA device: one launch of K5 (:func:`..ops.min_distance.
    min_distance`), which ranks and recomputes the same way.  On the CPU:
    ``tile`` queries at a time through :func:`_min_sq_dist_tile`."""
    if queries.device.type == "cuda":
        from ..ops.min_distance import min_distance

        return min_distance(queries.to(torch.float32).contiguous(),
                            cloud.to(queries.device, torch.float32).contiguous())
    x_sq = torch.sum(cloud * cloud, dim=1)
    d2 = [_min_sq_dist_tile(queries[lo:lo + tile], x_sq, cloud)
          for lo in range(0, queries.shape[0], tile)]
    d2 = torch.cat(d2) if d2 else queries.new_zeros(0)
    return torch.sqrt(torch.clamp(d2, min=0.0))


def _closest_point_sq_dist(p, a, b, c):
    """Squared distance from points p (Tq, 1, 3) to triangles (1, T, 3).

    Branchless closest-point-on-triangle (the Voronoi-region construction
    of Ericson, RTCD §5.1.5, folded into nested ``where``s), as the JAX
    function computes it.  Shapes broadcast: returns (Tq, T)."""
    ab = b - a
    ac = c - a
    ap = p - a

    d1 = torch.sum(ab * ap, dim=-1)
    d2 = torch.sum(ac * ap, dim=-1)
    d3 = torch.sum(ab * (p - b), dim=-1)
    d4 = torch.sum(ac * (p - b), dim=-1)
    d5 = torch.sum(ab * (p - c), dim=-1)
    d6 = torch.sum(ac * (p - c), dim=-1)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    denom = torch.clamp(va + vb + vc, min=1e-30)
    v = vb / denom
    w = vc / denom
    pt = a + v[..., None] * ab + w[..., None] * ac  # interior candidate

    t_ab = torch.clamp(d1 / torch.clamp(d1 - d3, min=1e-30), 0.0, 1.0)
    t_ac = torch.clamp(d2 / torch.clamp(d2 - d6, min=1e-30), 0.0, 1.0)
    t_bc = torch.clamp((d4 - d3) / torch.clamp((d4 - d3) + (d5 - d6), min=1e-30), 0.0, 1.0)
    p_ab = a + t_ab[..., None] * ab
    p_ac = a + t_ac[..., None] * ac
    p_bc = b + t_bc[..., None] * (c - b)

    in_vert_a = (d1 <= 0) & (d2 <= 0)
    in_vert_b = (d3 >= 0) & (d4 <= d3)
    in_vert_c = (d6 >= 0) & (d5 <= d6)
    in_edge_ab = ~in_vert_a & ~in_vert_b & (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    in_edge_ac = ~in_vert_a & ~in_vert_c & (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    in_edge_bc = ~in_vert_b & ~in_vert_c & (va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0)

    closest = pt
    for region, point in ((in_edge_ab, p_ab), (in_edge_ac, p_ac), (in_edge_bc, p_bc),
                          (in_vert_a, a), (in_vert_b, b), (in_vert_c, c)):
        closest = torch.where(region[..., None], point, closest)
    diff = p - closest
    return torch.sum(diff * diff, dim=-1)


def point_triangle_distance(queries: torch.Tensor, tri_verts: torch.Tensor, tile: int = 256):
    """Exact unsigned distance to a triangle soup: queries (Q, 3), tri_verts
    (T, 3, 3) -> (Q,), ``tile`` queries at a time, on the queries' device."""
    a = tri_verts[:, 0][None]
    b = tri_verts[:, 1][None]
    c = tri_verts[:, 2][None]
    out = [torch.sqrt(torch.clamp(_closest_point_sq_dist(q[:, None, :], a, b, c).min(1).values,
                                  min=0.0))
           for q in torch.split(queries, tile)]
    return torch.cat(out) if out else queries.new_zeros(0)


def triangles_from_mesh(vertices, faces, device="cuda") -> torch.Tensor:
    """(V, 3), (F, 3) host arrays -> (F, 3, 3) float32 tensor on ``device``."""
    tv = np.asarray(vertices, dtype=np.float32)[np.asarray(faces)]
    return torch.as_tensor(tv, device=device)
