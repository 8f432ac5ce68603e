"""Ground-truth distance oracles: the torch copy of
``diffudf_tpu/data/mesh_distance.py``.

Training's oracles.  Point-cloud input: the one-time build is host numpy +
scipy ``cKDTree`` (for each cell of a g³ lattice over the query domain, the
k cloud points nearest the cell center) and the per-step oracle,
:func:`point_cloud_distance_cells`, is a torch gather of one (k, 3) row per
query and a min over it.  Mesh input: :func:`build_candidate_grid`, the
same host build over triangles (the k best bounding-sphere lower bounds a
cell), is materialised once on the device as per-cell triangle coordinates
(:func:`build_triangle_table`), and the per-step oracle,
:func:`point_triangle_distance_table`, gathers one (k·9)-float row per query
and runs the exact closest-point test on it.  Until that build lands, the
bootstrap oracles are exact: the brute sweep :func:`point_triangle_distance`
over query tiles and triangle slabs (mesh), and :func:`point_cloud_distance`
(point cloud).

The figures' oracles: :func:`point_cloud_distance`, the exact nearest-point
distance, which on a CUDA device is one launch of the kernel K5
(:mod:`..ops.min_distance`; the JAX package keeps its Pallas twin off this
function only for a TPU compiler limit); :func:`point_triangle_distance`;
and :func:`point_triangle_distance_pruned`, which tests only the k triangles
of best lower bound from a float32 centroid product.  The sign of a mesh:
:func:`winding_number` and :func:`signed_mesh_distance`, brute sweeps over
query tiles as in the JAX package.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

CAND_GRID_G = 48  # lattice resolution of the candidate grid
CAND_GRID_K = 96  # candidate triangles per cell
CAND_GRID_LO = -1.08  # covers [-1,1]³ plus the near-sample fringe
CAND_GRID_HI = 1.08
CAND_PTS_K = 64  # candidate cloud points per cell


def _cell_centers(g: int, lo: float, hi: float):
    """(g³, 3) f32 numpy lattice of cell centers over [lo, hi]³."""
    cell = (hi - lo) / g
    ax = lo + (np.arange(g, dtype=np.float32) + 0.5) * cell
    cx, cy, cz = np.meshgrid(ax, ax, ax, indexing="ij")
    return np.stack([cx, cy, cz], axis=-1).reshape(-1, 3)


def _cell_rows(queries, g: int, lo: float, hi: float):
    """(Q,) linear index of each query's cell, clipped into the lattice."""
    cell = (hi - lo) / g
    ci = torch.clamp(torch.floor((queries - lo) / cell).to(torch.int64), 0, g - 1)
    return (ci[:, 0] * g + ci[:, 1]) * g + ci[:, 2]


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
    pts = table[_cell_rows(queries, g, lo, hi)]  # (Q, k, 3) contiguous row gather
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


def point_triangle_distance(queries: torch.Tensor, tri_verts: torch.Tensor, tile: int = 256,
                            slab: int | None = None):
    """Exact unsigned distance to a triangle soup: queries (Q, 3), tri_verts
    (T, 3, 3) -> (Q,), on the queries' device.

    ``tile`` queries at a time against ``slab`` triangles at a time (all of
    them by default) with a running min, so the (tile, slab) temporaries of
    the closest-point test stay the same size at any T.  The min is exact:
    the result does not depend on the tiling."""
    slab = slab or max(len(tri_verts), 1)
    slabs = [(t[:, 0][None], t[:, 1][None], t[:, 2][None]) for t in torch.split(tri_verts, slab)]
    out = []
    for q in torch.split(queries, tile):
        best = None
        for a, b, c in slabs:
            d2 = _closest_point_sq_dist(q[:, None, :], a, b, c).min(1).values
            best = d2 if best is None else torch.minimum(best, d2)
        out.append(torch.sqrt(torch.clamp(best, min=0.0)))
    return torch.cat(out) if out else queries.new_zeros(0)


def winding_number(queries: torch.Tensor, tri_verts: torch.Tensor, tile: int = 256):
    """Generalised winding number of each query with respect to the mesh,
    queries (Q, 3), tri_verts (T, 3, 3) -> (Q,) on the queries' device:
    about 1 inside and 0 outside a watertight mesh.  The solid angle of
    each triangle (van Oosterom-Strackee), summed over every triangle,
    ``tile`` queries at a time."""
    a, b, c = (tri_verts[:, k][None] for k in range(3))
    out = []
    for q in torch.split(queries, tile):
        pa, pb, pc = a - q[:, None, :], b - q[:, None, :], c - q[:, None, :]
        la, lb, lc = (torch.linalg.norm(p, dim=-1) for p in (pa, pb, pc))
        num = torch.sum(pa * torch.linalg.cross(pb, pc, dim=-1), dim=-1)
        den = (la * lb * lc + torch.sum(pa * pb, dim=-1) * lc
               + torch.sum(pb * pc, dim=-1) * la + torch.sum(pc * pa, dim=-1) * lb)
        out.append(torch.sum(2.0 * torch.atan2(num, den), dim=1) / (4.0 * math.pi))
    return torch.cat(out) if out else queries.new_zeros(0)


def signed_mesh_distance(queries: torch.Tensor, tri_verts: torch.Tensor, tile: int = 256):
    """Signed distance to the mesh: :func:`point_triangle_distance`,
    negative where :func:`winding_number` > 0.5 (inside), positive
    outside; Open3D's ``compute_signed_distance`` (``src/dataset.py:35``)."""
    d = point_triangle_distance(queries, tri_verts, tile)
    return torch.where(winding_number(queries, tri_verts, tile) > 0.5, -d, d)


# The bootstrap sweep of mesh-mode training (before the candidate grid
# lands): BOOT_PAIRS (query, triangle) pairs at a time, BOOT_SLAB triangles
# a slab.  The closest-point test holds about 170 bytes a pair of
# temporaries, so a (1024, 4096) block stays under 0.75 GB at any T.
BOOT_SLAB = 4096
BOOT_PAIRS = 1 << 22


def point_triangle_distance_bootstrap(queries: torch.Tensor, tri_verts: torch.Tensor):
    """:func:`point_triangle_distance` in (BOOT_PAIRS / BOOT_SLAB, BOOT_SLAB)
    blocks: the exact oracle of mesh-mode training until the table lands."""
    return point_triangle_distance(queries, tri_verts, tile=BOOT_PAIRS // BOOT_SLAB,
                                   slab=BOOT_SLAB)


def triangle_bounds(tri_verts: torch.Tensor):
    """(T, 3, 3) -> (centroids (T, 3), radii (T,)) bounding spheres."""
    c = tri_verts.mean(dim=1)
    r = torch.sqrt(torch.max(torch.sum((tri_verts - c[:, None, :]) ** 2, dim=-1), dim=1).values)
    return c, r


@contextlib.contextmanager
def _float32_matmul():
    """Products in float32 (no TF32 rounding of their inputs) for the body
    of the ``with``: TF32 ranks candidates about as coarsely as the TPU's
    bf16 passes did (``diffudf_tpu/data/mesh_distance.py:32-48``)."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def point_triangle_distance_pruned(queries: torch.Tensor, tri_verts: torch.Tensor,
                                   centroids: torch.Tensor | None = None,
                                   radii: torch.Tensor | None = None,
                                   k: int = 64, tile: int = 1024):
    """Unsigned distance to a triangle soup via candidate pruning:

      1. a float32 product gives each query its distance to every triangle
         *centroid*; ``max(d_centroid − r_tri, 0)`` lower-bounds the true
         triangle distance;
      2. ``torch.topk`` keeps the ``k`` smallest lower bounds per query;
      3. the exact closest-point test runs only on those k candidates.

    Exact whenever the true nearest triangle is among the k best lower
    bounds, which k = 64 gives by a wide margin on preprocessed meshes.
    ``tile`` queries at a time; soups of at most k triangles take the brute
    sweep."""
    if tri_verts.shape[0] <= k:
        return point_triangle_distance(queries, tri_verts)
    if centroids is None or radii is None:
        centroids, radii = triangle_bounds(tri_verts)
    c_sq = torch.sum(centroids * centroids, dim=1)
    out = []
    with _float32_matmul():
        for q in torch.split(queries, tile):
            cross = q @ centroids.T  # (Tq, T)
            d2c = torch.clamp(c_sq[None, :] - 2.0 * cross + torch.sum(q * q, dim=1)[:, None],
                              min=0.0)
            lb = torch.sqrt(d2c) - radii[None, :]
            idx = torch.topk(-lb, k, dim=1).indices  # (Tq, k) smallest lower bounds
            cand = tri_verts[idx]  # (Tq, k, 3, 3)
            d2 = _closest_point_sq_dist(q[:, None, :], cand[:, :, 0], cand[:, :, 1], cand[:, :, 2])
            out.append(torch.sqrt(torch.clamp(d2.min(1).values, min=0.0)))
    return torch.cat(out) if out else queries.new_zeros(0)


# Triangles ranked in the top CAND_BIG_MAX by bounding radius are tested
# densely against every cell: the kNN-over-centroids shortcut is only safe
# when radii are bounded, and the few largest outliers (a ground plane, a
# coarse hull face) are exactly the ones a nearest-centroid query misses.
CAND_BIG_MAX = 512


def build_candidate_grid(tri_verts, centroids=None, radii=None, g: int = CAND_GRID_G,
                         k: int = CAND_GRID_K, lo: float = CAND_GRID_LO,
                         hi: float = CAND_GRID_HI) -> np.ndarray:
    """One-time candidate index: the k best-lower-bound triangles per cell
    of a g³ lattice over the query domain, (g³, k) int32 numpy, the JAX
    function's indices.  Host numpy and scipy only: no device traffic, so
    the background build thread of :mod:`.async_build` may run it.

    Candidate selection is the exact top-k by the bounding-sphere lower
    bound ``dist(cell_center, centroid) − radius`` over ALL triangles, the
    criterion of :func:`point_triangle_distance_pruned`.  The
    ``CAND_BIG_MAX`` largest-radius triangles are scored densely against
    every cell (a huge triangle's centroid can be far from cells its surface
    passes through); the other triangles go through a centroid kNN whose
    width escalates per cell until the kq-th neighbour distance exceeds
    ``τ_k + max(small radii)``: every unqueried triangle's lower bound is
    then ≥ the selected k-th, so the exclusion is exact.  Meshes of fewer
    than k triangles repeat candidates up to k (harmless under the min)."""
    from scipy.spatial import cKDTree

    if centroids is None or radii is None:
        tv = np.asarray(tri_verts, np.float32)
        cen = tv.mean(axis=1)
        rad = np.sqrt(np.max(np.sum((tv - cen[:, None, :]) ** 2, axis=-1), axis=1))
    else:
        cen = np.asarray(centroids, np.float32)
        rad = np.asarray(radii, np.float32)
    t = len(cen)
    k_out = k
    k = min(k, t)

    centers = _cell_centers(g, lo, hi)
    n_cells = len(centers)

    # split: largest-radius triangles scored densely, the rest via kNN
    nb = min(t, CAND_BIG_MAX)
    big = np.argpartition(rad, t - nb)[t - nb:] if nb < t else np.arange(t)
    small_mask = np.ones(t, bool)
    small_mask[big] = False
    small = np.flatnonzero(small_mask)
    ts = len(small)
    rad_small_max = np.float32(rad[small].max()) if ts else np.float32(0.0)
    cen_big, rad_big = cen[big], rad[big]
    cen_big_sq = np.sum(cen_big * cen_big, axis=1)

    tree = cKDTree(cen[small]) if ts else None
    kq0 = min(max(2 * k, k + 32), ts) if ts else 0

    cand = np.empty((n_cells, k), np.int64)
    chunk = 16384
    for s in range(0, n_cells, chunk):
        pts = centers[s:s + chunk]
        m = len(pts)
        # dense lower bounds vs the big set (m × nb product: trivial)
        d2 = (np.sum(pts * pts, axis=1)[:, None] - 2.0 * (pts @ cen_big.T)
              + cen_big_sq[None, :])
        lb_big = np.sqrt(np.maximum(d2, 0.0)).astype(np.float32) - rad_big

        rows = np.arange(m)
        kq = kq0
        while True:
            if ts and kq >= 4096 and kq < ts:
                # escalation blew past the kNN sweet spot: score the
                # remaining rows densely against all small triangles (row
                # count here is tiny: the pathological fringe)
                d2s = (np.sum(pts[rows] * pts[rows], axis=1)[:, None]
                       - 2.0 * (pts[rows] @ cen[small].T)
                       + np.sum(cen[small] * cen[small], axis=1)[None, :])
                lb_s = np.sqrt(np.maximum(d2s, 0.0)).astype(np.float32) - rad[small]
                lb_all = np.concatenate([lb_s, lb_big[rows]], axis=1)
                ids_all = np.concatenate([np.broadcast_to(small, lb_s.shape),
                                          np.broadcast_to(big, (len(rows), nb))], axis=1)
                part = np.argpartition(lb_all, k - 1, axis=1)[:, :k]
                cand[s + rows] = np.take_along_axis(ids_all, part, axis=1)
                break
            if ts and kq:
                d, idx = tree.query(pts[rows], k=kq, workers=-1)
                if kq == 1:
                    d, idx = d[:, None], idx[:, None]
                lb_s = (d - rad[small[idx]]).astype(np.float32)
                lb_all = np.concatenate([lb_s, lb_big[rows]], axis=1)
                ids_all = np.concatenate([small[idx], np.broadcast_to(big, (len(rows), nb))],
                                         axis=1)
            else:
                lb_all = lb_big[rows]
                ids_all = np.broadcast_to(big, (len(rows), nb))
            if lb_all.shape[1] > k:
                part = np.argpartition(lb_all, k - 1, axis=1)[:, :k]
                sel = np.take_along_axis(ids_all, part, axis=1)
                tau = np.take_along_axis(lb_all, part, axis=1).max(axis=1)
            else:
                sel = np.array(ids_all)
                tau = lb_all.max(axis=1)
            cand[s + rows] = sel
            if not ts or kq >= ts:
                break
            # exclusion is exact when every unqueried small triangle's lower
            # bound (≥ d_kq − rad_small_max) is ≥ the selected k-th
            unsafe = d[:, -1] < tau + rad_small_max
            if not unsafe.any():
                break
            rows = rows[unsafe]
            kq = min(max(kq * 2, 256), ts)

    if cand.shape[1] < k_out:
        reps = -(-k_out // cand.shape[1])
        cand = np.tile(cand, (1, reps))[:, :k_out]
    return cand.astype(np.int32)


def build_triangle_table(tri_verts: torch.Tensor, cand) -> torch.Tensor:
    """The candidate grid as per-cell vertex *coordinates*: (T, 3, 3)
    triangles + (g³, k) candidate indices -> (g³, k·9) float32 rows on the
    triangles' device, by one gather there (382 MB at g = 48, k = 96).  The
    per-step oracle then reads one contiguous row a query instead of k
    scattered triangles."""
    cand = torch.as_tensor(cand, device=tri_verts.device).to(torch.int64)
    g3, k = cand.shape
    return tri_verts.reshape(-1, 9)[cand.reshape(-1)].reshape(g3, k * 9)


def point_triangle_distance_table(queries: torch.Tensor, table: torch.Tensor,
                                  g: int = CAND_GRID_G, lo: float = CAND_GRID_LO,
                                  hi: float = CAND_GRID_HI, tile: int = 32768):
    """Exact-on-candidates unsigned mesh distance via the coordinate table:
    queries (Q, 3), table (g³, k·9) from :func:`build_triangle_table` ->
    (Q,).  Near-exact: the true nearest triangle is among a cell's k
    candidates (:func:`build_candidate_grid`) whenever the k-th lower bound
    from the cell center exceeds the true distance by the cell
    half-diagonal.  ``tile`` queries at a time (a training batch is one
    tile)."""
    k = table.shape[1] // 9
    out = []
    for q in torch.split(queries, tile):
        tv = table[_cell_rows(q, g, lo, hi)].reshape(-1, k, 9)  # contiguous row gather
        d2 = _closest_point_sq_dist(q[:, None, :], tv[:, :, 0:3], tv[:, :, 3:6], tv[:, :, 6:9])
        out.append(torch.sqrt(torch.clamp(d2.min(1).values, min=0.0)))
    return torch.cat(out) if out else queries.new_zeros(0)


def triangles_from_mesh(vertices, faces, device="cuda") -> torch.Tensor:
    """(V, 3), (F, 3) host arrays -> (F, 3, 3) float32 tensor on ``device``."""
    tv = np.asarray(vertices, dtype=np.float32)[np.asarray(faces)]
    return torch.as_tensor(tv, device=device)
