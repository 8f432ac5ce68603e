"""CAP-UDF style mesh extraction, fully vectorised.

Reference semantics (``src/render_mc.py:201-256``): for every grid cell whose
minimum pseudo-UDF is below 0.008, flip the sign of corner values whose
direction vector opposes the cell-anchor direction (dot < 0), and triangulate
cells where the resulting signed field crosses zero.

The reference is a pure-Python (N−1)³ triple loop calling PyMCubes per cell —
its slowest component.  Here the per-cell sign logic runs as 8 shifted-array
operations over the whole grid at once, and the surviving (compact) cells are
triangulated in one vectorised marching-tetrahedra call.
"""

from __future__ import annotations

import numpy as np

from ..native import udf_mc as native
from .triangulate import DEFAULT_TRIANGULATOR, triangulate_cells

CAP_THRESHOLD = 0.008  # reference ``render_mc.py:205``


def _corner_views(a: np.ndarray):
    """8 (N-1)³ views of an N³ array, one per cell corner (tet_mc order)."""
    return [
        a[dx : a.shape[0] - 1 + dx, dy : a.shape[1] - 1 + dy, dz : a.shape[2] - 1 + dz]
        for (dx, dy, dz) in [
            (0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0),
            (0, 0, 1), (1, 0, 1), (0, 1, 1), (1, 1, 1),
        ]
    ]


_CORNERS = [
    (0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0),
    (0, 0, 1), (1, 0, 1), (0, 1, 1), (1, 1, 1),
]


def signed_cell_values(udf: np.ndarray, dirs: np.ndarray, threshold: float = CAP_THRESHOLD,
                       signs: np.ndarray | None = None):
    """-> (cell_origins (M, 3) int, cell_values (M, 8) signed) for active cells.

    A cell is active iff its minimum corner UDF is ≤ threshold (reference
    gate, ``render_mc.py:213``) — equivalently, iff it touches a vertex
    below the threshold.  Enumerating cells from those (few) vertices costs
    one contiguous compare over the grid plus O(8·V) index math, instead of
    eight strided (N−1)³ reductions (~4 s at N=256).

    ``signs``: optional (N,N,N) int8 grid of globally-consistent pseudo
    signs (0 = unassigned).  Cells whose 8 corners all carry a sign use
    ``sign·udf`` — neighbouring cells then agree on shared faces, unlike
    the reference's per-cell corner-0 anchor (``render_mc.py:225-228``)
    whose independent flips produce inconsistent normals (the main source
    of CAP's NC deficit).  Cells touching unassigned vertices fall back to
    the reference anchor rule."""
    udf = np.asarray(udf, dtype=np.float32)
    dirs = np.asarray(dirs, dtype=np.float32)
    n0, n1, n2 = udf.shape

    small = np.flatnonzero((udf <= threshold).ravel())
    if small.size == 0:
        return np.zeros((0, 3), np.int64), np.zeros((0, 8), np.float32)
    vi = small // (n1 * n2)
    vj = (small // n2) % n1
    vk = small % n2

    # cells having a below-threshold vertex as one of their 8 corners
    cand = []
    for dx, dy, dz in _CORNERS:
        ci, cj, ck = vi - dx, vj - dy, vk - dz
        ok = (
            (ci >= 0) & (cj >= 0) & (ck >= 0)
            & (ci < n0 - 1) & (cj < n1 - 1) & (ck < n2 - 1)
        )
        cand.append((ci[ok] * (n1 - 1) + cj[ok]) * (n2 - 1) + ck[ok])
    cells = np.unique(np.concatenate(cand))

    ii = cells // ((n1 - 1) * (n2 - 1))
    jj = (cells // (n2 - 1)) % (n1 - 1)
    kk = cells % (n2 - 1)
    idx = np.stack([ii, jj, kk], axis=1)

    base = (ii * n1 + jj) * n2 + kk
    offs = np.array([(dx * n1 + dy) * n2 + dz for dx, dy, dz in _CORNERS])
    corner_lin = base[:, None] + offs[None, :]  # (M, 8)
    u8 = udf.reshape(-1)[corner_lin]
    d8 = dirs.reshape(-1, 3)[corner_lin]  # (M, 8, 3)

    anchor = d8[:, 0, :]  # direction at corner (0,0,0), reference anchor
    flip = np.einsum("mc,mkc->mk", anchor, d8) < 0
    vals = np.where(flip, -u8, u8).astype(np.float32)

    if signs is not None:
        s8 = signs.reshape(-1)[corner_lin].astype(np.float32)  # (M, 8)
        ok = (s8 != 0).all(axis=1)
        vals = np.where(ok[:, None], u8 * s8, vals).astype(np.float32)

    # both signs present: fully-negative cells (vote-signed interior) hold
    # no zero crossing and would only bloat the triangulator's cell set
    crossing = (vals.min(axis=1) < 0) & (vals.max(axis=1) >= 0)
    return idx[crossing], vals[crossing]


def _vote_signs(udf: np.ndarray, dirs: np.ndarray, voxel: float,
                threshold: float):
    """Globally-consistent pseudo signs for the CAP band (0 = unassigned)
    from the native vote-BFS.  The vote gates widen with the CAP threshold
    so every CAP-active cell's corners get a voted sign (the MeshUDF
    defaults only cover ~1 voxel)."""
    thr_vox = threshold / voxel
    avg_thresh = max(1.05, thr_vox + 1.0)
    max_thresh = max(1.75, thr_vox + 2.0)
    signs, _ = native.vote_bfs(
        udf, dirs, voxel, avg_thresh=avg_thresh, max_thresh=max_thresh
    )
    return signs


def extract_mesh_cap(udf, dirs, N: int, threshold: float = CAP_THRESHOLD,
                     triangulator: str = DEFAULT_TRIANGULATOR,
                     signing: str = "vote"):
    """-> (verts (V, 3) in [-1, 1]³, faces (F, 3)).

    udf: (N, N, N) pseudo distance field; dirs: (N, N, N, 3) direction field
    (both from :func:`diffudf_tpu_torch.grid.lattice.extract_fields`).

    ``signing`` (documented deviation from the reference):
      * ``"vote"`` (default) — per-vertex signs from the same vote
        machinery MeshUDF extraction uses, so adjacent cells agree on
        shared corners; cells outside the vote band keep the reference
        anchor rule.  Fixes the per-cell anchor's inconsistent-normal
        seams (the source of CAP's NC deficit vs MU).
      * ``"anchor"`` — the reference's exact per-cell corner-0 anchor
        semantics (``render_mc.py:225-228``).
    """
    udf = np.asarray(udf)
    dirs = np.asarray(dirs)
    signs = None
    if signing == "vote":
        signs = _vote_signs(np.maximum(udf, 0.0).astype(np.float32),
                            dirs.astype(np.float32), 2.0 / (N - 1),
                            threshold)
    elif signing != "anchor":
        raise ValueError(f"Invalid signing {signing!r}; expected 'vote' or 'anchor'")
    origins, vals = signed_cell_values(udf, dirs, threshold, signs=signs)
    spacing = 2.0 / (N - 1)
    verts, faces = triangulate_cells(origins, vals, spacing, triangulator)
    verts = verts - 1.0  # lattice origin at [-1,-1,-1]
    return verts, faces
