"""Vectorised marching tetrahedra over a compact set of grid cells.

Alternative triangulation backend (``triangulator="tets"``); the default is
the table-driven MC in :mod:`.table_mc`.  Design rationale (vs. the
reference):

  * The reference triangulates with table-driven marching cubes — PyMCubes
    per 2×2×2 cell inside a Python triple loop for CAP
    (``src/render_mc.py:201-256``) and a Cython Lewiner-33 variant for
    MeshUDF (``_marching_cubes_lewiner_cy.pyx:1116+``).
  * Here each cell splits into 6 tetrahedra around the main diagonal; a
    tetrahedron's iso-surface is unambiguous (1 or 2 triangles), so no
    33-case topological tables or face/interior ambiguity tests are needed,
    and the whole thing is a fixed-shape gather — ideal for numpy/JAX
    vectorisation.  Vertices still land on linearly-interpolated zero
    crossings, so Chamfer quality matches table MC, but the tetrahedral
    split produces ~2-3× the triangle count with noisier triangle normals
    (measurably worse normal consistency) — which is why ``table_mc`` is
    the default backend.

Input is the *compact* active-cell set (host side picks cells with sign
changes), so memory stays O(surface), not O(N³).

Triangle orientation: each emitted triangle is flipped if needed so its
geometric normal points from the negative side to the positive side of the
signed field.
"""

from __future__ import annotations

import numpy as np

# cube corner offsets, index c in [0, 8): (x, y, z) = bits (c&1, c>>1&1, c>>2&1)
CORNER_OFFSETS = np.array(
    [[c & 1, (c >> 1) & 1, (c >> 2) & 1] for c in range(8)], dtype=np.float64
)

# 6-tetrahedra decomposition around the main diagonal corner0=(0,0,0) →
# corner7=(1,1,1). Every tet contains the diagonal; faces interior to the
# cube match up between neighbouring tets, and the decomposition is
# translation-consistent across cells because we use the same split in every
# cell (diagonal orientation fixed), so shared cube faces are split along the
# same face diagonal by construction.
TETS = np.array(
    [
        [0, 1, 3, 7],
        [0, 3, 2, 7],
        [0, 2, 6, 7],
        [0, 6, 4, 7],
        [0, 4, 5, 7],
        [0, 5, 1, 7],
    ],
    dtype=np.int64,
)

# tet edges: pairs of local tet-vertex indices
TET_EDGES = np.array(
    [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], dtype=np.int64
)

# triangulation LUT: case index = bit i set iff tet vertex i is negative.
# each case → up to 2 triangles of tet-edge indices (-1 padded).
# single-negative-vertex cases cut the 3 edges incident to that vertex;
# two-negative cases cut 4 edges forming a quad split into 2 triangles.
_T = -1
TET_TRI_TABLE = np.array(
    [
        # 0000: no crossing
        [[_T, _T, _T], [_T, _T, _T]],
        # 0001: v0 neg → edges (0-1),(0-2),(0-3) = 0,1,2
        [[0, 1, 2], [_T, _T, _T]],
        # 0010: v1 neg → edges (0-1),(1-2),(1-3) = 0,3,4
        [[0, 4, 3], [_T, _T, _T]],
        # 0011: v0,v1 neg → quad edges (0-2),(0-3),(1-2),(1-3) = 1,2,3,4
        [[1, 2, 4], [1, 4, 3]],
        # 0100: v2 neg → edges (0-2),(1-2),(2-3) = 1,3,5
        [[1, 3, 5], [_T, _T, _T]],
        # 0101: v0,v2 neg → quad edges (0-1),(0-3),(1-2),(2-3) = 0,2,3,5
        [[0, 2, 5], [0, 5, 3]],
        # 0110: v1,v2 neg → quad edges (0-1),(1-3),(0-2),(2-3) = 0,4,1,5
        [[0, 4, 5], [0, 5, 1]],
        # 0111: v3 pos → edges (0-3),(1-3),(2-3) = 2,4,5
        [[2, 4, 5], [_T, _T, _T]],
        # 1000: v3 neg → same edges as 0111
        [[2, 5, 4], [_T, _T, _T]],
        # 1001: v0,v3 neg → quad edges (0-1),(0-2),(1-3),(2-3) = 0,1,4,5
        [[0, 1, 5], [0, 5, 4]],
        # 1010: v1,v3 neg → quad edges (0-1),(1-2),(0-3),(2-3) = 0,3,2,5
        [[0, 3, 5], [0, 5, 2]],
        # 1011: v2 pos → edges (0-2),(1-2),(2-3) = 1,3,5
        [[1, 5, 3], [_T, _T, _T]],
        # 1100: v2,v3 neg → quad edges (0-2),(1-2),(0-3),(1-3) = 1,3,2,4
        [[1, 3, 4], [1, 4, 2]],
        # 1101: v1 pos → edges (0-1),(1-2),(1-3) = 0,3,4
        [[0, 3, 4], [_T, _T, _T]],
        # 1110: v0 pos → edges (0-1),(0-2),(0-3) = 0,1,2
        [[0, 2, 1], [_T, _T, _T]],
        # 1111: fully inside
        [[_T, _T, _T], [_T, _T, _T]],
    ],
    dtype=np.int64,
)


def marching_tets_cells(
    cell_origins: np.ndarray,
    cell_values: np.ndarray,
    spacing: float = 1.0,
):
    """Triangulate the zero level set inside a compact set of cells.

    cell_origins: (M, 3) lattice coordinates (integer grid units) of each
        cell's (0,0,0) corner.
    cell_values:  (M, 8) signed field values at the cell corners, corner
        order per ``CORNER_OFFSETS``.
    spacing: world-units per lattice step (verts returned in
        ``origin_units · spacing``).

    Returns (verts (V, 3) float64, faces (F, 3) int64); vertices are deduped
    on quantised edge keys so neighbouring cells share vertices exactly.
    """
    m = len(cell_origins)
    if m == 0:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)

    vals = cell_values[:, TETS]  # (M, 6, 4)
    corners = cell_origins[:, None, None, :] + CORNER_OFFSETS[TETS][None]  # (M,6,4,3)

    neg = vals < 0
    case = (
        neg[..., 0].astype(np.int64)
        + 2 * neg[..., 1]
        + 4 * neg[..., 2]
        + 8 * neg[..., 3]
    )  # (M, 6)

    tris = TET_TRI_TABLE[case]  # (M, 6, 2, 3) tet-edge ids
    valid = tris[..., 0] >= 0  # (M, 6, 2)
    mi, ti, ki = np.nonzero(valid)
    if len(mi) == 0:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    edge_ids = tris[mi, ti, ki]  # (F, 3)

    # interpolate crossing point on each referenced tet edge
    ea = TET_EDGES[edge_ids][..., 0]  # (F, 3) local tet-vertex a
    eb = TET_EDGES[edge_ids][..., 1]
    va = vals[mi[:, None], ti[:, None], ea]  # (F, 3)
    vb = vals[mi[:, None], ti[:, None], eb]
    pa = corners[mi[:, None], ti[:, None], ea]  # (F, 3, 3)
    pb = corners[mi[:, None], ti[:, None], eb]
    denom = va - vb
    t = np.where(np.abs(denom) > 1e-20, va / np.where(denom == 0, 1, denom), 0.5)
    t = np.clip(t, 0.0, 1.0)
    pts = pa + t[..., None] * (pb - pa)  # (F, 3, 3)

    # orientation: normal should point toward the positive side
    n = np.cross(pts[:, 1] - pts[:, 0], pts[:, 2] - pts[:, 0])
    # direction negative→positive: sum of (sign · corner) differences
    tet_vals = vals[mi, ti]  # (F, 4)
    tet_corners = corners[mi, ti]  # (F, 4, 3)
    w = np.sign(tet_vals)
    centroid_pos = (tet_corners * (w > 0)[..., None]).sum(1) / np.maximum(
        (w > 0).sum(1), 1
    )[:, None]
    centroid_neg = (tet_corners * (w < 0)[..., None]).sum(1) / np.maximum(
        (w < 0).sum(1), 1
    )[:, None]
    flip = np.sum(n * (centroid_pos - centroid_neg), axis=1) < 0
    pts[flip] = pts[flip][:, ::-1]

    # dedupe vertices via quantised keys (shared edges produce identical
    # coordinates up to fp noise; quantise at 1e-6 lattice units)
    flat = pts.reshape(-1, 3)
    keys = np.round(flat * 1e6).astype(np.int64)
    uniq, inverse = np.unique(keys, axis=0, return_inverse=True)
    # representative float coords: first occurrence of each key
    first = np.full(len(uniq), len(flat), dtype=np.int64)
    np.minimum.at(first, inverse, np.arange(len(flat)))
    verts = flat[first]
    faces = inverse.reshape(-1, 3)

    # drop degenerate faces (repeated vertices after dedupe)
    good = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    faces = faces[good]
    return verts * spacing, faces
