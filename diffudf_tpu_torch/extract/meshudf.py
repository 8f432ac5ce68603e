"""MeshUDF-style extraction: global pseudo-sign assignment + triangulation.

Host-side numpy counterpart of ``diffudf_tpu/extract/meshudf.py``; the
reference's native Cython module (``_marching_cubes_lewiner_cy.pyx:
1116-1774``) interleaves three things: (1) gating cells near the surface,
(2) assigning a pseudo-*sign* to each grid vertex by BFS voting on gradient
agreement, (3) Lewiner-33 marching cubes.  Here the concerns are separated:

  1. gates are vectorised array ops (``gate_cells``);
  2. sign assignment runs in the native C++ module (``native/udf_mc``):
     either the reference's region-growing vote BFS (default), or a
     maximum-confidence spanning-tree propagation over robust edge
     relations that fuse UDF-value triangle-inequality constraints with the
     direction-projection test (see ``edge_relations``), followed by
     confidence-weighted majority relaxation;
  3. triangulation of the sign·udf field goes through the shared backend
     dispatch (:mod:`.triangulate`): table-driven MC with asymptotic-decider
     ambiguity resolution by default (the MC33 counterpart), marching
     tetrahedra as the alternative.

The native module is built at first use; a failed build raises instead of
falling back to another signing method.

Gate thresholds mirror the reference wrapper defaults
(``_marching_cubes_lewiner.py:80``, ``render_mc.py:130-134``):
avg(cell corner udf) < 1.05·voxel and max ≤ 1.75·voxel.
"""

from __future__ import annotations

import numpy as np

from ..native import udf_mc as native
from .cap import _corner_views
from .postprocess import clean_mesh, smooth_borders
from .triangulate import DEFAULT_TRIANGULATOR, triangulate_cells

# Cell gates, in voxels (reference values, ``_marching_cubes_lewiner.py:80``):
# avg(corner udf) < AVG_THRESH and max ≤ MAX_THRESH.  On top of these,
# extraction drops cells whose *vote confidence* is low (see
# ``extract_mesh_meshudf``): on exact fields confidence is uniformly high so
# nothing is lost (watertightness preserved), while on learned fields the
# low-confidence fringe is exactly where spurious geometry lives.
AVG_THRESH = 1.05
MAX_THRESH = 1.75
CONF_GATE_FRACTION = 0.1  # of the median participating-vertex confidence


def edge_relations(udf: np.ndarray, dirs: np.ndarray, participate: np.ndarray,
                   voxel: float):
    """Relations for the 3 positive-axis edge families.

    Returns list of (mask, rel_sign (+1/-1), confidence) arrays, each shaped
    like the edge slab for that axis; mask marks edges whose both endpoints
    participate.

    Robustness (learned direction fields are noisy near the surface, where
    the Hessian-eigenvector fallback has an ill-determined sign): the
    relation combines two evidence sources —

      * triangle inequality on the UDF *values*: if min(u_a, u_b) exceeds
        the edge length the surface cannot pass between the endpoints
        (crossing impossible, dirs overruled); if u_a + u_b ≈ edge length
        a crossing is likely regardless of dirs;
      * the direction test: a crossing flips the projections along the
        edge (dir_a·û > 0 > dir_b·û — dirs point toward the surface).
    """
    out = []
    for axis in range(3):
        sl_a = [slice(None)] * 3
        sl_b = [slice(None)] * 3
        sl_a[axis] = slice(0, -1)
        sl_b[axis] = slice(1, None)
        sl_a, sl_b = tuple(sl_a), tuple(sl_b)
        pa = dirs[sl_a][..., axis]
        pb = dirs[sl_b][..., axis]
        ua = udf[sl_a]
        ub = udf[sl_b]
        mn = np.minimum(ua, ub)
        ssum = ua + ub
        diff = np.abs(ua - ub)

        crossing_dir = (pa > 0) & (pb < 0)
        # the value bonus only AMPLIFIES direction-detected crossings: a
        # tangential near-surface edge also has small u_a + u_b but must
        # NOT be flagged (its projections are ~0 on both ends)
        cross_score = np.where(
            crossing_dir,
            np.abs(pa * pb) + np.maximum(0.0, 1.0 - ssum / voxel),
            0.0,
        )
        same_score = np.where(~crossing_dir, np.abs(pa * pb), 0.0)
        # |u_a − u_b| ≈ edge length ⇒ walking straight away from the same
        # nearest surface region ⇒ same side
        same_score = same_score + 3.0 * np.maximum(0.0, diff / voxel - 0.7)
        # geometric impossibility: surface cannot sit between the endpoints
        impossible = mn > 1.2 * voxel
        same_score = np.where(impossible, 10.0 + mn / voxel, same_score)
        cross_score = np.where(impossible, 0.0, cross_score)

        rel = np.where(cross_score > same_score, -1.0, 1.0).astype(np.float32)
        conf = np.abs(cross_score - same_score).astype(np.float32)
        mask = participate[sl_a] & participate[sl_b]
        out.append((mask, rel, conf))
    return out


def majority_relaxation(signs: np.ndarray, udf: np.ndarray, dirs: np.ndarray,
                        participate: np.ndarray, voxel: float,
                        iters: int = 30):
    """Iteratively re-vote each vertex's sign from its 6 neighbours.

    A spanning tree propagates one wrong relation into a whole wrong
    subtree; confidence-weighted neighbourhood majority voting erodes such
    regions (the array analogue of the reference's accumulate-votes +
    revisit-unsure BFS, ``_marching_cubes_lewiner_cy.pyx:1243-1375``).
    Fully vectorised: each iteration is six shifted multiply-adds.

    Returns (signs, confidence): confidence is the magnitude of the final
    weighted neighbourhood vote per vertex — low where the sign assignment
    is unreliable (parity seams, noisy fringe).
    """
    rels = edge_relations(udf, dirs, participate, voxel)
    weights = []
    for axis, (mask, rel, conf) in enumerate(rels):
        weights.append((conf * rel * mask).astype(np.float32))
    s = signs.astype(np.float32) * participate
    n_part = max(int(participate.sum()), 1)
    acc = np.zeros_like(s)
    for _ in range(iters):
        acc = np.zeros_like(s)
        for axis, w in enumerate(weights):
            sl_a = [slice(None)] * 3
            sl_b = [slice(None)] * 3
            sl_a[axis] = slice(0, -1)
            sl_b[axis] = slice(1, None)
            sl_a, sl_b = tuple(sl_a), tuple(sl_b)
            acc[sl_a] += w * s[sl_b]
            acc[sl_b] += w * s[sl_a]
        new = np.where(acc != 0, np.sign(acc), s)
        flips = int((new != s).sum())
        s = new
        if flips <= n_part // 10000:
            break
    out = signs.copy()
    nz = (s != 0) & participate
    out[nz] = s[nz].astype(np.int8)
    return out, np.abs(acc)


def compute_signs(udf: np.ndarray, dirs: np.ndarray, voxel_size: float,
                  max_dist_voxels: float = 2.0,
                  relax_iters: int = 30,
                  return_confidence: bool = False):
    """Pseudo-sign (+1/−1) per grid vertex.

    Maximum-confidence spanning-tree propagation (native C++) over the
    robust edge relations, followed by confidence-weighted majority
    relaxation to heal subtree flips caused by noisy relations.

    ``max_dist_voxels`` bounds the participating band around the surface.
    A UDF's sign structure is only *locally* consistent: around open-sheet
    borders and through thin walls, wider bands force parity conflicts
    whose seams damage the mesh.  2.0 voxels keeps thin-walled open shapes
    (the hard case — e.g. the reference's beetle shell) at paper-level
    Chamfer while staying wide enough for stable propagation on closed
    surfaces; raise it for smooth closed shapes (slightly better normal
    consistency), lower toward 1.75 (the reference's effective band) for
    very thin geometry.
    """
    udf = np.ascontiguousarray(udf, np.float32)
    dirs = np.ascontiguousarray(dirs, np.float32)
    participate = udf < max_dist_voxels * voxel_size
    # pack each axis family's (rel, conf) as one signed weight slab
    weights = []
    for axis, (mask, rel, conf) in enumerate(
        edge_relations(udf, dirs, participate, voxel_size)
    ):
        weights.append((rel * conf * mask).astype(np.float32))
    signs = native.sign_voting(udf, participate, *weights)
    conf = None
    if relax_iters:
        signs, conf = majority_relaxation(
            signs, udf, dirs, participate, voxel_size, iters=relax_iters
        )
    if return_confidence:
        return signs, conf, participate
    return signs


def gate_cells(udf: np.ndarray, voxel_size: float,
               avg_thresh: float = AVG_THRESH, max_thresh: float = MAX_THRESH):
    """(N-1)³ bool mask of cells allowed to triangulate (reference gates)."""
    uc = _corner_views(udf)
    avg = sum(uc) / 8.0
    mx = np.maximum.reduce(uc)
    return (avg < avg_thresh * voxel_size) & (mx <= max_thresh * voxel_size)


def _trilinear(udf: np.ndarray, pts: np.ndarray, voxel: float) -> np.ndarray:
    """Trilinear sample of the (N,N,N) grid at world points in [-1,1]³."""
    g = (pts + 1.0) / voxel
    i0 = np.clip(np.floor(g).astype(np.int64), 0, udf.shape[0] - 2)
    t = g - i0
    out = np.zeros(len(pts), udf.dtype)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = (
                    (t[:, 0] if dx else 1 - t[:, 0])
                    * (t[:, 1] if dy else 1 - t[:, 1])
                    * (t[:, 2] if dz else 1 - t[:, 2])
                )
                out += w * udf[i0[:, 0] + dx, i0[:, 1] + dy, i0[:, 2] + dz]
    return out


def extract_mesh_meshudf(
    udf,
    dirs,
    *,
    smooth_borders_enabled: bool = True,
    avg_thresh: float = AVG_THRESH,
    max_thresh: float = MAX_THRESH,
    max_face_dist_voxels: float | None = None,
    triangulator: str = DEFAULT_TRIANGULATOR,
    signing: str = "bfs",
):
    """-> (verts (V,3) in [-1,1]³, faces (F,3)), cleaned like the reference
    (``render_mc.py:103-199``: cleanup loop + optional border smoothing).

    ``signing``:
      * ``"bfs"`` (default) — the reference's region-growing vote semantics
        in native C++ (``native.udf_mc.vote_bfs``): deferred low-confidence
        cubes, anchor fallback, and mesh-support gating of non-trivial
        cells, which suppresses the parity-conflict seams around open-sheet
        borders (``_marching_cubes_lewiner_cy.pyx:1584-1750``);
      * ``"mst"`` — maximum-confidence spanning-tree propagation + majority
        relaxation with confidence cell gating.

    ``max_face_dist_voxels``: drop triangles whose centroid UDF exceeds this
    many voxels.  Low-confidence votes far from the surface can fabricate
    sign crossings inside the (wide) gate band; this prunes those spurious
    sheets — the reference has the same step stubbed out
    (``render_mc.py:142``).  Set None to disable."""
    udf = np.asarray(udf, np.float32)
    udf = np.maximum(udf, 0.0)  # reference clamps negatives (render_mc.py:126)
    dirs = np.asarray(dirs, np.float32)
    N = udf.shape[0]
    voxel = 2.0 / (N - 1)

    if signing == "bfs":
        signs, emit = native.vote_bfs(
            udf, dirs, voxel, avg_thresh=avg_thresh, max_thresh=max_thresh
        )
        # gather signed corner values only at emitted cells (avoids a full
        # N³ multiply + 8 strided-view gathers)
        idx = np.argwhere(emit.astype(bool))
        if len(idx) == 0:
            raise ValueError("Could not find surface in volume")
        flat_u = udf.reshape(-1)
        flat_s = signs.reshape(-1)
        s0, s1 = N * N, N
        base = idx[:, 0] * s0 + idx[:, 1] * s1 + idx[:, 2]
        offs = np.array([dx * s0 + dy * s1 + dz
                         for (dx, dy, dz) in [(0, 0, 0), (1, 0, 0), (0, 1, 0),
                                              (1, 1, 0), (0, 0, 1), (1, 0, 1),
                                              (0, 1, 1), (1, 1, 1)]])
        corner_lin = base[:, None] + offs[None, :]
        vals8 = flat_u[corner_lin] * flat_s[corner_lin]
        crossing = (vals8.min(axis=1) < 0) & (vals8.max(axis=1) >= 0)
        idx, vals8 = idx[crossing], vals8[crossing]
        if len(idx) == 0:
            raise ValueError("Could not find surface in volume")
        verts, faces = triangulate_cells(idx, vals8, voxel, triangulator)
        verts -= 1.0
        return _postprocess(verts, faces, udf, voxel, smooth_borders_enabled,
                            max_face_dist_voxels)
    elif signing == "mst":
        signs, conf, participate = compute_signs(udf, dirs, voxel,
                                                 return_confidence=True)
        signed = udf * signs

        gates = gate_cells(udf, voxel, avg_thresh, max_thresh)
        if conf is not None:
            # drop cells whose least-confident corner is far below the
            # typical vote confidence: exact fields are uniformly confident
            # (no cells lost), learned fields lose the unreliable fringe
            pos = conf[participate & (conf > 0)]
            ref_conf = np.median(pos) if pos.size else 0.0
            if ref_conf > 0:
                cc = _corner_views(conf)
                cmin = np.minimum.reduce(cc)
                gates = gates & (cmin > CONF_GATE_FRACTION * ref_conf)
        idx = np.argwhere(gates)
    else:
        raise ValueError(f"Invalid signing {signing!r}; expected 'bfs' or 'mst'")

    if len(idx) == 0:
        raise ValueError("Could not find surface in volume")
    uc = _corner_views(signed)
    ii, jj, kk = idx[:, 0], idx[:, 1], idx[:, 2]
    vals8 = np.stack([c[ii, jj, kk] for c in uc], axis=1)
    crossing = (vals8.min(axis=1) < 0) & (vals8.max(axis=1) >= 0)
    idx, vals8 = idx[crossing], vals8[crossing]
    if len(idx) == 0:
        raise ValueError("Could not find surface in volume")

    verts, faces = triangulate_cells(idx, vals8, voxel, triangulator)
    verts -= 1.0
    return _postprocess(verts, faces, udf, voxel, smooth_borders_enabled,
                        max_face_dist_voxels)


def _postprocess(verts, faces, udf, voxel, smooth_borders_enabled,
                 max_face_dist_voxels):
    """Reference cleanup chain (``render_mc.py:148-197``): dedupe/degenerate
    cleanup, speck removal, consistent winding, optional border smoothing."""
    if max_face_dist_voxels is not None and len(faces):
        centroids = verts[faces].mean(axis=1)
        d = _trilinear(udf, centroids, voxel)
        faces = faces[d <= max_face_dist_voxels * voxel]
        if len(faces) == 0:
            raise ValueError("Could not find surface in volume")
    verts, faces = clean_mesh(verts, faces)
    from .postprocess import orient_faces_consistently, remove_small_components

    verts, faces = remove_small_components(verts, faces)
    if len(faces) == 0:
        raise ValueError("Could not find surface in volume")
    faces = orient_faces_consistently(faces)
    if smooth_borders_enabled and len(faces):
        verts = smooth_borders(verts, faces)
    return verts, faces
