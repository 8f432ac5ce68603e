"""Mesh post-processing: cleanup loop + border Laplacian smoothing.

Dependency-free numpy/scipy re-implementation of the trimesh pipeline the
reference runs after MeshUDF extraction (``src/render_mc.py:148-197``):

  * iterate {merge duplicate vertices, drop duplicate & degenerate faces,
    drop unreferenced vertices, fill single-triangle holes} until stable
    (≤10 rounds);
  * optionally smooth open-boundary ("border") vertices with 5 rounds of
    λ=0.3 Laplacian over the border-edge adjacency only.
"""

from __future__ import annotations

import numpy as np


def _unique_rows(keys):
    """(first_idx, inverse) over duplicate rows via lexsort.

    ``np.unique(axis=0)`` sorts a void view of the rows — several times
    slower at mesh scale (hundreds of thousands of vertices per cleanup
    round); a column lexsort plus neighbour compare gives the same groups.
    Representatives are the group's first row in sorted order (duplicate
    rows are exactly equal, so any representative is equivalent).
    """
    if len(keys) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    order = np.lexsort(keys.T[::-1])
    sk = keys[order]
    new = np.empty(len(keys), bool)
    new[0] = True
    new[1:] = (sk[1:] != sk[:-1]).any(axis=1)
    group = np.cumsum(new) - 1
    inverse = np.empty(len(keys), np.int64)
    inverse[order] = group
    return order[new], inverse


def _merge_duplicate_vertices(verts, faces, decimals: int = 8):
    keys = np.round(verts * (10**decimals)).astype(np.int64)
    first_idx, inverse = _unique_rows(keys)
    return verts[first_idx], inverse[faces]


def _drop_bad_faces(faces):
    # degenerate: repeated vertex indices
    good = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    faces = faces[good]
    # duplicates irrespective of winding: canonical sorted key
    key = np.sort(faces, axis=1)
    first, _ = _unique_rows(key)
    return faces[np.sort(first)]


def _drop_unreferenced(verts, faces):
    used = np.unique(faces)
    remap = np.full(len(verts), -1, dtype=np.int64)
    remap[used] = np.arange(len(used))
    return verts[used], remap[faces]


def boundary_edges(faces):
    """Edges belonging to exactly one face: (E, 2) sorted vertex pairs."""
    if len(faces) == 0:
        return np.zeros((0, 2), np.int64)
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    e = np.sort(e, axis=1)
    # pack each sorted pair into one int64 (vertex ids < 2^31): a flat
    # unique is far cheaper than the axis=0 row sort
    n = int(e.max()) + 1
    packed = e[:, 0].astype(np.int64) * n + e[:, 1]
    uniq, counts = np.unique(packed, return_counts=True)
    single = uniq[counts == 1]
    return np.stack([single // n, single % n], axis=1)


def _fill_triangle_holes(verts, faces):
    """Close boundary loops of exactly 3 vertices (trimesh ``fill_holes``
    for the single-triangle case)."""
    be = boundary_edges(faces)
    if len(be) == 0:
        return faces
    # adjacency among boundary vertices
    from collections import defaultdict

    adj = defaultdict(set)
    for u, v in be:
        adj[u].add(v)
        adj[v].add(u)
    new_faces = []
    seen = set()
    for u in list(adj):
        for v in adj[u]:
            if v <= u:
                continue
            common = adj[u] & adj[v]
            for w in common:
                if w <= v:
                    continue
                tri = (u, v, w)
                if tri not in seen:
                    seen.add(tri)
                    new_faces.append(tri)
    if not new_faces:
        return faces
    return np.concatenate([faces, np.asarray(new_faces, dtype=faces.dtype)])


def clean_mesh(verts, faces, max_iters: int = 10, fill_holes: bool = True):
    """Iterated cleanup until (V, F) counts stabilise (≤ ``max_iters``)."""
    verts = np.asarray(verts, dtype=np.float64)
    faces = np.asarray(faces, dtype=np.int64)
    prev = (-1, -1)
    for _ in range(max_iters):
        if len(faces) == 0:
            break
        verts, faces = _merge_duplicate_vertices(verts, faces)
        faces = _drop_bad_faces(faces)
        verts, faces = _drop_unreferenced(verts, faces)
        if fill_holes:
            faces = _fill_triangle_holes(verts, faces)
        cur = (len(verts), len(faces))
        if cur == prev:
            break
        prev = cur
    return verts, faces


def remove_small_components(verts, faces, min_faces: int = 30):
    """Drop connected components with fewer than ``min_faces`` triangles.

    Voted-sign extraction can fabricate isolated specks where vote
    confidence is low; they wreck the normal-consistency metric (random
    normals) and bloat downstream processing.  Components are computed on
    the vertex graph.  The largest component always survives, so a valid
    (if tiny) surface is never reduced to an empty mesh.
    """
    faces = np.asarray(faces, dtype=np.int64)
    if len(faces) == 0:
        return np.asarray(verts), faces
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    n = len(verts)
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    g = coo_matrix((np.ones(len(e)), (e[:, 0], e[:, 1])), shape=(n, n))
    _, labels = connected_components(g, directed=False)
    face_label = labels[faces[:, 0]]
    counts = np.bincount(face_label)
    keep = (counts[face_label] >= min_faces) | (face_label == counts.argmax())
    return _drop_unreferenced(np.asarray(verts), faces[keep])


def orient_faces_consistently(faces):
    """Flip faces so neighbouring triangles wind consistently.

    Two faces sharing an edge are consistently oriented iff they traverse
    the shared edge in opposite directions.  Builds the face-adjacency
    graph over manifold (2-face) edges and propagates a flip flag over a
    BFS forest.  Fixes vertex-normal averaging (normal-consistency metric)
    for extractions whose per-cell sign conventions differ (CAP's per-cell
    anchors, ``render_mc.py:225-228``).

    Returns a new faces array (orientation of each connected component is
    arbitrary — callers relying on |cos| metrics don't care).
    """
    faces = np.asarray(faces, dtype=np.int64)
    nf = len(faces)
    if nf == 0:
        return faces
    # directed edges per face
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    face_of = np.tile(np.arange(nf), 3)
    lo = np.minimum(e[:, 0], e[:, 1])
    hi = np.maximum(e[:, 0], e[:, 1])
    key = lo * (faces.max() + 1) + hi
    forward = (e[:, 0] < e[:, 1]).astype(np.int8)  # direction vs canonical

    order = np.argsort(key, kind="stable")
    key_s = key[order]
    face_s = face_of[order]
    fwd_s = forward[order]
    # manifold pairs: consecutive equal keys appearing exactly twice
    same = key_s[1:] == key_s[:-1]
    # exclude runs longer than 2
    run_start = np.flatnonzero(np.concatenate([[True], key_s[1:] != key_s[:-1]]))
    run_len = np.diff(np.concatenate([run_start, [len(key_s)]]))
    good_run = np.repeat(run_len == 2, run_len)
    pair_first = np.flatnonzero(same & good_run[1:])
    fa = face_s[pair_first]
    fb = face_s[pair_first + 1]
    # consistent iff they traverse the edge in opposite directions
    rel = np.where(fwd_s[pair_first] != fwd_s[pair_first + 1], 1, -1)

    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import breadth_first_order

    graph = coo_matrix(
        (np.ones(len(fa)), (fa, fb)), shape=(nf, nf)
    ).tocsr()
    graph = graph + graph.T

    # vectorised (a, b) -> rel lookup
    rel_keys = np.concatenate([fa * nf + fb, fb * nf + fa])
    rel_vals = np.concatenate([rel, rel])
    rk_order = np.argsort(rel_keys, kind="stable")
    rel_keys = rel_keys[rk_order]
    rel_vals = rel_vals[rk_order]

    # Spanning forest parents via BFS per component; the flip flag of a face
    # is the XOR of edge-inconsistency flags along its tree path, computed
    # in O(log F) vectorised pointer-doubling rounds (the previous python
    # walk over every face cost ~10 s at 1M faces).
    parent = np.arange(nf, dtype=np.int64)  # roots point to themselves
    seen = np.zeros(nf, dtype=bool)
    for seed in range(nf):
        if seen[seed]:
            continue
        bfs, preds = breadth_first_order(graph, seed, directed=False,
                                         return_predecessors=True)
        seen[bfs] = True
        vs = bfs[1:]
        if len(vs):
            parent[vs] = preds[vs]

    # flag[v] = 1 iff the tree edge (parent[v], v) is winding-inconsistent
    flag = np.zeros(nf, dtype=np.int8)
    vs = np.flatnonzero(parent != np.arange(nf))
    if len(vs):
        pos = np.searchsorted(rel_keys, parent[vs] * nf + vs)
        rels = rel_vals[np.clip(pos, 0, len(rel_vals) - 1)]
        flag[vs] = (rels < 0).astype(np.int8)

    # pointer doubling: acc[v] accumulates the path XOR, ptr[v] jumps 2^k up
    acc = flag.copy()
    ptr = parent.copy()
    for _ in range(64):
        nxt = ptr[ptr]
        if np.array_equal(nxt, ptr):
            break
        acc ^= acc[ptr]
        ptr = nxt
    out = faces.copy()
    sel = acc.astype(bool)
    out[sel] = out[sel][:, [0, 2, 1]]
    return out


def smooth_borders(verts, faces, lam: float = 0.3, iters: int = 5):
    """Laplacian-smooth open-boundary vertices along the border adjacency
    (``src/render_mc.py:169-197`` semantics: neighbours come from border
    edges only)."""
    verts = np.array(verts, dtype=np.float64, copy=True)
    be = boundary_edges(np.asarray(faces, dtype=np.int64))
    if len(be) == 0:
        return verts
    from scipy.sparse import coo_matrix

    border_vertices = np.unique(be)
    index_of = {v: i for i, v in enumerate(border_vertices)}
    rows, cols = [], []
    for u, v in be:
        rows.append(index_of[u]); cols.append(v)
        rows.append(index_of[v]); cols.append(u)
    mat = coo_matrix(
        (np.ones(len(rows)), (rows, cols)), shape=(len(border_vertices), len(verts))
    ).tocsr()
    deg = np.asarray(mat.sum(axis=1)).ravel()[:, None]
    for _ in range(iters):
        avg = mat @ verts / deg
        verts[border_vertices] += lam * (avg - verts[border_vertices])
    return verts


def taubin_smooth(verts, faces, iterations: int = 5, lam: float = 0.5,
                  mu: float = -0.53):
    """Shrink-free Taubin λ|μ mesh smoothing (Taubin 1995).

    Alternates a positive (λ) and negative (μ) uniform-Laplacian step so
    low-frequency shape is preserved while high-frequency vertex noise —
    the dominant term of marching-cubes vertex-normal error — is removed.
    The reference only smooths *border* vertices (``render_mc.py:169-197``,
    :func:`smooth_borders`); full-mesh smoothing is an opt-in extra of this
    framework (``generate_mc`` config key ``taubin_iters``), typically
    paired with field reprojection (:mod:`.refine`) which restores any
    residual drift back onto the zero set.
    """
    if len(faces) == 0 or iterations <= 0:
        return verts
    from scipy.sparse import coo_matrix

    n = len(verts)
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    e = np.concatenate([e, e[:, ::-1]])
    A = coo_matrix(
        (np.ones(len(e), np.float32), (e[:, 0], e[:, 1])), shape=(n, n)
    ).tocsr()
    A.data[:] = 1.0  # collapse duplicate edge entries to weight 1
    deg = np.maximum(np.asarray(A.sum(axis=1)).ravel(), 1.0)[:, None]
    x = np.asarray(verts, np.float64)
    for _ in range(iterations):
        x = x + lam * (A @ x / deg - x)
        x = x + mu * (A @ x / deg - x)
    return x.astype(verts.dtype if hasattr(verts, "dtype") else np.float32)
