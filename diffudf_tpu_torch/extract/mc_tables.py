"""Marching-cubes case tables, generated from first principles at import.

The reference triangulates with Lewiner's topological MC33 — 527 lines of
base64 lookup tables plus a hand-written case switch with ``test_face``/
``test_internal`` ambiguity resolution (reference ``src/marching_cubes/
_marching_cubes_lewiner_luts.py:1-527``, ``_marching_cubes_lewiner_cy.pyx:
1848+``).  Rather than porting those tables, this module *derives* an
equivalent table family programmatically:

  * For each of the 256 corner-sign configurations, the zero contour on each
    cube face is a set of oriented segments between cut edges; segments chain
    into closed loops (every cut edge lies on exactly two faces, once as a
    segment start and once as an end); loops are fan-triangulated.
  * Faces with a diagonal sign pattern are ambiguous (two valid segment
    pairings).  The table is *expanded per ambiguous-face decision*: a case
    with ``a`` ambiguous faces gets ``2^a`` entries.  At runtime the decision
    is the **asymptotic decider** — the sign of the bilinear saddle value,
    a symmetric function of the four face values, so the two cells sharing a
    face always agree and the mesh is crack-free by construction (this is
    exactly the role of Lewiner's ``test_face``, ``pyx:2404``).
  * Interior (tunnel) ambiguity — Lewiner's ``test_internal`` — is not
    resolved; those rare configurations pick the non-tunnel topology.  The
    reference's own deferred-queue BFS treats these "non-trivial MC cases"
    as second-class too (``pyx:1744-1750``).

Conventions (shared with :mod:`.tet_mc`):
  corner ``c`` in [0,8) sits at offset ``(c&1, c>>1&1, c>>2&1)``;
  "inside" means field value < 0; triangle normals point from the negative
  side toward the positive side.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------- geometry

CORNER_OFFSETS = np.array(
    [[c & 1, (c >> 1) & 1, (c >> 2) & 1] for c in range(8)], dtype=np.float64
)

# canonical edge list: 12 edges as (low corner, high corner = low | 1<<axis)
EDGES = [
    (c, c | (1 << a)) for a in range(3) for c in range(8) if not c & (1 << a)
]
EDGE_INDEX = {e: i for i, e in enumerate(EDGES)}
EDGE_CORNERS = np.array(EDGES, dtype=np.int64)  # (12, 2)
# axis of each edge (0,1,2) and lattice offset of its low corner
EDGE_AXIS = np.array([a for a in range(3) for c in range(8) if not c & (1 << a)],
                     dtype=np.int64)
EDGE_LOW_OFFSET = CORNER_OFFSETS[EDGE_CORNERS[:, 0]].astype(np.int64)  # (12, 3)


def _face_cycle(axis: int, side: int):
    """4 corners of a face in CCW order viewed from outside the cube."""
    u_axis, v_axis = {0: (1, 2), 1: (2, 0), 2: (0, 1)}[axis]
    if side == 0:  # outward normal is -axis: swap u/v to flip orientation
        u_axis, v_axis = v_axis, u_axis
    cyc = []
    for (u, v) in ((0, 0), (1, 0), (1, 1), (0, 1)):
        c = (side << axis) | (u << u_axis) | (v << v_axis)
        cyc.append(c)
    return tuple(cyc)


# 6 faces: index f = 2*axis + side
FACES = [_face_cycle(a, s) for a in range(3) for s in (0, 1)]
FACE_CORNERS = np.array(FACES, dtype=np.int64)  # (6, 4) canonical cycles


# ------------------------------------------------------------- generation

def _face_segments(cycle, inside, neg_connected: bool):
    """Oriented contour segments (from_edge, to_edge) on one face.

    Traversing the cycle CCW (viewed from outside), a segment starts where
    the traversal crosses inside→outside and ends at the next
    outside→inside crossing.  ``neg_connected`` picks the pairing for the
    ambiguous diagonal pattern: True keeps the two inside corners connected
    across the face (each segment cuts off one outside corner).
    """
    crossings = []  # (position in cycle, kind) kind: 'exit' or 'entry'
    for i in range(4):
        a, b = cycle[i], cycle[(i + 1) % 4]
        ia, ib = inside[a], inside[b]
        if ia == ib:
            continue
        key = (min(a, b), max(a, b))
        crossings.append((EDGE_INDEX[key], "exit" if ia else "entry"))
    if not crossings:
        return []
    if len(crossings) == 2:
        (e0, k0), (e1, k1) = crossings
        assert {k0, k1} == {"exit", "entry"}
        return [(e0, e1)] if k0 == "exit" else [(e1, e0)]
    # ambiguous: exits and entries alternate around the cycle
    assert len(crossings) == 4
    kinds = [k for _, k in crossings]
    assert kinds in (["exit", "entry"] * 2, ["entry", "exit"] * 2)
    s = 0 if kinds[0] == "exit" else 1
    ex0, en0, ex1, en1 = (crossings[(s + i) % 4][0] for i in range(4))
    # pairing exit→next entry isolates the outside corner between them,
    # keeping the inside corners connected
    if neg_connected:
        return [(ex0, en0), (ex1, en1)]
    return [(ex0, en1), (ex1, en0)]


def _ambiguous_faces(mask: int) -> int:
    """Bitmask of faces whose 4 corners show the diagonal pattern."""
    amb = 0
    for f, cyc in enumerate(FACES):
        bits = [(mask >> c) & 1 for c in cyc]
        if bits == [1, 0, 1, 0] or bits == [0, 1, 0, 1]:
            amb |= 1 << f
    return amb


def _loops_for(mask: int, decider_bits: int):
    """Closed loops of cut-edge indices for one (case, decision) entry."""
    inside = [(mask >> c) & 1 for c in range(8)]
    nxt = {}
    for f, cyc in enumerate(FACES):
        neg_conn = bool((decider_bits >> f) & 1)
        for a, b in _face_segments(cyc, inside, neg_conn):
            assert a not in nxt
            nxt[a] = b
    loops = []
    seen = set()
    for start in list(nxt):
        if start in seen:
            continue
        loop = [start]
        seen.add(start)
        cur = nxt[start]
        while cur != start:
            loop.append(cur)
            seen.add(cur)
            cur = nxt[cur]
        loops.append(loop)
    return loops


def _triangulate(loops):
    tris = []
    for loop in loops:
        # loops come out clockwise around the negative region when viewed
        # from the positive side; reverse so triangle normals (right-hand
        # rule) point from the negative side toward the positive side
        for i in range(1, len(loop) - 1):
            tris.append((loop[0], loop[i + 1], loop[i]))
    return tris


def _build_tables():
    amb_mask = np.zeros(256, dtype=np.int64)
    case_offset = np.zeros(256, dtype=np.int64)
    trivial = np.zeros(256, dtype=np.uint8)
    entries = []
    off = 0
    for mask in range(256):
        amb = _ambiguous_faces(mask)
        amb_mask[mask] = amb
        case_offset[mask] = off
        # "trivial" MC configuration: no ambiguous faces and a single
        # contour loop.  Used by the voted-sign BFS to decide which cubes
        # are safe to mesh immediately; the reference defers its Lewiner
        # case numbers ∉ {1,2,5,8,9} the same way (``pyx:1744-1750``) —
        # this criterion additionally admits the rare unambiguous
        # single-loop 4-corner snakes (Lewiner 11/14), a documented
        # deviation.
        trivial[mask] = (amb == 0) and len(_loops_for(mask, 0)) <= 1
        amb_faces = [f for f in range(6) if amb & (1 << f)]
        for sub in range(1 << len(amb_faces)):
            dec = 0
            for i, f in enumerate(amb_faces):
                if (sub >> i) & 1:
                    dec |= 1 << f
            entries.append(_triangulate(_loops_for(mask, dec)))
        off += 1 << len(amb_faces)

    max_t = max((len(t) for t in entries), default=0)
    tri_table = np.full((len(entries), max_t, 3), -1, dtype=np.int64)
    for i, tris in enumerate(entries):
        for j, t in enumerate(tris):
            tri_table[i, j] = t

    # pext: compress the 6 decider bits through an ambiguity mask
    pext = np.zeros((64, 64), dtype=np.int64)
    for m in range(64):
        for b in range(64):
            out = 0
            k = 0
            for f in range(6):
                if m & (1 << f):
                    if b & (1 << f):
                        out |= 1 << k
                    k += 1
            pext[m, b] = out
    return amb_mask, case_offset, tri_table, pext, trivial


AMB_MASK, CASE_OFFSET, TRI_TABLE, PEXT, TRIVIAL_CASE = _build_tables()
MAX_TRIS = TRI_TABLE.shape[1]
