"""Exact Lewiner-33 marching cubes over a compact set of grid cells.

Reference-exact counterpart of the native module's triangulation
(reference ``src/marching_cubes/_marching_cubes_lewiner_cy.pyx:
1848-2125`` — the "big switch" — with ``test_face`` at ``pyx:2404`` and
``test_internal`` at ``pyx:2436``), driven by Lewiner's published lookup
tables (decoded once from the reference's base64 blobs into
``lewiner_luts.npz`` by ``scripts/decode_lewiner_luts.py``).

Unlike the derived-table backend (:mod:`.table_mc`, asymptotic decider,
no interior test), this backend resolves **face ambiguity** with Lewiner's
``test_face`` (sign of A·C−B·D on the face, corner A/face sign inverted)
and **interior (tunnel) ambiguity** with ``test_internal`` — so the rare
tunnel configurations (cases 4, 6, 7, 10, 12, 13) get the reference's
topology, including the center-vertex (v12) tilings.

Semantics ported from behavior, re-expressed as vectorised numpy over all
cells of a case class at once (the reference runs one scalar switch per
cube).  Matches the reference bit-for-bit on: corner numbering (Lewiner
order, "inside" ⇔ value > 0), vertex placement (inverse-|value| weighted
endpoint average — identical to linear interpolation on cut edges — and
the weighted 8-corner average for v12), FLT_EPSILON guards, and the
``test_internal`` outcome table *including* the reference port's
fall-through (tests 5/10 with a failed saddle condition return False
rather than the original C's ``s<0`` — ``pyx:2560-2570``).

Contract shared with :func:`.table_mc.marching_cubes_cells`:
cell_values in ``mc_tables.CORNER_OFFSETS`` order (bit0=x, bit1=y,
bit2=z), "inside" = value < 0, triangle normals point from the negative
side toward the positive side, cross-cell vertices dedupe exactly.
"""

from __future__ import annotations

import os.path as osp

import numpy as np

FLT_EPS = 1.1920929e-07  # C float.h FLT_EPSILON, as used by the reference

_LUTS = None


def _luts():
    global _LUTS
    if _LUTS is None:
        with np.load(osp.join(osp.dirname(__file__), "lewiner_luts.npz")) as z:
            _LUTS = {k: z[k].astype(np.int64) for k in z.files}
    return _LUTS


# Lewiner corner i (L0=(0,0,0), L1=(1,0,0), L2=(1,1,0), L3=(0,1,0), upper
# ring likewise) -> this package's corner index (bit0=x, bit1=y, bit2=z)
_L2MY = np.array([0, 1, 3, 2, 4, 5, 7, 6], dtype=np.int64)
_OFF_L = np.array(
    [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
     [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], dtype=np.int64
)

# 12 edges, endpoints in Lewiner corner ids (matches EDGETORELATIVEPOS*,
# ``_marching_cubes_lewiner.py:160-162``)
_EDGE_L = np.array(
    [[0, 1], [1, 2], [2, 3], [3, 0],
     [4, 5], [5, 6], [6, 7], [7, 4],
     [0, 4], [1, 5], [2, 6], [3, 7]], dtype=np.int64
)
# per edge: axis of variation + lattice offset of the low corner
_EDGE_AXIS = np.array(
    [np.flatnonzero(_OFF_L[a] != _OFF_L[b])[0] for a, b in _EDGE_L],
    dtype=np.int64,
)
_EDGE_LOW = np.array(
    [_OFF_L[a] if _OFF_L[a][ax] == 0 else _OFF_L[b]
     for (a, b), ax in zip(_EDGE_L, _EDGE_AXIS)], dtype=np.int64
)

# test_face corner quadruples (A, B, C, D) per |face| 1..6 (``pyx:2415-2426``)
_FACE_ABCD = np.array(
    [[0, 4, 5, 1], [1, 5, 6, 2], [2, 6, 7, 3],
     [3, 7, 4, 0], [0, 3, 2, 1], [4, 7, 6, 5]], dtype=np.int64
)

# test_internal edge parametrisation (``pyx:2467-2545``): per reference
# edge, (P, Q, B0, B1, C0, C1, D0, D1): t = v[P]/(v[P]−v[Q]+ε), At = 0,
# Bt = lerp(v[B0], v[B1], t), Ct/Dt likewise
_ITEST_EDGE = np.array([
    [0, 1, 3, 2, 7, 6, 4, 5],
    [1, 2, 0, 3, 4, 7, 5, 6],
    [2, 3, 1, 0, 5, 4, 6, 7],
    [3, 0, 2, 1, 6, 5, 7, 4],
    [4, 5, 7, 6, 3, 2, 0, 1],
    [5, 6, 4, 7, 0, 3, 1, 2],
    [6, 7, 5, 4, 1, 0, 2, 3],
    [7, 4, 6, 5, 2, 1, 3, 0],
    [0, 4, 3, 7, 2, 6, 1, 5],
    [1, 5, 0, 4, 3, 7, 2, 6],
    [2, 6, 1, 5, 0, 4, 3, 7],
    [3, 7, 2, 6, 1, 5, 0, 4],
], dtype=np.int64)


def _test_face(lv: np.ndarray, face: np.ndarray) -> np.ndarray:
    """Vectorised ``test_face`` (``pyx:2404-2434``).

    lv: (m, 8) Lewiner-ordered corner values; face: (m,) signed face id.
    """
    quad = _FACE_ABCD[np.abs(face) - 1]  # (m, 4)
    g = np.take_along_axis(lv, quad, axis=1)
    a, b, c, d = g[:, 0], g[:, 1], g[:, 2], g[:, 3]
    ac_bd = a * c - b * d
    return np.where(
        np.abs(ac_bd) < FLT_EPS, face >= 0, face * a * ac_bd >= 0
    ).astype(bool)


def _test_internal(lv, case: int, s, edge=None):
    """Vectorised ``test_internal`` (``pyx:2436-2570``).

    lv: (m, 8); s: (m,) signed test value; edge: (m,) reference edge for
    cases 6/7/12/13 (ignored for 4/10).
    """
    v = [lv[:, i] for i in range(8)]
    if case in (4, 10):
        a = (v[4] - v[0]) * (v[6] - v[2]) - (v[7] - v[3]) * (v[5] - v[1])
        b = (
            v[2] * (v[4] - v[0]) + v[0] * (v[6] - v[2])
            - v[1] * (v[7] - v[3]) - v[3] * (v[5] - v[1])
        )
        t = -b / (2.0 * a + FLT_EPS)
        at = v[0] + (v[4] - v[0]) * t
        bt = v[3] + (v[7] - v[3]) * t
        ct = v[2] + (v[6] - v[2]) * t
        dt = v[1] + (v[5] - v[1]) * t
        t_ok = (t >= 0) & (t <= 1)
    else:
        par = _ITEST_EDGE[edge]  # (m, 8)
        gv = np.take_along_axis(lv, par, axis=1)
        p, q = gv[:, 0], gv[:, 1]
        t = p / (p - q + FLT_EPS)
        at = np.zeros_like(t)
        bt = gv[:, 2] + (gv[:, 3] - gv[:, 2]) * t
        ct = gv[:, 4] + (gv[:, 5] - gv[:, 4]) * t
        dt = gv[:, 6] + (gv[:, 7] - gv[:, 6]) * t
        t_ok = np.ones(len(t), bool)

    test = (
        (at >= 0).astype(np.int64)
        + 2 * (bt >= 0).astype(np.int64)
        + 4 * (ct >= 0).astype(np.int64)
        + 8 * (dt >= 0).astype(np.int64)
    )
    saddle = at * ct - bt * dt
    s_pos = s > 0
    s_neg = s < 0

    out = np.where(
        np.isin(test, (7, 11, 13, 14, 15)),
        s_neg,
        s_pos,
    )
    # the reference port returns False (fall-through) when the saddle
    # condition of tests 5/10 fails — NOT the original C's ``s<0``
    out = np.where(test == 5, np.where(saddle < FLT_EPS, s_pos, False), out)
    out = np.where(test == 10, np.where(saddle >= FLT_EPS, s_pos, False), out)
    # cases 4/10: a saddle parameter outside [0, 1] short-circuits to s>0
    out = np.where(t_ok, out, s_pos)
    return out.astype(bool)


def _dispatch(lv, cls, cfg):
    """Run the big switch for every cell at once.

    Returns (cell_idx (F,), tri_vids (F, 3) local vertex ids 0..12).
    """
    L = _luts()
    out_cells = []
    out_tris = []

    def emit(sel, rows, nt):
        """sel: (m,) cell indices; rows: (m, 3·nt) vertex ids."""
        if len(sel) == 0:
            return
        tris = rows.reshape(len(sel), nt, 3)
        out_cells.append(np.repeat(sel, nt))
        out_tris.append(tris.reshape(-1, 3))

    def rows2(table, cf):
        return table[cf]

    def rows3(table, cf, sub):
        return table[cf, sub]

    for c in range(1, 15):
        sel = np.flatnonzero(cls == c)
        if len(sel) == 0:
            continue
        v = lv[sel]
        cf = cfg[sel]

        if c == 1:
            emit(sel, rows2(L["TILING1"], cf), 1)
        elif c == 2:
            emit(sel, rows2(L["TILING2"], cf), 2)
        elif c == 3:
            tf = _test_face(v, L["TEST3"][cf])
            emit(sel[tf], rows2(L["TILING3_2"], cf[tf]), 4)
            emit(sel[~tf], rows2(L["TILING3_1"], cf[~tf]), 2)
        elif c == 4:
            ti = _test_internal(v, 4, L["TEST4"][cf])
            emit(sel[ti], rows2(L["TILING4_1"], cf[ti]), 2)
            emit(sel[~ti], rows2(L["TILING4_2"], cf[~ti]), 6)
        elif c == 5:
            emit(sel, rows2(L["TILING5"], cf), 3)
        elif c == 6:
            tf = _test_face(v, L["TEST6"][cf, 0])
            emit(sel[tf], rows2(L["TILING6_2"], cf[tf]), 5)
            r = ~tf
            ti = _test_internal(
                v[r], 6, L["TEST6"][cf[r], 1], edge=L["TEST6"][cf[r], 2]
            )
            emit(sel[r][ti], rows2(L["TILING6_1_1"], cf[r][ti]), 3)
            emit(sel[r][~ti], rows2(L["TILING6_1_2"], cf[r][~ti]), 9)
        elif c == 7:
            sub = (
                _test_face(v, L["TEST7"][cf, 0]).astype(np.int64)
                + 2 * _test_face(v, L["TEST7"][cf, 1]).astype(np.int64)
                + 4 * _test_face(v, L["TEST7"][cf, 2]).astype(np.int64)
            )
            m0 = sub == 0
            emit(sel[m0], rows2(L["TILING7_1"], cf[m0]), 3)
            for sc, slot in ((1, 0), (2, 1), (4, 2)):
                m = sub == sc
                emit(sel[m], rows3(L["TILING7_2"], cf[m], slot), 5)
            for sc, slot in ((3, 0), (5, 1), (6, 2)):
                m = sub == sc
                emit(sel[m], rows3(L["TILING7_3"], cf[m], slot), 9)
            m7 = sub == 7
            ti = _test_internal(
                v[m7], 7, L["TEST7"][cf[m7], 3], edge=L["TEST7"][cf[m7], 4]
            )
            emit(sel[m7][ti], rows2(L["TILING7_4_2"], cf[m7][ti]), 9)
            emit(sel[m7][~ti], rows2(L["TILING7_4_1"], cf[m7][~ti]), 5)
        elif c == 8:
            emit(sel, rows2(L["TILING8"], cf), 2)
        elif c == 9:
            emit(sel, rows2(L["TILING9"], cf), 4)
        elif c in (10, 12):
            test = L["TEST10"] if c == 10 else L["TEST12"]
            t11_ = L["TILING10_1_1_"] if c == 10 else L["TILING12_1_1_"]
            t2 = L["TILING10_2"] if c == 10 else L["TILING12_2"]
            t2_ = L["TILING10_2_"] if c == 10 else L["TILING12_2_"]
            t11 = L["TILING10_1_1"] if c == 10 else L["TILING12_1_1"]
            t12 = L["TILING10_1_2"] if c == 10 else L["TILING12_1_2"]
            tf0 = _test_face(v, test[cf, 0])
            tf1 = _test_face(v, test[cf, 1])
            m = tf0 & tf1
            emit(sel[m], rows2(t11_, cf[m]), 4)
            m = tf0 & ~tf1
            emit(sel[m], rows2(t2, cf[m]), 8)
            m = ~tf0 & tf1
            emit(sel[m], rows2(t2_, cf[m]), 8)
            m = ~tf0 & ~tf1
            if c == 10:
                ti = _test_internal(v[m], 10, test[cf[m], 2])
            else:
                ti = _test_internal(
                    v[m], 12, test[cf[m], 2], edge=test[cf[m], 3]
                )
            emit(sel[m][ti], rows2(t11, cf[m][ti]), 4)
            emit(sel[m][~ti], rows2(t12, cf[m][~ti]), 8)
        elif c == 11:
            emit(sel, rows2(L["TILING11"], cf), 4)
        elif c == 13:
            sub = np.zeros(len(sel), np.int64)
            for bit in range(6):
                sub += (1 << bit) * _test_face(v, L["TEST13"][cf, bit])
            sc = L["SUBCONFIG13"][sub]
            m = sc == 0
            emit(sel[m], rows2(L["TILING13_1"], cf[m]), 4)
            for k in range(1, 7):
                m = sc == k
                emit(sel[m], rows3(L["TILING13_2"], cf[m], k - 1), 6)
            for k in range(7, 19):
                m = sc == k
                emit(sel[m], rows3(L["TILING13_3"], cf[m], k - 7), 10)
            for k in range(19, 23):
                m = sc == k
                emit(sel[m], rows3(L["TILING13_4"], cf[m], k - 19), 12)
            for k in range(23, 27):
                m = sc == k
                if not m.any():
                    continue
                slot = k - 23
                edge = L["TILING13_5_1"][cf[m], slot, 0]
                ti = _test_internal(v[m], 13, L["TEST13"][cf[m], 6], edge=edge)
                emit(sel[m][ti], rows3(L["TILING13_5_1"], cf[m][ti], slot), 6)
                emit(sel[m][~ti], rows3(L["TILING13_5_2"], cf[m][~ti], slot), 10)
            for k in range(27, 39):
                m = sc == k
                emit(sel[m], rows3(L["TILING13_3_"], cf[m], k - 27), 10)
            for k in range(39, 45):
                m = sc == k
                emit(sel[m], rows3(L["TILING13_2_"], cf[m], k - 39), 6)
            m = sc == 45
            emit(sel[m], rows2(L["TILING13_1_"], cf[m]), 4)
        elif c == 14:
            emit(sel, rows2(L["TILING14"], cf), 4)

    if not out_cells:
        return np.zeros(0, np.int64), np.zeros((0, 3), np.int64)
    return np.concatenate(out_cells), np.concatenate(out_tris)


def lewiner_cells(cell_origins, cell_values, spacing: float = 1.0):
    """Triangulate the zero level set with the exact Lewiner-33 tables.

    Same contract as :func:`.table_mc.marching_cubes_cells`.
    """
    m = len(cell_origins)
    if m == 0:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    origins = np.asarray(cell_origins, np.int64)
    vals = np.asarray(cell_values, np.float64)
    lv = vals[:, _L2MY]  # Lewiner corner order

    bits = ((lv > 0).astype(np.int64) * (1 << np.arange(8))).sum(axis=1)
    cases = _luts()["CASES"]
    cls = cases[bits, 0]
    cfg = cases[bits, 1]

    f_cell, f_vids = _dispatch(lv, cls, cfg)  # (F,), (F, 3)
    if len(f_cell) == 0:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)

    # ---- global vertex keys: shared edges dedupe across cells; the v12
    # center vertex belongs to exactly one cell
    span = int(origins.max() + 2)
    is_center = f_vids == 12  # (F, 3)
    edge_ids = np.where(is_center, 0, f_vids)

    o = origins[f_cell]  # (F, 3)
    low = o[:, None, :] + _EDGE_LOW[edge_ids]  # (F, 3, 3)
    axis = _EDGE_AXIS[edge_ids]
    ekey = ((low[..., 0] * span + low[..., 1]) * span + low[..., 2]) * 3 + axis
    ckey = (
        3 * span**3
        + (o[:, 0] * span + o[:, 1]) * span + o[:, 2]
    )
    key = np.where(is_center, ckey[:, None], ekey)

    uniq, inverse = np.unique(key.reshape(-1), return_inverse=True)
    faces = inverse.reshape(-1, 3)

    # first face-slot referencing each unique vertex defines it
    flat = key.reshape(-1)
    first = np.full(len(uniq), len(flat), np.int64)
    np.minimum.at(first, inverse, np.arange(len(flat)))
    fi, fj = first // 3, first % 3
    src_cell = f_cell[fi]
    src_vid = f_vids[fi, fj]

    verts = np.zeros((len(uniq), 3), np.float64)

    # edge vertices: inverse-|value| weighted endpoint average (identical
    # to linear zero-crossing interpolation on cut edges, ``pyx:640-665``)
    em = src_vid < 12
    if em.any():
        e = src_vid[em]
        cell = src_cell[em]
        pa_l, pb_l = _EDGE_L[e, 0], _EDGE_L[e, 1]
        va = lv[cell, pa_l]
        vb = lv[cell, pb_l]
        wa = 1.0 / (FLT_EPS + np.abs(va))
        wb = 1.0 / (FLT_EPS + np.abs(vb))
        oa = _OFF_L[pa_l].astype(np.float64)
        ob = _OFF_L[pb_l].astype(np.float64)
        pos = (oa * wa[:, None] + ob * wb[:, None]) / (wa + wb)[:, None]
        verts[em] = origins[cell].astype(np.float64) + pos

    # center vertices: weighted average of the 8 corners (``pyx:807-840``)
    cm = ~em
    if cm.any():
        cell = src_cell[cm]
        w = 1.0 / (FLT_EPS + np.abs(lv[cell]))  # (k, 8)
        pos = (w[:, :, None] * _OFF_L[None].astype(np.float64)).sum(1)
        pos /= w.sum(1)[:, None]
        verts[cm] = origins[cell].astype(np.float64) + pos

    # orientation: the raw Lewiner table winding already yields normals
    # pointing from the negative region toward the positive — this
    # package's convention (verified against table_mc on sphere fields)

    good = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    return verts * spacing, faces[good]
