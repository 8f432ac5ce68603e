"""ctypes binding for the native sign-voting module.

The C++ source is ``native/udf_mc/udf_mc.cpp`` (a copy of the JAX package's).
The first call builds it with ``g++`` into the ignored build directory
(:mod:`.build`); a failed build raises.  No prebuilt library is loaded.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

from .build import build_shared

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "udf_mc", "udf_mc.cpp")
_CMD = ["g++", "-O3", "-shared", "-fPIC"]


def build() -> str:
    """Build the library if needed; -> its path."""
    return build_shared("udf_mc", _CMD, [_SRC])


@functools.cache
def _lib():
    lib = ctypes.CDLL(build())
    fp = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i8p = ctypes.POINTER(ctypes.c_int8)
    lib.sign_voting.argtypes = [
        fp,
        u8p,
        fp, fp, fp,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        i8p,
    ]
    lib.sign_voting.restype = None
    lib.vote_bfs.argtypes = [
        fp, fp,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_int32,
        u8p, i8p, u8p,
    ]
    lib.vote_bfs.restype = None
    return lib


def sign_voting(udf: np.ndarray, participate: np.ndarray,
                wx: np.ndarray, wy: np.ndarray, wz: np.ndarray):
    """Spanning-forest sign propagation over precomputed edge weights.

    wx/wy/wz: signed per-edge weights for the +x/+y/+z edge families
    (sign = relation, magnitude = confidence), shapes (N0-1,N1,N2) /
    (N0,N1-1,N2) / (N0,N1,N2-1).
    -> int8 (N0, N1, N2) array of +1/-1 pseudo-signs.
    """
    udf = np.ascontiguousarray(udf, np.float32)
    part = np.ascontiguousarray(participate, np.uint8)
    wx = np.ascontiguousarray(wx, np.float32)
    wy = np.ascontiguousarray(wy, np.float32)
    wz = np.ascontiguousarray(wz, np.float32)
    n0, n1, n2 = udf.shape
    if (part.shape != udf.shape or wx.shape != (n0 - 1, n1, n2)
            or wy.shape != (n0, n1 - 1, n2) or wz.shape != (n0, n1, n2 - 1)):
        raise ValueError("sign_voting: participate / edge-weight shapes do not match udf")
    out = np.empty((n0, n1, n2), np.int8)
    fp = ctypes.POINTER(ctypes.c_float)
    _lib().sign_voting(
        udf.ctypes.data_as(fp),
        part.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        wx.ctypes.data_as(fp), wy.ctypes.data_as(fp), wz.ctypes.data_as(fp),
        n0, n1, n2,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
    )
    return out


def vote_bfs(udf: np.ndarray, dirs: np.ndarray, voxel: float,
             avg_thresh: float = 1.05, max_thresh: float = 1.75,
             unsure_thresh: float = 0.707, support_min: int = 2):
    """Reference-semantics voted-sign BFS with deferred queues.

    udf: (N0, N1, N2) non-negative pseudo distances; dirs: (N0, N1, N2, 3)
    direction field pointing toward the surface.  Thresholds are in voxels
    (reference defaults, ``_marching_cubes_lewiner.py:80``).

    -> (signs int8 (N0, N1, N2) with 0 where never reached,
        emit uint8 (N0-1, N1-1, N2-1) cells that should produce faces).
    """
    from ..extract.mc_tables import TRIVIAL_CASE

    udf = np.ascontiguousarray(udf, np.float32)
    dirs = np.ascontiguousarray(dirs, np.float32)
    n0, n1, n2 = udf.shape
    if dirs.shape != (n0, n1, n2, 3):
        raise ValueError(f"vote_bfs: dirs shape {dirs.shape} does not match udf {udf.shape}")
    trivial = np.ascontiguousarray(TRIVIAL_CASE, np.uint8)
    signs = np.empty((n0, n1, n2), np.int8)
    emit = np.empty((n0 - 1, n1 - 1, n2 - 1), np.uint8)
    fp = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    _lib().vote_bfs(
        udf.ctypes.data_as(fp), dirs.ctypes.data_as(fp),
        n0, n1, n2,
        ctypes.c_float(voxel), ctypes.c_float(avg_thresh),
        ctypes.c_float(max_thresh), ctypes.c_float(unsure_thresh),
        support_min,
        trivial.ctypes.data_as(u8p),
        signs.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        emit.ctypes.data_as(u8p),
    )
    return signs, emit
