"""Brute nearest-point distance from queries to a point cloud: the kernel K5
and its plain version.

K5 (``csrc/min_distance.cu``) replaces ``diffudf_tpu/ops/pallas_distance.py::
_min_dist_kernel``.  :func:`min_distance` is its wrapper: on a CUDA tensor
it launches the kernel (and raises on any input the kernel does not take);
on a CPU tensor it runs :func:`min_distance_reference`, the kernel's
arithmetic in torch.

Both rank the cloud points of each query by K5's expanded form
|c|² − 2q·c (:func:`rank_reference`), in float32 with TF32 off, and return
the exact distance |q − c*| to the lowest-index point of least rank.  K5
itself returns sqrt(min + |q|²), which cancels near the surface (its
float32 error reaches 7.5e-5 on the slice figure's plane queries nearest a
torus cloud, against a 1e-4 tolerance; ``chip_smoke.py`` prints it), so
the argmin is carried through the scan as the JAX package's XLA brute force
does (``data/mesh_distance.py::_min_sq_dist_tile``).  In float64 the plain
version is the witness the kernel is held to.

The wrapper allocates the kernel's workspace, the cloud staged once as
float4 (x, y, z, |c|²) in whole tiles (:func:`workspace_floats`).  The
library is built from source with ``nvcc`` at first use (:func:`build`)
into the ignored build directory and bound with ``ctypes``.  ``launches``
counts kernel launches and ``queries`` the rows they answered.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..native.build import build_shared
from . import kernel_io as kio

CLOUD_CHUNK = 2048  # cloud points a step of the plain version's running minimum
QUERY_TILE = 16384  # queries a step of the plain version: bounds its (tile, chunk) block

_SOURCES = kio.sources("min_distance.cu")
_P = ctypes.c_void_p
# (q, nq, cloud, m, work, out, stream)
_ARGTYPES = [_P, ctypes.c_int64, _P, ctypes.c_int64, _P, _P, _P]

# K5 launches, and the queries they answered, since the counts were last set to 0
launches = 0
queries = 0


def build() -> str:
    """Build K5's library if needed; -> its path."""
    return build_shared("min_distance", kio.nvcc_command(), _SOURCES)


@functools.cache
def _lib():
    lib = ctypes.CDLL(build())
    lib.min_distance_launch.argtypes = _ARGTYPES
    lib.min_distance_launch.restype = ctypes.c_int
    lib.min_distance_tile.argtypes, lib.min_distance_tile.restype = [], ctypes.c_int
    return lib


def workspace_floats(m: int, tile: int) -> int:
    """Floats of K5's workspace for an m-point cloud: the cloud staged as
    float4 (x, y, z, |c|²), padded to whole tiles of ``tile`` points."""
    return 4 * tile * -(-m // tile)


def _check(queries: torch.Tensor, cloud: torch.Tensor):
    for name, t in (("queries", queries), ("cloud", cloud)):
        if t.ndim != 2 or t.shape[1] != 3:
            raise ValueError(f"min_distance: {name} must be (N, 3), got {tuple(t.shape)}")
    if cloud.shape[0] == 0:
        raise ValueError("min_distance: the cloud is empty")
    if queries.device != cloud.device:
        raise ValueError(f"min_distance: queries on {queries.device}, cloud on {cloud.device}")
    if queries.device.type not in ("cpu", "cuda"):
        raise ValueError(f"min_distance: no kernel for device {queries.device}")


def rank_reference(queries: torch.Tensor, cloud: torch.Tensor, chunk: int = CLOUD_CHUNK):
    """-> (least rank (Q,), index of the first point that has it (Q,)): the
    running minimum of |c|² − 2q·c over ``chunk``-point pieces of the cloud.
    Run it with TF32 off."""
    csq = (cloud * cloud).sum(1)
    best = torch.full((queries.shape[0],), float("inf"), dtype=queries.dtype,
                      device=queries.device)
    idx = torch.zeros(queries.shape[0], dtype=torch.int64, device=queries.device)
    for lo in range(0, cloud.shape[0], chunk):
        r = csq[None, lo:lo + chunk] - 2.0 * (queries @ cloud[lo:lo + chunk].T)
        m, i = r.min(1)
        better = m < best  # strict: ties keep the earlier chunk
        best = torch.where(better, m, best)
        idx = torch.where(better, i + lo, idx)
    return best, idx


def min_distance_reference(queries: torch.Tensor, cloud: torch.Tensor):
    """K5's arithmetic in torch: (Q,) distances |q − c*| of each query to its
    least-rank cloud point, in the inputs' type (float64: the witness)."""
    _check(queries, cloud)
    out = []
    for lo in range(0, queries.shape[0], QUERY_TILE):
        q = queries[lo:lo + QUERY_TILE]
        _, idx = rank_reference(q, cloud)
        out.append((q - cloud[idx]).square().sum(1).sqrt())
    return torch.cat(out) if out else queries.new_zeros(0)


def min_distance(q: torch.Tensor, cloud: torch.Tensor) -> torch.Tensor:
    """(Q,) distance from each query q (Q, 3) to the nearest point of the
    cloud (M, 3), both float32 on one device.

    CUDA tensors go to K5; CPU tensors to :func:`min_distance_reference`.
    Raises ValueError on inputs the kernel does not take and RuntimeError
    when the launch fails."""
    global launches, queries
    _check(q, cloud)
    if q.device.type == "cpu":
        return min_distance_reference(q, cloud)
    dev = q.device
    q = kio.operand(q, dev, "queries")
    cloud = kio.operand(cloud, dev, "cloud")
    lib = _lib()
    n = q.shape[0]
    out = torch.empty(n, device=dev, dtype=torch.float32)
    if n == 0:
        return out
    m = cloud.shape[0]
    work = torch.empty(workspace_floats(m, lib.min_distance_tile()), device=dev,
                       dtype=torch.float32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.min_distance_launch(q.data_ptr(), n, cloud.data_ptr(), m, work.data_ptr(),
                                     out.data_ptr(), stream)
    if rc:
        raise RuntimeError(f"min_distance kernel launch failed with CUDA error {rc}")
    launches += 1
    queries += n
    return out
