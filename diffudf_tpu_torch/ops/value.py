"""SIREN value f(x) for the sphere-trace march: the kernel K4 and its plain
version.

K4 (``csrc/value.cu``) replaces ``diffudf_tpu/ops/pallas_value.py::
_value_kernel``.  :func:`value` is its wrapper: on a CUDA tensor it launches
the kernel (and raises on any input the kernel does not take); on a CPU
tensor it runs :func:`value_reference`, the kernel's arithmetic in torch —
the same ``fast_sin``, a float32 first layer, and with ``compute_dtype=
torch.bfloat16`` the same bf16 rounding of the hidden and head operands with
float32 sums and biases.  The kernel takes its weights as :func:`prepare`
lays them out (in the bf16 mode W in bf16 B-fragment order): the march does
that once per trace and passes them to every launch; :func:`value` without
them prepares them itself, as ``value_pallas`` casts its weights.

The library is built from source with ``nvcc`` at first use (:func:`build`)
into the ignored build directory and bound with ``ctypes``.  ``launches``
counts kernel launches, ``points`` the rows they evaluated and
``launches_at`` the launches by row count, so a run can show that its march
went through the kernel and split its time by bucket.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from dataclasses import dataclass

import torch

from ..fields.siren import SirenSpec
from ..native.build import build_shared
from . import kernel_io as kio
from .sincos import fast_sin

_SOURCES = kio.sources("value.cu", "siren_fwd.cuh", "siren_tile.cuh", "sincos.cuh")
_P = ctypes.c_void_p
# (x, n, w1, b1, w, bh, n_mm, wl, bl, w0, ww, h, mixed, tile, grid, out, stream)
_ARGTYPES = [_P, ctypes.c_int, _P, _P, _P, _P, ctypes.c_int, _P, _P,
             ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, _P, _P]

# K4 launches, the points they evaluated, and the launches by point count,
# since the counts were last set to 0
launches = 0
points = 0
launches_at = collections.Counter()


def build() -> str:
    """Build K4's library if needed; -> its path."""
    return build_shared("value", kio.nvcc_command(), _SOURCES)


@functools.cache
def _lib():
    lib = ctypes.CDLL(build())
    lib.value_launch.argtypes = _ARGTYPES
    lib.value_launch.restype = ctypes.c_int
    lib.value_smem.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.value_smem.restype = ctypes.c_int
    return lib


def _mixed(compute_dtype) -> bool:
    if compute_dtype is None or compute_dtype == torch.float32:
        return False
    if compute_dtype == torch.bfloat16:
        return True
    raise ValueError(f"compute_dtype must be None, float32 or bfloat16, got {compute_dtype}")


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 and back to its own type."""
    return t.to(torch.bfloat16).to(t.dtype)


def value_reference(params, spec: SirenSpec, x: torch.Tensor, compute_dtype=None):
    """K4's arithmetic in torch: f (N,).  Run it with TF32 off."""
    kio.check_spec(spec)
    rnd = _bf16 if _mixed(compute_dtype) else (lambda t: t)
    w0, ww = kio.freqs(spec)
    a = fast_sin(w0 * (x @ params[0]["w"] + params[0]["b"]))
    for layer in params[1:-1]:
        a = fast_sin(ww * (rnd(a) @ rnd(layer["w"]) + layer["b"]))
    return (rnd(a) @ rnd(params[-1]["w"]))[:, 0] + params[-1]["b"][0]


@dataclass(frozen=True)
class ValueWeights:
    """K4's operands of one net in one mode, contiguous on ``device``: w1,
    b1, bh, bl float32; ``w`` the hidden layers' W, (n_mm, h, h) float32,
    or in the bf16 mode their bf16 fragments (:func:`kernel_io.
    value_fragments`); ``wl`` W_last in float32, in the bf16 mode rounded to
    bf16."""

    mixed: bool
    device: torch.device
    w1: torch.Tensor
    b1: torch.Tensor
    w: torch.Tensor
    bh: torch.Tensor
    wl: torch.Tensor
    bl: torch.Tensor


def prepare(params, spec: SirenSpec, compute_dtype=None) -> ValueWeights:
    """Lay the params out for K4 in the mode of ``compute_dtype``: the
    stacking, bf16 cast and fragment order that a launch would otherwise
    repeat.  Raises ValueError on a net the kernel does not take."""
    kio.check_spec(spec)
    kio.check_width(spec, "value")
    mixed = _mixed(compute_dtype)
    dev = params[0]["w"].device
    w1, b1, wh, bh, wl, bl = kio.weights(params, dev)
    if mixed:
        if len(params) > 2:
            wh = kio.value_fragments(wh.to(torch.bfloat16))
        wl = _bf16(wl)
    return ValueWeights(mixed=mixed, device=dev, w1=w1, b1=b1, w=wh, bh=bh, wl=wl, bl=bl)


@functools.lru_cache(maxsize=64)
def _plan(spec: SirenSpec, n: int, mixed: bool, device: torch.device) -> kio.ValuePlan:
    return kio.value_plan(spec, n, mixed,
                          torch.cuda.get_device_properties(device).multi_processor_count)


def value(params, spec: SirenSpec, x: torch.Tensor, compute_dtype=None,
          weights: ValueWeights | None = None):
    """f (N,) of a uniform-width sine SIREN at x (N, 3).

    A CUDA ``x`` goes to K4; a CPU ``x`` to :func:`value_reference`.
    ``compute_dtype=torch.bfloat16`` selects the mixed mode.  ``weights``:
    the params as :func:`prepare` laid them out for this mode (None:
    prepared here).  Raises ValueError on inputs the kernel does not take
    and RuntimeError when the launch fails."""
    global launches, points
    kio.check_spec(spec)
    kio.check_points(x, "value")
    mixed = _mixed(compute_dtype)
    if x.device.type == "cpu":
        return value_reference(params, spec, x, compute_dtype)
    dev = x.device
    x = kio.operand(x, dev, "x")
    kio.check_width(spec, "value")
    lib = _lib()
    wt = prepare(params, spec, compute_dtype) if weights is None else weights
    if wt.mixed != mixed or wt.device != dev:
        raise ValueError(f"value: weights prepared for mixed={wt.mixed} on {wt.device}, "
                         f"asked for mixed={mixed} on {dev}")
    n = x.shape[0]
    out = torch.empty(n, device=dev, dtype=torch.float32)
    if n == 0:
        return out
    plan = _plan(spec, n, mixed, dev)
    w0, ww = kio.freqs(spec)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.value_launch(x.data_ptr(), n, wt.w1.data_ptr(), wt.b1.data_ptr(),
                              wt.w.data_ptr(), wt.bh.data_ptr(), plan.n_mm, wt.wl.data_ptr(),
                              wt.bl.data_ptr(), float(w0), float(ww), plan.h, int(mixed),
                              plan.tile, plan.grid, out.data_ptr(), stream)
    if rc:
        raise RuntimeError(f"value kernel launch failed with CUDA error {rc}")
    launches += 1
    points += n
    launches_at[n] += 1
    return out
