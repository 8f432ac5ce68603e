"""SIREN value f(x) for the sphere-trace march: the kernel K4 and its plain
version.

K4 (``csrc/value.cu``) replaces ``diffudf_tpu/ops/pallas_value.py::
_value_kernel``.  :func:`value` is its wrapper: on a CUDA tensor it launches
the kernel (and raises on any input the kernel does not take); on a CPU
tensor it runs :func:`value_reference`, the kernel's arithmetic in torch —
the same ``fast_sin``, a float32 first layer, and with ``compute_dtype=
torch.bfloat16`` the same bf16 rounding of the hidden and head operands with
float32 sums and biases.  The wrapper casts the weights to bf16 itself, as
``value_pallas`` does.

The library is built from source with ``nvcc`` at first use (:func:`build`)
into the ignored build directory and bound with ``ctypes``.  ``launches``
counts kernel launches and ``points`` the rows they evaluated, so a run can
show that its march went through the kernel and split its time.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..fields.siren import SirenSpec
from ..native.build import build_shared
from . import kernel_io as kio
from .sincos import fast_sin

_SOURCES = kio.sources("value.cu", "sincos.cuh")
_P = ctypes.c_void_p
# (x, n, w1, b1, wh, bh, n_mm, wl, bl, w0, ww, h, mixed, out, stream)
_ARGTYPES = [_P, ctypes.c_int, _P, _P, _P, _P, ctypes.c_int, _P, _P,
             ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int, _P, _P]

# K4 launches, and the points they evaluated, since the counts were last set to 0
launches = 0
points = 0


def build() -> str:
    """Build K4's library if needed; -> its path."""
    return build_shared("value", kio.nvcc_command(), _SOURCES)


@functools.cache
def _lib():
    lib = ctypes.CDLL(build())
    lib.value_launch.argtypes = _ARGTYPES
    lib.value_launch.restype = ctypes.c_int
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


def value(params, spec: SirenSpec, x: torch.Tensor, compute_dtype=None):
    """f (N,) of a uniform-width sine SIREN at x (N, 3).

    A CUDA ``x`` goes to K4; a CPU ``x`` to :func:`value_reference`.
    ``compute_dtype=torch.bfloat16`` selects the mixed mode.  Raises
    ValueError on inputs the kernel does not take and RuntimeError when the
    launch fails."""
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
    w1, b1, wh, bh, wl, bl = kio.weights(params, dev)
    if mixed:
        wh, wl = wh.to(torch.bfloat16), wl.to(torch.bfloat16)
    w0, ww = kio.freqs(spec)
    n = x.shape[0]
    out = torch.empty(n, device=dev, dtype=torch.float32)
    if n == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.value_launch(x.data_ptr(), n, w1.data_ptr(), b1.data_ptr(), wh.data_ptr(),
                              bh.data_ptr(), len(params) - 2, wl.data_ptr(), bl.data_ptr(),
                              float(w0), float(ww), spec.hidden[0], int(mixed),
                              out.data_ptr(), stream)
    if rc:
        raise RuntimeError(f"value kernel launch failed with CUDA error {rc}")
    launches += 1
    points += n
    return out
