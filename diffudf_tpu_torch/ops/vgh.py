"""Fused SIREN value + gradient + packed Hessian (K1): CUDA kernel, wrapper
and plain torch version.

The kernel (``csrc/vgh.cu``) replaces ``diffudf_tpu/ops/pallas_vgh.py::
_vgh_kernel``.  :func:`vgh` is its wrapper: on a CUDA tensor it launches the
kernel (and raises on any input the kernel does not take); on a CPU tensor it
runs :func:`vgh_reference`, the kernel's arithmetic in torch — the same
``fast_sincos``, the same row-stacked carry, the same packed output.

The library is built from source with ``nvcc`` at first use (``build()``)
into the ignored build directory and bound with ``ctypes``.  ``launches``
counts kernel launches, so a run can show that its path went through the
kernel.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil

import torch

from ..fields.siren import SirenSpec
from ..native.build import build_shared
from .sincos import fast_sincos

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
_SOURCES = [os.path.join(_CSRC, "vgh.cu"), os.path.join(_CSRC, "sincos.cuh")]

# packed-Hessian component index pairs (must match autodiff.ops)
_TRI_I = (0, 0, 0, 1, 1, 2)
_TRI_J = (0, 1, 2, 1, 2, 2)

# kernel launches since the count was last set to 0
launches = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")


def _cmd():
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
            "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", _CSRC]


def build() -> str:
    """Build the kernel library if needed; -> its path."""
    return build_shared("vgh", _cmd(), _SOURCES)


@functools.cache
def _lib():
    lib = ctypes.CDLL(build())
    p = ctypes.c_void_p
    lib.vgh_launch.argtypes = [p, ctypes.c_int, p, p, p, p, ctypes.c_int, p, p,
                               ctypes.c_float, ctypes.c_float, ctypes.c_int, p, p]
    lib.vgh_launch.restype = ctypes.c_int
    lib.vgh_max_width.argtypes = []
    lib.vgh_max_width.restype = ctypes.c_int
    return lib


def check_spec(spec: SirenSpec):
    """Raise ValueError unless the kernel's math covers ``spec``: a
    uniform-width sine SIREN from R³ to R."""
    if len(set(spec.hidden)) != 1:
        raise ValueError("vgh kernel requires uniform hidden width")
    if spec.activation != "sine" or spec.n_in != 3 or spec.n_out != 1:
        raise ValueError("vgh kernel requires a sine SIREN from R^3 to R")


def _freqs(spec):
    freqs = spec.freqs
    return freqs[0], (freqs[1] if len(freqs) > 1 else freqs[0])


def vgh_reference(params, spec: SirenSpec, x: torch.Tensor):
    """The kernel's arithmetic in torch: (f (N,), g (N, 3), h6 (N, 6))."""
    check_spec(spec)
    w0, ww = _freqs(spec)
    n = x.shape[0]
    w1 = params[0]["w"]
    z = x @ w1 + params[0]["b"]
    s, c = fast_sincos(w0 * z)
    d1 = w0 * c
    d2 = -(w0 * w0) * s
    rows = [s] + [d1 * w1[k] for k in range(3)]
    rows += [d2 * (w1[i] * w1[j]) for i, j in zip(_TRI_I, _TRI_J)]
    carry = torch.cat(rows, dim=0)  # (10N, h): [a; J0..J2; H0..H5]
    for layer in params[1:-1]:
        m = carry @ layer["w"]
        s, c = fast_sincos(ww * (m[:n] + layer["b"]))
        d1 = ww * c
        d2 = -(ww * ww) * s
        jz = [m[(1 + k) * n:(2 + k) * n] for k in range(3)]
        rows = [s] + [d1 * jk for jk in jz]
        for k, (i, j) in enumerate(zip(_TRI_I, _TRI_J)):
            rows.append(d1 * m[(4 + k) * n:(5 + k) * n] + d2 * (jz[i] * jz[j]))
        carry = torch.cat(rows, dim=0)
    out = (carry @ params[-1]["w"])[:, 0].reshape(10, n)
    return out[0] + params[-1]["b"][0], out[1:4].T, out[4:10].T


def _operand(t: torch.Tensor, device, name: str) -> torch.Tensor:
    if t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"vgh: {name} must be a contiguous float32 tensor on {device}")
    return t


def vgh(params, spec: SirenSpec, x: torch.Tensor):
    """Fused (f (N,), g (N, 3), h6 (N, 6)) of a uniform-width sine SIREN.

    A CUDA ``x`` goes to the kernel; a CPU ``x`` to :func:`vgh_reference`.
    Raises ValueError on inputs the kernel does not take and RuntimeError
    when the launch fails.
    """
    global launches
    check_spec(spec)
    if x.ndim != 2 or x.shape[1] != 3:
        raise ValueError(f"vgh: x must be (N, 3), got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return vgh_reference(params, spec, x)
    if x.device.type != "cuda":
        raise ValueError(f"vgh: no kernel for device {x.device}")
    dev = x.device
    x = _operand(x, dev, "x")
    h = spec.hidden[0]
    lib = _lib()
    if h % 32 or h > lib.vgh_max_width():
        raise ValueError(f"vgh: hidden width {h} must be a multiple of 32 "
                         f"and at most {lib.vgh_max_width()}")
    n = x.shape[0]
    w1 = _operand(params[0]["w"], dev, "W1")
    b1 = _operand(params[0]["b"], dev, "b1")
    wl = _operand(params[-1]["w"], dev, "W_last")
    bl = _operand(params[-1]["b"], dev, "b_last")
    hidden = params[1:-1]
    if hidden:
        wh = torch.stack([_operand(p["w"], dev, "W") for p in hidden])
        bh = torch.stack([_operand(p["b"], dev, "b") for p in hidden])
    else:
        wh = bh = b1  # never read: the kernel runs no hidden product
    w0, ww = _freqs(spec)
    out = torch.empty((n, 16), device=dev, dtype=torch.float32)
    if n == 0:
        return out[:, 0], out[:, 1:4], out[:, 4:10]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.vgh_launch(
            x.data_ptr(), n, w1.data_ptr(), b1.data_ptr(), wh.data_ptr(), bh.data_ptr(),
            len(hidden), wl.data_ptr(), bl.data_ptr(), float(w0), float(ww), h,
            out.data_ptr(), stream)
    if rc:
        raise RuntimeError(f"vgh kernel launch failed with CUDA error {rc}")
    launches += 1
    return out[:, 0], out[:, 1:4], out[:, 4:10]
