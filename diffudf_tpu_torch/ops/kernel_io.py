"""What the SIREN kernel wrappers (:mod:`.vgh`, :mod:`.vg`) share: the
``nvcc`` command, the checks on what the kernels compute, the operands in
the layout the kernels read, and the launch of the backward kernels K2 and
K3b (``csrc/siren_taylor.cuh``) with their workspaces.

Nothing here builds or launches at import time.
"""

from __future__ import annotations

import ctypes
import os
import shutil

import torch

from ..fields.siren import SirenSpec, flat_size, unflatten_params

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")

# widest hidden layer the kernels take: one thread per column (kMaxH in csrc)
MAX_WIDTH = 256

# packed-Hessian component index pairs (must match autodiff.ops)
TRI_I = (0, 0, 0, 1, 1, 2)
TRI_J = (0, 1, 2, 1, 2, 2)

_P = ctypes.c_void_p
# (x, n, w1, b1, wh, bh, n_mm, wl, bl, w0, ww, h, out, stream)
FWD_ARGTYPES = [_P, ctypes.c_int, _P, _P, _P, _P, ctypes.c_int, _P, _P,
                ctypes.c_float, ctypes.c_float, ctypes.c_int, _P, _P]
# (x, cot, n, w1, b1, wh, wht, bh, n_mm, wl, w0, ww, h, grid,
#  ws_carry, ws_m, partial, out, stream)
BWD_ARGTYPES = [_P, _P, ctypes.c_int, _P, _P, _P, _P, _P, ctypes.c_int, _P,
                ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                _P, _P, _P, _P, _P]


def nvcc_command() -> list:
    """nvcc for Hopper into a shared library, with the ptxas report."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    return [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
            "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", CSRC]


def sources(*names) -> list:
    """Paths of ``csrc`` files: the compiled source first, then its headers."""
    return [os.path.join(CSRC, n) for n in names]


def kernel_spec_ok(spec: SirenSpec) -> bool:
    """Whether the SIREN kernels take ``spec``: a sine SIREN from R³ to R
    with one hidden width, a multiple of 32 and at most ``MAX_WIDTH``.
    Selectors send every other net to the plain torch path."""
    h = spec.hidden[0] if spec.hidden else 0
    return (
        spec.activation == "sine"
        and spec.n_in == 3
        and spec.n_out == 1
        and len(set(spec.hidden)) == 1
        and h % 32 == 0
        and 0 < h <= MAX_WIDTH
    )


def check_spec(spec: SirenSpec):
    """Raise ValueError unless the kernels' math covers ``spec``: a
    uniform-width sine SIREN from R³ to R."""
    if len(set(spec.hidden)) != 1:
        raise ValueError("SIREN kernels require uniform hidden width")
    if spec.activation != "sine" or spec.n_in != 3 or spec.n_out != 1:
        raise ValueError("SIREN kernels require a sine SIREN from R^3 to R")


def freqs(spec):
    """(first-layer w0, hidden ww)."""
    f = spec.freqs
    return f[0], (f[1] if len(f) > 1 else f[0])


def operand(t: torch.Tensor, device, name: str) -> torch.Tensor:
    if t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 tensor on {device}")
    return t


def check_points(x: torch.Tensor, name: str):
    if x.ndim != 2 or x.shape[1] != 3:
        raise ValueError(f"{name}: x must be (N, 3), got {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {x.device}")


def check_width(spec: SirenSpec, name: str):
    h = spec.hidden[0]
    if h % 32 or h > MAX_WIDTH:
        raise ValueError(f"{name}: hidden width {h} must be a multiple of 32 "
                         f"and at most {MAX_WIDTH}")


def weights(params, device):
    """(w1, b1, wh, bh, wl, bl) as the kernels read them; wh and bh stack the
    hidden layers (a placeholder when there are none: never read)."""
    w1 = operand(params[0]["w"], device, "W1")
    b1 = operand(params[0]["b"], device, "b1")
    wl = operand(params[-1]["w"], device, "W_last")
    bl = operand(params[-1]["b"], device, "b_last")
    hidden = params[1:-1]
    if hidden:
        wh = torch.stack([operand(p["w"], device, "W") for p in hidden])
        bh = torch.stack([operand(p["b"], device, "b") for p in hidden])
    else:
        wh = bh = b1
    return w1, b1, wh, bh, wl, bl


def launch_forward(fn, params, spec, x, out):
    """Call a forward launcher (K1 or K3a) on the current stream; raise on a
    CUDA error."""
    dev = x.device
    w1, b1, wh, bh, wl, bl = weights(params, dev)
    w0, ww = freqs(spec)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(x.data_ptr(), x.shape[0], w1.data_ptr(), b1.data_ptr(), wh.data_ptr(),
                bh.data_ptr(), len(params) - 2, wl.data_ptr(), bl.data_ptr(), float(w0),
                float(ww), spec.hidden[0], out.data_ptr(), stream)
    if rc:
        raise RuntimeError(f"kernel launch failed with CUDA error {rc}")


def launch_backward(fn, tile: int, rows: int, params, spec, x, cot):
    """Call a backward launcher (K2 or K3b) and return the gradient as a
    list of ``{'w', 'b'}`` views of one flat tensor (ravel_pytree layout).

    The grid is persistent: one CTA per SM at most, each with its own
    workspace of ``2 * n_hidden * rows * tile * h`` floats and its own
    partial gradient, which the launcher then adds up in a fixed order."""
    dev = x.device
    h, n = spec.hidden[0], x.shape[0]
    out = torch.empty(flat_size(spec), device=dev, dtype=torch.float32)
    n_tiles = -(-n // tile)
    if n_tiles == 0:
        return unflatten_params(out.zero_(), spec)
    w1, b1, wh, bh, wl, _ = weights(params, dev)
    n_mm = len(params) - 2
    wht = wh.transpose(1, 2).contiguous() if n_mm else wh
    w0, ww = freqs(spec)
    grid = min(torch.cuda.get_device_properties(dev).multi_processor_count, n_tiles)
    ws_carry = torch.empty(grid * n_mm * rows * tile * h, device=dev, dtype=torch.float32)
    ws_m = torch.empty_like(ws_carry)
    partial = torch.empty(grid * out.numel(), device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(x.data_ptr(), cot.data_ptr(), n, w1.data_ptr(), b1.data_ptr(),
                wh.data_ptr(), wht.data_ptr(), bh.data_ptr(), n_mm, wl.data_ptr(),
                float(w0), float(ww), h, grid, ws_carry.data_ptr(), ws_m.data_ptr(),
                partial.data_ptr(), out.data_ptr(), stream)
    if rc:
        raise RuntimeError(f"backward kernel launch failed with CUDA error {rc}")
    return unflatten_params(out, spec)


def param_leaves(params):
    """The params as one tuple of tensors, layer by layer (w, b)."""
    return tuple(t for layer in params for t in (layer["w"], layer["b"]))


def params_from_leaves(leaves):
    return [{"w": leaves[i], "b": leaves[i + 1]} for i in range(0, len(leaves), 2)]
