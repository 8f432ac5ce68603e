"""Fused SIREN value + gradient: the forward kernel K3a, its hand-derived
VJP K3b, and the autograd op that pairs them.

Both kernels are in ``csrc/vg.cu``: K3a (on ``csrc/siren_fwd.cuh``, the
forward tile design of K1 with 3xTF32 tensor-core products) replaces ``diffudf_tpu/ops/pallas_vg.py::
_vg_fwd_kernel`` and K3b (on ``csrc/siren_bwd.cuh``, the backward design of
K2) ``_vg_bwd_kernel``.  :func:`vg` and
:func:`vg_bwd` are their wrappers: on a CUDA tensor they launch the kernel
(and raise on any input the kernel does not take); on a CPU tensor they run
the plain torch versions :func:`vg_reference` and :func:`vg_bwd_reference`,
the kernels' arithmetic — the same ``fast_sincos``, the same four-row carry
[a; J0; J1; J2], and for K3b the hand-derived backward of
``pallas_vg.py:93-183``, not autograd.  :class:`VgOp` is the
``torch.autograd.Function`` of ``make_vg_op``.

The library is built from source with ``nvcc`` at first use (:func:`build`)
into the ignored build directory and bound with ``ctypes``.  ``launches``
(K3a) and ``bwd_launches`` (K3b) count kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..fields.siren import SirenSpec
from ..native.build import build_shared
from . import kernel_io as kio
from .sincos import fast_sincos

_SOURCES = kio.sources("vg.cu", "siren_fwd.cuh", "siren_bwd.cuh", "siren_tile.cuh",
                       "sincos.cuh")

# kernel launches since the counts were last set to 0: K3a, K3b
launches = 0
bwd_launches = 0


def build() -> str:
    """Build the K3a/K3b library if needed; -> its path."""
    return build_shared("vg", kio.nvcc_command(), _SOURCES)


@functools.cache
def _lib():
    lib = ctypes.CDLL(build())
    lib.vg_launch.argtypes = kio.FWD_ARGTYPES
    lib.vg_launch.restype = ctypes.c_int
    lib.vg_bwd_launch.argtypes = kio.BWD_ARGTYPES
    lib.vg_bwd_launch.restype = ctypes.c_int
    lib.vg_tile.argtypes = []
    lib.vg_tile.restype = ctypes.c_int
    return lib


def _forward(params, spec, x):
    """The four-row Taylor-mode forward: -> (carries, d1s, d2s), where
    carries[l] is the (4N, h) input of product l and carries[-1] the head's."""
    w0, ww = kio.freqs(spec)
    n = x.shape[0]
    w1 = params[0]["w"]
    z = x @ w1 + params[0]["b"]
    s, c = fast_sincos(w0 * z)
    d1 = w0 * c
    carry = torch.cat([s] + [d1 * w1[k] for k in range(3)], dim=0)  # (4N, h)
    carr, d1s, d2s = [carry], [d1], [-(w0 * w0) * s]
    for layer in params[1:-1]:
        m = carry @ layer["w"]
        s, c = fast_sincos(ww * (m[:n] + layer["b"]))
        d1 = ww * c
        carry = torch.cat([s] + [d1 * m[(1 + k) * n:(2 + k) * n] for k in range(3)], dim=0)
        carr.append(carry)
        d1s.append(d1)
        d2s.append(-(ww * ww) * s)
    return carr, d1s, d2s


def vg_reference(params, spec: SirenSpec, x: torch.Tensor):
    """K3a's arithmetic in torch: (f (N,), g (N, 3))."""
    kio.check_spec(spec)
    n = x.shape[0]
    carry = _forward(params, spec, x)[0][-1]
    out = (carry @ params[-1]["w"])[:, 0].reshape(4, n)
    return out[0] + params[-1]["b"][0], out[1:4].T


def vg_bwd_reference(params, spec: SirenSpec, x: torch.Tensor, cot: torch.Tensor):
    """K3b's arithmetic in torch, term for term that of
    ``pallas_vg.py::_vg_bwd_kernel`` over one tile of all N rows.

    cot (N, 8) = (f̄ | ḡ | 0).  -> the gradient of ``sum(cot[:, :4] * (f | g))``
    as a list of ``{'w', 'b'}``."""
    kio.check_spec(spec)
    _, ww = kio.freqs(spec)
    n = x.shape[0]
    hidden = params[1:-1]
    carr, d1s, d2s = _forward(params, spec, x)

    # head
    wl_row = params[-1]["w"][:, 0]
    head_in = carr[-1]
    carrybar = torch.cat([cot[:, k:k + 1] * wl_row for k in range(4)], dim=0)
    wlbar = cot[:, 0] @ head_in[0:n]
    for k in range(1, 4):
        wlbar = wlbar + cot[:, k] @ head_in[k * n:(k + 1) * n]
    grads = [None] * len(params)
    grads[-1] = {"w": wlbar[:, None], "b": cot[:, 0].sum()[None]}

    # hidden layers, last to first
    for l in reversed(range(len(hidden))):
        w = hidden[l]["w"]
        carry_in = carr[l]
        m = carry_in @ w
        d1, d2 = d1s[l + 1], d2s[l + 1]
        jz = [m[(1 + k) * n:(2 + k) * n] for k in range(3)]
        ab = carrybar[0:n]
        jb = [carrybar[(1 + k) * n:(2 + k) * n] for k in range(3)]
        zbar = d1 * ab + d2 * (jb[0] * jz[0] + jb[1] * jz[1] + jb[2] * jz[2])
        mbar = torch.cat([zbar] + [d1 * jb[k] for k in range(3)], dim=0)
        grads[l + 1] = {"w": carry_in.T @ mbar, "b": zbar.sum(0)}
        carrybar = mbar @ w.T

    # first layer, with the direct dependence of J1 on the rows of W1
    d1, d2 = d1s[0], d2s[0]
    w1 = params[0]["w"]
    ab = carrybar[0:n]
    jb = [carrybar[(1 + k) * n:(2 + k) * n] for k in range(3)]
    zbar1 = d1 * ab + d2 * sum(jb[k] * w1[k] for k in range(3))
    direct = torch.stack([(jb[k] * d1).sum(0) for k in range(3)])
    grads[0] = {"w": x.T @ zbar1 + direct, "b": zbar1.sum(0)}
    return grads


def vg(params, spec: SirenSpec, x: torch.Tensor):
    """Fused (f (N,), g (N, 3)) of a uniform-width sine SIREN.

    A CUDA ``x`` goes to K3a; a CPU ``x`` to :func:`vg_reference`.  Raises
    ValueError on inputs the kernel does not take and RuntimeError when the
    launch fails."""
    global launches
    kio.check_spec(spec)
    kio.check_points(x, "vg")
    if x.device.type == "cpu":
        return vg_reference(params, spec, x)
    x = kio.operand(x, x.device, "x")
    lib = _lib()
    kio.check_width(spec, "vg")
    out = torch.empty((x.shape[0], 8), device=x.device, dtype=torch.float32)
    if x.shape[0]:
        kio.launch_forward(lib.vg_launch, lib.vg_tile(), True, params, spec, x, out)
        launches += 1
    return out[:, 0], out[:, 1:4]


def vg_bwd(params, spec: SirenSpec, x: torch.Tensor, cot: torch.Tensor):
    """Gradient of ``sum(cot[:, :4] * (f | g))`` with respect to the params;
    cot (N, 8) packed as ``make_vg_op`` packs it.

    A CUDA ``x`` goes to K3b; a CPU ``x`` to :func:`vg_bwd_reference`."""
    global bwd_launches
    kio.check_spec(spec)
    kio.check_points(x, "vg_bwd")
    if cot.shape != (x.shape[0], 8):
        raise ValueError(f"vg_bwd: cot must be ({x.shape[0]}, 8), got {tuple(cot.shape)}")
    if x.device.type == "cpu":
        return vg_bwd_reference(params, spec, x, cot)
    x = kio.operand(x, x.device, "x")
    cot = kio.operand(cot, x.device, "cot")
    lib = _lib()
    kio.check_width(spec, "vg_bwd")
    grads = kio.launch_backward(lib.vg_bwd_launch, lib.vg_tile(), 4, params, spec, x, cot)
    bwd_launches += int(x.shape[0] > 0)
    return grads


class VgOp(torch.autograd.Function):
    """``make_vg_op``: (f, g) by K3a, param gradients by K3b (or their plain
    versions on the CPU).  ``x`` is data: it gets no gradient."""

    @staticmethod
    def forward(ctx, spec, x, *leaves):
        ctx.spec = spec
        ctx.save_for_backward(x, *leaves)
        f, g = vg(kio.params_from_leaves(leaves), spec, x)
        return f.contiguous(), g.contiguous()

    @staticmethod
    def backward(ctx, fbar, gbar):
        x, *leaves = ctx.saved_tensors
        n = x.shape[0]
        cot = torch.cat([fbar[:, None], gbar, fbar.new_zeros((n, 4))], dim=1)
        grads = vg_bwd(kio.params_from_leaves(leaves), ctx.spec, x, cot.contiguous())
        return (None, None) + kio.param_leaves(grads)


def vg_op(params, spec: SirenSpec, x: torch.Tensor):
    """(f, g) through :class:`VgOp`: differentiable in ``params``."""
    return VgOp.apply(spec, x, *kio.param_leaves(params))
