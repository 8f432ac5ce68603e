"""Fused SIREN value + gradient + packed Hessian: the forward kernel K1, its
hand-derived VJP K2, and the autograd op that pairs them.

K1 (``csrc/vgh.cu`` on ``csrc/siren_fwd.cuh``: a persistent tile kernel
whose products sum in FP32 FMA in the plain version's order) replaces
``diffudf_tpu/ops/pallas_vgh.py::_vgh_kernel``; K2 (``csrc/vgh_bwd.cu`` on
``csrc/siren_bwd.cuh``: 3xTF32 tensor-core products, W-bar as a split-K
product of each layer's carries and m-bars) replaces
``diffudf_tpu/ops/pallas_vgh_vjp.py::_vgh_bwd_kernel``.  :func:`vgh` and
:func:`vgh_bwd` are their wrappers: on a CUDA tensor they launch the kernel
(and raise on any input the kernel does not take); on a CPU tensor they run
the plain torch versions :func:`vgh_reference` and :func:`vgh_bwd_reference`,
the kernels' arithmetic — the same ``fast_sincos``, the same row-stacked
carry, the same packed output, and for K2 the same hand-derived backward.
:class:`VghOp` is the ``torch.autograd.Function`` of ``make_vgh_op``: K1
forward, K2 backward, differentiable with respect to the params only.

The libraries are built from source with ``nvcc`` at first use
(:func:`build`, :func:`build_bwd`) into the ignored build directory and bound
with ``ctypes``.  ``launches`` and ``bwd_launches`` count kernel launches, so
a run can show that its path went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..fields.siren import SirenSpec
from ..native.build import build_shared
from . import kernel_io as kio
from .kernel_io import TRI_I as _TRI_I, TRI_J as _TRI_J, check_spec  # noqa: F401
from .sincos import fast_sincos

_SOURCES = kio.sources("vgh.cu", "siren_fwd.cuh", "siren_tile.cuh", "sincos.cuh")
_BWD_SOURCES = kio.sources("vgh_bwd.cu", "siren_bwd.cuh", "siren_tile.cuh", "sincos.cuh")

# kernel launches since the counts were last set to 0: K1, K2
launches = 0
bwd_launches = 0


def build() -> str:
    """Build K1's library if needed; -> its path."""
    return build_shared("vgh", kio.nvcc_command("vgh.cu"), _SOURCES)


def build_bwd() -> str:
    """Build K2's library if needed; -> its path."""
    return build_shared("vgh_bwd", kio.nvcc_command(), _BWD_SOURCES)


@functools.cache
def _lib():
    lib = ctypes.CDLL(build())
    lib.vgh_launch.argtypes = kio.FWD_ARGTYPES
    lib.vgh_launch.restype = ctypes.c_int
    lib.vgh_tile.argtypes = []
    lib.vgh_tile.restype = ctypes.c_int
    return lib


@functools.cache
def _bwd_lib():
    lib = ctypes.CDLL(build_bwd())
    lib.vgh_bwd_launch.argtypes = kio.BWD_ARGTYPES
    lib.vgh_bwd_launch.restype = ctypes.c_int
    lib.vgh_bwd_tile.argtypes = []
    lib.vgh_bwd_tile.restype = ctypes.c_int
    return lib


def _first_layer(params, spec, x):
    """(d1, d2) of the first layer, and the 10-row carry it starts."""
    w0, _ = kio.freqs(spec)
    w1 = params[0]["w"]
    z = x @ w1 + params[0]["b"]
    s, c = fast_sincos(w0 * z)
    d1 = w0 * c
    d2 = -(w0 * w0) * s
    rows = [s] + [d1 * w1[k] for k in range(3)]
    rows += [d2 * (w1[i] * w1[j]) for i, j in zip(_TRI_I, _TRI_J)]
    return d1, d2, torch.cat(rows, dim=0)  # (10N, h): [a; J0..J2; H0..H5]


def _hidden_layer(layer, ww, carry, n, product=torch.matmul):
    """One hidden layer of the Taylor-mode forward: -> (m, d1, d2, carry')."""
    m = product(carry, layer["w"])
    s, c = fast_sincos(ww * (m[:n] + layer["b"]))
    d1 = ww * c
    d2 = -(ww * ww) * s
    jz = [m[(1 + k) * n:(2 + k) * n] for k in range(3)]
    rows = [s] + [d1 * jk for jk in jz]
    for k, (i, j) in enumerate(zip(_TRI_I, _TRI_J)):
        rows.append(d1 * m[(4 + k) * n:(5 + k) * n] + d2 * (jz[i] * jz[j]))
    return m, d1, d2, torch.cat(rows, dim=0)


def vgh_reference(params, spec: SirenSpec, x: torch.Tensor, product=torch.matmul):
    """K1's arithmetic in torch: (f (N,), g (N, 3), h6 (N, 6)).

    ``product(carry, w)`` forms each hidden layer's (10N, h) x (h, h)
    product; another than the default rehearses a kernel's arithmetic (for
    example ``kernel_io.matmul_3xtf32``)."""
    check_spec(spec)
    _, ww = kio.freqs(spec)
    n = x.shape[0]
    _, _, carry = _first_layer(params, spec, x)
    for layer in params[1:-1]:
        carry = _hidden_layer(layer, ww, carry, n, product)[3]
    out = (carry @ params[-1]["w"])[:, 0].reshape(10, n)
    return out[0] + params[-1]["b"][0], out[1:4].T, out[4:10].T


def vgh_bwd_reference(params, spec: SirenSpec, x: torch.Tensor, cot: torch.Tensor):
    """K2's arithmetic in torch, term for term that of
    ``pallas_vgh_vjp.py::_vgh_bwd_kernel`` over one tile of all N rows.

    cot (N, 16) = (f̄ | ḡ | h̄6 | 0).  -> the gradient of
    ``sum(cot[:, :10] * (f | g | h6))`` as a list of ``{'w', 'b'}``."""
    check_spec(spec)
    w0, ww = kio.freqs(spec)
    n = x.shape[0]
    hidden = params[1:-1]

    # forward recompute: every product's input carry and the activation derivs
    d1, d2, carry = _first_layer(params, spec, x)
    carr, d1s, d2s = [carry], [d1], [d2]
    for layer in hidden:
        _, d1, d2, carry = _hidden_layer(layer, ww, carry, n)
        carr.append(carry)
        d1s.append(d1)
        d2s.append(d2)

    # head
    wl_row = params[-1]["w"][:, 0]
    head_in = carr[-1]
    carrybar = torch.cat([cot[:, k:k + 1] * wl_row for k in range(10)], dim=0)
    wlbar = cot[:, 0] @ head_in[0:n]
    for k in range(1, 10):
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
        hz = [m[(4 + q) * n:(5 + q) * n] for q in range(6)]
        ab = carrybar[0:n]
        jb = [carrybar[(1 + k) * n:(2 + k) * n] for k in range(3)]
        hb = [carrybar[(4 + q) * n:(5 + q) * n] for q in range(6)]

        sum_j = jb[0] * jz[0] + jb[1] * jz[1] + jb[2] * jz[2]
        sum_h = sum(hb[q] * hz[q] for q in range(6))
        sum_o = sum(hb[q] * (jz[_TRI_I[q]] * jz[_TRI_J[q]]) for q in range(6))
        zbar = d1 * ab + d2 * (sum_j + sum_h) - (ww * ww) * d1 * sum_o
        jzbar = [
            d1 * jb[0] + d2 * (2 * hb[0] * jz[0] + hb[1] * jz[1] + hb[2] * jz[2]),
            d1 * jb[1] + d2 * (hb[1] * jz[0] + 2 * hb[3] * jz[1] + hb[4] * jz[2]),
            d1 * jb[2] + d2 * (hb[2] * jz[0] + hb[4] * jz[1] + 2 * hb[5] * jz[2]),
        ]
        hzbar = [d1 * hb[q] for q in range(6)]
        mbar = torch.cat([zbar] + jzbar + hzbar, dim=0)  # (10N, h)
        grads[l + 1] = {"w": carry_in.T @ mbar, "b": zbar.sum(0)}
        carrybar = mbar @ w.T

    # first layer, with the direct dependence of J1 and H1 on the rows of W1
    d1, d2 = d1s[0], d2s[0]
    w1 = params[0]["w"]
    ab = carrybar[0:n]
    jb = [carrybar[(1 + k) * n:(2 + k) * n] for k in range(3)]
    hb = [carrybar[(4 + q) * n:(5 + q) * n] for q in range(6)]
    sum_jw = sum(jb[k] * w1[k] for k in range(3))
    sum_hw = sum(hb[q] * (w1[_TRI_I[q]] * w1[_TRI_J[q]]) for q in range(6))
    zbar1 = d1 * ab + d2 * sum_jw - (w0 * w0) * d1 * sum_hw
    direct = []
    for k in range(3):
        row = (jb[k] * d1).sum(0)
        for q in range(6):
            if _TRI_I[q] == k:
                row = row + (hb[q] * d2).sum(0) * w1[_TRI_J[q]]
            if _TRI_J[q] == k:
                row = row + (hb[q] * d2).sum(0) * w1[_TRI_I[q]]
        direct.append(row)
    grads[0] = {"w": x.T @ zbar1 + torch.stack(direct), "b": zbar1.sum(0)}
    return grads


def _check_kernel_input(spec, x, name):
    check_spec(spec)
    kio.check_points(x, name)


def vgh(params, spec: SirenSpec, x: torch.Tensor):
    """Fused (f (N,), g (N, 3), h6 (N, 6)) of a uniform-width sine SIREN.

    A CUDA ``x`` goes to K1; a CPU ``x`` to :func:`vgh_reference`.
    Raises ValueError on inputs the kernel does not take and RuntimeError
    when the launch fails.
    """
    global launches
    _check_kernel_input(spec, x, "vgh")
    if x.device.type == "cpu":
        return vgh_reference(params, spec, x)
    x = kio.operand(x, x.device, "x")
    lib = _lib()
    kio.check_width(spec, "vgh")
    out = torch.empty((x.shape[0], 16), device=x.device, dtype=torch.float32)
    if x.shape[0]:
        kio.launch_forward(lib.vgh_launch, lib.vgh_tile(), False, params, spec, x, out)
        launches += 1
    return out[:, 0], out[:, 1:4], out[:, 4:10]


def vgh_bwd(params, spec: SirenSpec, x: torch.Tensor, cot: torch.Tensor):
    """Gradient of ``sum(cot[:, :10] * (f | g | h6))`` with respect to the
    params; cot (N, 16) packed as ``make_vgh_op`` packs it.

    A CUDA ``x`` goes to K2; a CPU ``x`` to :func:`vgh_bwd_reference`."""
    global bwd_launches
    _check_kernel_input(spec, x, "vgh_bwd")
    if cot.shape != (x.shape[0], 16):
        raise ValueError(f"vgh_bwd: cot must be ({x.shape[0]}, 16), got {tuple(cot.shape)}")
    if x.device.type == "cpu":
        return vgh_bwd_reference(params, spec, x, cot)
    x = kio.operand(x, x.device, "x")
    cot = kio.operand(cot, x.device, "cot")
    lib = _bwd_lib()
    kio.check_width(spec, "vgh_bwd")
    grads = kio.launch_backward(lib.vgh_bwd_launch, lib.vgh_bwd_tile(), 10, params, spec, x, cot)
    bwd_launches += int(x.shape[0] > 0)
    return grads


class VghOp(torch.autograd.Function):
    """``make_vgh_op``: (f, g, h6) by K1, param gradients by K2 (or their
    plain versions on the CPU).  ``x`` is data: it gets no gradient."""

    @staticmethod
    def forward(ctx, spec, x, *leaves):
        ctx.spec = spec
        ctx.save_for_backward(x, *leaves)
        f, g, h6 = vgh(kio.params_from_leaves(leaves), spec, x)
        return f.contiguous(), g.contiguous(), h6.contiguous()

    @staticmethod
    def backward(ctx, fbar, gbar, hbar):
        x, *leaves = ctx.saved_tensors
        n = x.shape[0]
        cot = torch.cat([fbar[:, None], gbar, hbar, fbar.new_zeros((n, 6))], dim=1)
        grads = vgh_bwd(kio.params_from_leaves(leaves), ctx.spec, x, cot.contiguous())
        return (None, None) + kio.param_leaves(grads)


def vgh_op(params, spec: SirenSpec, x: torch.Tensor):
    """(f, g, h6) through :class:`VghOp`: differentiable in ``params``."""
    return VghOp.apply(spec, x, *kio.param_leaves(params))
