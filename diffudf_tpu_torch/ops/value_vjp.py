"""s2's value path as one kernel pair: f(x) of a uniform-width sine SIREN,
the gradient of ``sum(fbar * f)`` with respect to its params, and the
autograd op that pairs them.

The kernels (``csrc/value_vjp.cu``) replace no TPU kernel: the JAX package
leaves the value path of its stage-2 loss (``diffudf_tpu/train/losses.py::
loss_s2`` -> ``autodiff/ops.py::value``) to XLA.  They fuse what the plain
path runs as float32 matrix products and separate elementwise kernels:
the forward adds each bias, scales by ww and takes sin and cos in its
products' epilogue and keeps the residuals (every hidden product's input
carry and ww cos(ww z)); the VJP multiplies the cotangent by those
residuals where it forms it and runs W-bar as a split-K product summed in
a fixed order.

:func:`value_vjp_fwd` and :func:`value_vjp_bwd` are the wrappers: on a CUDA
tensor they launch the kernels (and raise on any input the kernels do not
take); on a CPU tensor they run the plain torch versions
:func:`value_vjp_reference` and :func:`value_vjp_bwd_reference`, the
kernels' arithmetic (the same ``fast_sincos``, float32 products) and the
hand-derived backward, not autograd.  :class:`ValueVjpOp` is the
``torch.autograd.Function`` of :func:`value_vjp_op`.

The library is built from source with ``nvcc`` at first use (:func:`build`)
into the ignored build directory and bound with ``ctypes``.  ``launches``
and ``bwd_launches`` count the forward and backward launches.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..fields.siren import SirenSpec, flat_size, unflatten_params
from ..native.build import build_shared
from . import kernel_io as kio
from .sincos import fast_sin, fast_sincos

_SOURCES = kio.sources("value_vjp.cu", "siren_bwd.cuh", "siren_tile.cuh", "sincos.cuh")
_P = ctypes.c_void_p
# (x, n, w1, b1, wh, bh, n_mm, wl, bl, w0, ww, h, tile, grid, frag, cbuf, dbuf, f, stream)
_FWD_ARGTYPES = [_P, ctypes.c_int, _P, _P, _P, _P, ctypes.c_int, _P, _P,
                 ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                 _P, _P, _P, _P, _P]
# (x, fbar, n, w1, b1, n_mm, wl, w0, ww, h, tile, grid, n_split, split_rows, frag, cbuf,
#  dbuf, mbar, small, wpart, out, stream)
_BWD_ARGTYPES = [_P, _P, ctypes.c_int, _P, _P, ctypes.c_int, _P,
                 ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                 ctypes.c_int, ctypes.c_longlong, _P, _P, _P, _P, _P, _P, _P, _P]

# the tiles csrc/value_vjp.cu is built for, in points: 80 takes a training
# batch's 9,990 surface rows in one wave, 16 a data-parallel rank's share
TILES = (16, 80)

# kernel launches since the counts were last set to 0: the forward, the VJP
launches = 0
bwd_launches = 0


def build() -> str:
    """Build the pair's library if needed; -> its path."""
    return build_shared("value_vjp", kio.nvcc_command(), _SOURCES)


@functools.cache
def _lib():
    lib = ctypes.CDLL(build())
    lib.value_vjp_fwd_launch.argtypes = _FWD_ARGTYPES
    lib.value_vjp_fwd_launch.restype = ctypes.c_int
    lib.value_vjp_bwd_launch.argtypes = _BWD_ARGTYPES
    lib.value_vjp_bwd_launch.restype = ctypes.c_int
    return lib


@dataclass(frozen=True)
class VjpPlan:
    """Tile, grid, buffers and device-memory bytes of the pair on ``n``
    points of a net of width ``h`` with ``n_mm`` hidden products, on a card
    with ``sms`` SMs.  Sizes are in floats; see ``csrc/value_vjp.cu``.
    :func:`vjp_plan` picks the tile."""

    tile: int
    h: int
    n_mm: int
    n: int
    sms: int

    @property
    def n_tiles(self) -> int:
        return -(-self.n // self.tile)

    @property
    def grid(self) -> int:
        """CTAs of both tile kernels: persistent, at most one per SM."""
        return min(self.sms, self.n_tiles)

    @property
    def k_rows(self) -> int:
        """Rows of every tile: the rows of C, M-bar and D a layer."""
        return self.n_tiles * self.tile

    @property
    def _split(self) -> kio.BwdPlan:
        """W-bar's split-K product, as K2's and K3b's at one row a point."""
        return kio.BwdPlan(rows=1, tile=self.tile, h=self.h, n_mm=self.n_mm, n=self.n,
                           sms=self.sms)

    @property
    def splits(self) -> int:
        return self._split.splits if self.n_tiles else 0

    @property
    def split_rows(self) -> int:
        return self._split.split_rows if self.n_tiles else 0

    @property
    def sizes(self) -> dict:
        """Floats of each buffer: W and W^T in fragment order; C and M-bar
        (every product's input carry and z-bar, in blocks of 32 rows); D
        (every hidden layer's ww cos(ww z) and the head's input carry); the
        per-CTA small gradients; the W-bar partials."""
        h = self.h
        k32 = -(-self.k_rows // kio.WBAR_CHUNK) * kio.WBAR_CHUNK
        return {
            "frag": 2 * self.n_mm * h * h,
            "cbuf": self.n_mm * h * k32,
            "dbuf": (self.n_mm + 1) * self.k_rows * h,
            "mbar": self.n_mm * h * k32,
            "small": self.grid * (5 * h + 1),
            "wpart": self.n_mm * self.splits * (h * h + h),
        }

    @property
    def bytes_moved(self) -> int:
        """Device-memory bytes of a forward and its VJP by the design: x
        read twice, f written and f-bar read once; the weights read twice,
        the flat gradient written once; the fragments, C, D, M-bar, the
        small partials and the W-bar partials written once and read once
        (the tiles re-read the fragments from L2)."""
        flat = 4 * self.h + self.n_mm * (self.h * self.h + self.h) + self.h + 1
        if self.n_tiles == 0:
            return 4 * flat
        z = self.sizes
        once = sum(z.values())
        return 4 * (self.n * (2 * 3 + 2) + 3 * flat + 2 * once)


def vjp_plan(spec: SirenSpec, n: int, sms: int) -> VjpPlan:
    """The pair's plan for ``n`` points: the tile of TILES that takes the
    fewest rows a CTA, ceil(tiles / sms) * T (a tile's time grows with its
    rows), the larger tile on a tie (fewer passes over W in L2)."""
    def rows_per_cta(t):
        return -(-(-(-n // t)) // sms) * t

    tile = min(TILES, key=lambda t: (rows_per_cta(t), -t))
    return VjpPlan(tile=tile, h=spec.hidden[0], n_mm=len(spec.hidden) - 1, n=n, sms=sms)


class Saved(NamedTuple):
    """What the kernels' VJP reads of their forward: the plan, W's
    fragments, C and D (``csrc/value_vjp.cu``)."""

    plan: VjpPlan
    frag: torch.Tensor
    cbuf: torch.Tensor
    dbuf: torch.Tensor


def value_vjp_reference(params, spec: SirenSpec, x: torch.Tensor):
    """The forward's arithmetic in torch: -> (f (N,), (carries, d1s, a)),
    where carries[l] is hidden product l's input carry, d1s[l] its
    ww cos(ww z) and a the head's input carry: what
    :func:`value_vjp_bwd_reference` reads."""
    kio.check_spec(spec)
    w0, ww = kio.freqs(spec)
    a = fast_sin(w0 * (x @ params[0]["w"] + params[0]["b"]))
    carries, d1s = [], []
    for layer in params[1:-1]:
        carries.append(a)
        a, c = fast_sincos(ww * (a @ layer["w"] + layer["b"]))
        d1s.append(ww * c)
    return (a @ params[-1]["w"])[:, 0] + params[-1]["b"][0], (carries, d1s, a)


def value_vjp_bwd_reference(params, spec: SirenSpec, x: torch.Tensor, saved, fbar: torch.Tensor):
    """The VJP's arithmetic in torch, derived by hand: the gradient of
    ``sum(fbar * f)`` as a list of ``{'w', 'b'}``, from the forward's
    ``saved`` residuals."""
    kio.check_spec(spec)
    w0, _ = kio.freqs(spec)
    carries, d1s, a = saved
    grads = [None] * len(params)
    grads[-1] = {"w": (fbar @ a)[:, None], "b": fbar.sum()[None]}
    abar = fbar[:, None] * params[-1]["w"][:, 0]
    for l in reversed(range(len(carries))):
        zbar = d1s[l] * abar
        grads[l + 1] = {"w": carries[l].T @ zbar, "b": zbar.sum(0)}
        abar = zbar @ params[l + 1]["w"].T
    _, c = fast_sincos(w0 * (x @ params[0]["w"] + params[0]["b"]))
    zbar = (w0 * c) * abar
    grads[0] = {"w": x.T @ zbar, "b": zbar.sum(0)}
    return grads


def _sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def value_vjp_fwd(params, spec: SirenSpec, x: torch.Tensor):
    """f (N,) of a uniform-width sine SIREN and what its VJP reads: ->
    (f, saved).

    A CUDA ``x`` goes to the forward kernel; a CPU ``x`` to
    :func:`value_vjp_reference`.  Raises ValueError on inputs the kernel
    does not take and RuntimeError when the launch fails."""
    global launches
    kio.check_spec(spec)
    kio.check_points(x, "value_vjp_fwd")
    if x.device.type == "cpu":
        return value_vjp_reference(params, spec, x)
    dev = x.device
    x = kio.operand(x, dev, "x")
    lib = _lib()
    kio.check_width(spec, "value_vjp_fwd")
    plan = vjp_plan(spec, x.shape[0], _sms(dev))
    w1, b1, wh, bh, wl, bl = kio.weights(params, dev)
    z = plan.sizes
    frag, cbuf, dbuf = (torch.empty(z[k], device=dev, dtype=torch.float32)
                        for k in ("frag", "cbuf", "dbuf"))
    f = torch.empty(x.shape[0], device=dev, dtype=torch.float32)
    if plan.n_tiles:
        w0, ww = kio.freqs(spec)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.value_vjp_fwd_launch(
                x.data_ptr(), plan.n, w1.data_ptr(), b1.data_ptr(), wh.data_ptr(), bh.data_ptr(),
                plan.n_mm, wl.data_ptr(), bl.data_ptr(), float(w0), float(ww), plan.h,
                plan.tile, plan.grid, frag.data_ptr(), cbuf.data_ptr(), dbuf.data_ptr(),
                f.data_ptr(), stream)
        if rc:
            raise RuntimeError(f"value_vjp forward launch failed with CUDA error {rc}")
        launches += 1
    return f, Saved(plan, frag, cbuf, dbuf)


def value_vjp_bwd(params, spec: SirenSpec, x: torch.Tensor, saved, fbar: torch.Tensor):
    """Gradient of ``sum(fbar * f)`` with respect to the params, from the
    forward's ``saved``: a list of ``{'w', 'b'}`` (on CUDA views of one flat
    tensor, the ravel_pytree layout).

    A CUDA ``x`` goes to the VJP kernels; a CPU ``x`` to
    :func:`value_vjp_bwd_reference`."""
    global bwd_launches
    kio.check_spec(spec)
    kio.check_points(x, "value_vjp_bwd")
    if fbar.shape != (x.shape[0],):
        raise ValueError(f"value_vjp_bwd: fbar must be ({x.shape[0]},), got {tuple(fbar.shape)}")
    if x.device.type == "cpu":
        return value_vjp_bwd_reference(params, spec, x, saved, fbar)
    dev = x.device
    x = kio.operand(x, dev, "x")
    fbar = kio.operand(fbar, dev, "fbar")
    lib = _lib()
    kio.check_width(spec, "value_vjp_bwd")
    plan = saved.plan
    out = torch.empty(flat_size(spec), device=dev, dtype=torch.float32)
    z = plan.sizes
    mbar, small, wpart = (torch.empty(z[k], device=dev, dtype=torch.float32)
                          for k in ("mbar", "small", "wpart"))
    w1 = kio.operand(params[0]["w"], dev, "W1")
    b1 = kio.operand(params[0]["b"], dev, "b1")
    wl = kio.operand(params[-1]["w"], dev, "W_last")
    w0, ww = kio.freqs(spec)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.value_vjp_bwd_launch(
            x.data_ptr(), fbar.data_ptr(), plan.n, w1.data_ptr(), b1.data_ptr(), plan.n_mm,
            wl.data_ptr(), float(w0), float(ww), plan.h, plan.tile, plan.grid, plan.splits,
            plan.split_rows, saved.frag.data_ptr(), saved.cbuf.data_ptr(),
            saved.dbuf.data_ptr(), mbar.data_ptr(), small.data_ptr(), wpart.data_ptr(),
            out.data_ptr(), stream)
    if rc:
        raise RuntimeError(f"value_vjp backward launch failed with CUDA error {rc}")
    bwd_launches += int(plan.n_tiles > 0)
    return unflatten_params(out, spec)


class ValueVjpOp(torch.autograd.Function):
    """:func:`value_vjp_op`: f by the forward kernel, the params' gradient
    by its VJP (or their plain versions on the CPU).  ``x`` is data: it
    gets no gradient."""

    @staticmethod
    def forward(ctx, spec, x, *leaves):
        ctx.spec = spec
        ctx.save_for_backward(x, *leaves)
        f, ctx.saved = value_vjp_fwd(kio.params_from_leaves(leaves), spec, x)
        return f

    @staticmethod
    def backward(ctx, fbar):
        x, *leaves = ctx.saved_tensors
        grads = value_vjp_bwd(kio.params_from_leaves(leaves), ctx.spec, x, ctx.saved,
                              fbar.contiguous())
        ctx.saved = None
        return (None, None) + kio.param_leaves(grads)


def value_vjp_op(params, spec: SirenSpec, x: torch.Tensor):
    """f (N,) through :class:`ValueVjpOp`: differentiable in ``params``."""
    return ValueVjpOp.apply(spec, x, *kio.param_leaves(params))
