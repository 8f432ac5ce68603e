"""What the SIREN kernel wrappers (:mod:`.vgh`, :mod:`.vg`, :mod:`.value`)
share: the ``nvcc`` command, the checks on what the kernels compute, the
operands in the layout the kernels read, and the launches of the forward
kernels K1 and K3a (``csrc/siren_fwd.cuh``) and the backward kernels K2 and
K3b (``csrc/siren_bwd.cuh``) with the plans of their grids, workspaces and
device-memory bytes (:class:`FwdPlan`, :class:`BwdPlan`), and K4's plan
(:class:`ValuePlan`) and bf16 fragments (:func:`value_fragments`).  Also
the TF32 split that K2, K3a and K3b multiply with (:func:`tf32_split`,
:func:`matmul_3xtf32`), in torch, so that its accuracy can be rehearsed on
the CPU.

Nothing here builds or launches at import time.
"""

from __future__ import annotations

import ctypes
import math
import os
import shutil
from dataclasses import dataclass

import torch

from ..fields.siren import SirenSpec, flat_size, unflatten_params

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")

# widest hidden layer the kernels take: one thread per column (kMaxH in csrc)
MAX_WIDTH = 256

# packed-Hessian component index pairs (must match autodiff.ops)
TRI_I = (0, 0, 0, 1, 1, 2)
TRI_J = (0, 1, 2, 1, 2, 2)

_P = ctypes.c_void_p
# (x, n, w1, b1, wh, bh, n_mm, wl, bl, w0, ww, h, grid, frag, out, stream)
FWD_ARGTYPES = [_P, ctypes.c_int, _P, _P, _P, _P, ctypes.c_int, _P, _P,
                ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int, _P, _P, _P]
# (x, cot, n, w1, b1, wh, bh, n_mm, wl, w0, ww, h, grid, n_split,
#  split_rows, frag, ws_m, cbuf, mbar, small, wpart, out, stream)
BWD_ARGTYPES = [_P, _P, ctypes.c_int, _P, _P, _P, _P, ctypes.c_int, _P,
                ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_longlong, _P, _P, _P, _P, _P, _P, _P, _P]

# csrc/siren_bwd.cuh: wbar_kernel's output block and its rows a pipeline stage
WBAR_BLOCK = 128
WBAR_CHUNK = 32


def nvcc_command(main: str = "") -> list:
    """nvcc for Hopper into a shared library, with the ptxas report, for the
    source ``main``.  K1 (``vgh.cu``) is built without FMA contraction: its
    elementwise arithmetic then rounds op by op as its plain torch version's
    does, which its element gate on fitted nets needs
    (``scripts/fwd_gate_check.py``)."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    return [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
            "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", CSRC] + (
                ["-fmad=false"] if main == "vgh.cu" else [])


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


@dataclass(frozen=True)
class FwdPlan:
    """Grid, workspace and device-memory bytes of one launch of the forward
    kernel (K1: ``tile`` 8 points, ``cols`` 16 output columns, FP32 FMA
    products; K3a: 16 and 8, 3xTF32 products, ``tf32``) for ``n`` points of
    a net of width ``h`` with ``n_mm`` hidden products, on a card with
    ``sms`` SMs.  Sizes are in floats; see ``csrc/siren_fwd.cuh``."""

    tile: int
    cols: int
    tf32: bool
    h: int
    n_mm: int
    n: int
    sms: int

    @property
    def n_tiles(self) -> int:
        return -(-self.n // self.tile)

    @property
    def grid(self) -> int:
        """CTAs of fwd_kernel: persistent, at most one per SM; CTA c takes
        tiles c, c + grid, ..."""
        return min(self.sms, self.n_tiles)

    @property
    def frag(self) -> int:
        """Floats of the fragment workspace: W of every hidden layer for the
        tensor-core products; none for FP32 FMA, which reads W itself."""
        return self.n_mm * self.h * self.h if self.tf32 else 0

    @property
    def bytes_moved(self) -> int:
        """Device-memory bytes a launch moves by the design: x read once,
        the ``cols`` output columns written once, the weights read once and
        their fragments written once and read once (the tiles re-read W or
        its fragments from L2)."""
        weights = 4 * self.h + self.n_mm * (self.h * self.h + self.h) + self.h + 1
        return 4 * (self.n * (3 + self.cols) + weights + 2 * self.frag)


def forward_plan(spec: SirenSpec, n: int, tile: int, cols: int, tf32: bool, sms: int) -> FwdPlan:
    return FwdPlan(tile=tile, cols=cols, tf32=tf32, h=spec.hidden[0], n_mm=len(spec.hidden) - 1,
                   n=n, sms=sms)


def launch_forward(fn, tile: int, tf32: bool, params, spec, x, out):
    """Call a forward launcher (K1 or K3a) on the current stream into
    ``out`` (N, cols); raise on a CUDA error.  The fragment workspace
    follows :func:`forward_plan`."""
    dev = x.device
    plan = forward_plan(spec, x.shape[0], tile, out.shape[1], tf32,
                        torch.cuda.get_device_properties(dev).multi_processor_count)
    if plan.n_tiles == 0:
        return
    w1, b1, wh, bh, wl, bl = weights(params, dev)
    w0, ww = freqs(spec)
    frag = torch.empty(plan.frag, device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(x.data_ptr(), plan.n, w1.data_ptr(), b1.data_ptr(), wh.data_ptr(),
                bh.data_ptr(), plan.n_mm, wl.data_ptr(), bl.data_ptr(), float(w0), float(ww),
                plan.h, plan.grid, frag.data_ptr(), out.data_ptr(), stream)
    if rc:
        raise RuntimeError(f"kernel launch failed with CUDA error {rc}")


@dataclass(frozen=True)
class BwdPlan:
    """Grid, workspaces and device-memory bytes of one launch of the backward
    kernel (K2: ``rows`` 10, ``tile`` 8; K3b: 4 and 16) for ``n`` points of
    a net of width ``h`` with ``n_mm`` hidden products, on a card with
    ``sms`` SMs.  Sizes are in floats; see ``csrc/siren_bwd.cuh``."""

    rows: int
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
        """CTAs of tile_kernel: persistent, at most one per SM."""
        return min(self.sms, self.n_tiles)

    @property
    def k_rows(self) -> int:
        """Rows of C and M-bar a layer: every tile's rows * tile carry rows."""
        return self.n_tiles * self.rows * self.tile

    @property
    def blocks(self) -> int:
        """wbar_kernel's output blocks a layer."""
        nb = -(-self.h // WBAR_BLOCK)
        return nb * nb

    @property
    def splits(self) -> int:
        """Row runs of wbar_kernel a layer: at least four waves of CTAs on
        the card, as even as the runs allow (the fewest CTAs in the last
        wave's gap), never more runs than 32-row chunks."""
        units = self.n_mm * self.blocks
        if units == 0:
            return 0
        chunks = -(-self.k_rows // WBAR_CHUNK)
        lo = min(chunks, -(-4 * self.sms // units))
        best = max(range(lo, min(chunks, 2 * lo) + 1),
                   key=lambda s: (units * s / (-(-units * s // self.sms) * self.sms), -s))
        return -(-chunks // -(-chunks // best))  # no empty run

    @property
    def split_rows(self) -> int:
        """Rows of K a run: a multiple of 32."""
        if not self.splits:
            return 0
        chunks = -(-self.k_rows // WBAR_CHUNK)
        return WBAR_CHUNK * -(-chunks // self.splits)

    @property
    def flat(self) -> int:
        """Floats of the flat gradient."""
        return 4 * self.h + self.n_mm * (self.h + self.h * self.h) + 1 + self.h

    @property
    def sizes(self) -> dict:
        """Floats of each buffer the launch needs."""
        h, rt = self.h, self.rows * self.tile
        k32 = -(-self.k_rows // WBAR_CHUNK) * WBAR_CHUNK  # stored in blocks of 32 rows
        return {
            "frag": 2 * self.n_mm * h * h,          # W and W^T in fragment order
            "ws_m": self.grid * self.n_mm * rt * h,  # m of one tile, per CTA
            "cbuf": self.n_mm * h * k32,            # every product's input carry
            "mbar": self.n_mm * h * k32,            # every product's m-bar
            "small": self.grid * (5 * h + 1),       # b1, W1, b_L, W_L per CTA
            "wpart": self.n_mm * self.splits * (h * h + h),  # W-bar, b-bar per run
        }

    @property
    def bytes_moved(self) -> int:
        """Device-memory bytes a launch moves by the design: x and the R
        used cotangent columns read once; the weights read once; the
        fragments, the partials and the K rows of C and M-bar written once
        and read once (the tiles re-read the fragments from L2); m written
        and read once a tile, as many floats as C; the flat gradient
        written once."""
        if self.n_tiles == 0:
            return 4 * self.flat
        weights = self.flat - 1  # every W and b but b_L
        z = self.sizes
        rows = self.n_mm * self.h * self.k_rows  # of C, of M-bar and of m
        once = z["frag"] + z["small"] + z["wpart"] + 3 * rows
        return 4 * (self.n * (3 + self.rows) + weights + self.flat + 2 * once)


def backward_plan(spec: SirenSpec, n: int, rows: int, tile: int, sms: int) -> BwdPlan:
    return BwdPlan(rows=rows, tile=tile, h=spec.hidden[0], n_mm=len(spec.hidden) - 1, n=n,
                   sms=sms)


def launch_backward(fn, tile: int, rows: int, params, spec, x, cot):
    """Call a backward launcher (K2 or K3b) and return the gradient as a
    list of ``{'w', 'b'}`` views of one flat tensor (ravel_pytree layout).

    The workspaces follow :func:`backward_plan`; the launcher adds every
    partial in a fixed order."""
    dev = x.device
    out = torch.empty(flat_size(spec), device=dev, dtype=torch.float32)
    plan = backward_plan(spec, x.shape[0], rows, tile,
                         torch.cuda.get_device_properties(dev).multi_processor_count)
    if plan.n_tiles == 0:
        return unflatten_params(out.zero_(), spec)
    w1, b1, wh, bh, wl, _ = weights(params, dev)
    w0, ww = freqs(spec)
    buf = {k: torch.empty(v, device=dev, dtype=torch.float32) for k, v in plan.sizes.items()}
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(x.data_ptr(), cot.data_ptr(), plan.n, w1.data_ptr(), b1.data_ptr(),
                wh.data_ptr(), bh.data_ptr(), plan.n_mm, wl.data_ptr(), float(w0), float(ww),
                plan.h, plan.grid, plan.splits, plan.split_rows,
                *(buf[k].data_ptr() for k in ("frag", "ws_m", "cbuf", "mbar", "small", "wpart")),
                out.data_ptr(), stream)
    if rc:
        raise RuntimeError(f"backward kernel launch failed with CUDA error {rc}")
    return unflatten_params(out, spec)


# K4's tiles (csrc/value.cu builds fwd_kernel<1, T, P> for each) and, as in
# csrc/siren_fwd.cuh, the bf16 A-row padding and fragment ring depth of its
# bf16 product, and fma_product's ring (kChunk rows, kStages slots)
VALUE_TILES = (16, 32, 64, 128)
BF_PAD = 8
BF_RING = 8
FMA_CHUNK, FMA_STAGES = 16, 3


def value_fragments(wh: torch.Tensor) -> torch.Tensor:
    """W of every hidden layer, (n_mm, h, h) with W[l][k][n], in the order of
    K4's bf16 B fragments (``csrc/siren_fwd.cuh``, Product::kBf16): for layer
    l, k-pair p (k in [32p, 32p + 32)), 8-column tile u and lane 4g + t4
    (column n = 8u + g), the eight values W[32p + 16s + 8i + 2 t4 + e][n]
    in (s, i, e) order: the two registers of mma.sync.m16n8k16's B fragment
    for k-step 2p (s = 0) and 2p + 1, the lower k in each register's low
    half.  Same dtype as ``wh``; (n_mm, h/32, h/8, 32, 8)."""
    n_mm, h, _ = wh.shape
    return (wh.reshape(n_mm, h // 32, 2, 2, 4, 2, h // 8, 8)
            .permute(0, 1, 6, 7, 4, 2, 3, 5)
            .reshape(n_mm, h // 32, h // 8, 32, 8).contiguous())


@dataclass(frozen=True)
class ValuePlan:
    """Tile, grid, shared memory and bytes of one K4 launch (``csrc/
    value.cu``) on ``n`` points of a net of width ``h`` with ``n_mm`` hidden
    products, in the bf16 (``mixed``) or float32 mode, on a card with
    ``sms`` SMs.  :func:`value_plan` picks the tile."""

    tile: int
    mixed: bool
    h: int
    n_mm: int
    n: int
    sms: int

    @property
    def n_tiles(self) -> int:
        return -(-self.n // self.tile)

    @property
    def grid(self) -> int:
        """CTAs: persistent, at most one per SM; CTA c takes tiles c,
        c + grid, ..."""
        return min(self.sms, self.n_tiles)

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory of a CTA (``value_smem`` in csrc): the bf16
        carry (T rows, h + BF_PAD wide) and every warp's fragment ring; or
        fma_product's transposed carry and W ring."""
        h, t = self.h, self.tile
        if self.mixed:
            return 2 * t * (h + BF_PAD) + (h // 32) * BF_RING * 4 * 32 * 16
        rows = t // 8  # a thread's rows: 2 MT for MT = T / 16 m-tiles
        ld = 8 * (-(-rows // 4) * 4)
        return 4 * (h * ld + FMA_STAGES * FMA_CHUNK * h)

    @property
    def w_bytes(self) -> int:
        """Bytes of the hidden layers' W as the launch reads it: bf16
        fragments or float32 rows."""
        return (2 if self.mixed else 4) * self.n_mm * self.h * self.h

    @property
    def bytes_moved(self) -> int:
        """Device-memory bytes a launch moves by the design: x read and f
        written once, W and the other weights read once (the fragments are
        laid out once per trace, not per launch)."""
        small = 4 * (3 * self.h + self.h + self.n_mm * self.h + self.h + 1)
        return 16 * self.n + self.w_bytes + small

    @property
    def l2_bytes(self) -> int:
        """Bytes of W the tiles read from L2: all of it once a tile."""
        return self.n_tiles * self.w_bytes


def value_plan(spec: SirenSpec, n: int, mixed: bool, sms: int) -> ValuePlan:
    """K4's plan for ``n`` points: the tile of VALUE_TILES that takes the
    fewest rows a CTA, ceil(tiles / sms) * T (a tile's time grows with its
    rows), the larger tile on a tie (fewer passes over W in L2)."""
    def rows_per_cta(t):
        tiles = -(-n // t)
        return -(-tiles // sms) * t

    tile = min(VALUE_TILES, key=lambda t: (rows_per_cta(t), -t))
    return ValuePlan(tile=tile, mixed=mixed, h=spec.hidden[0], n_mm=len(spec.hidden) - 1, n=n,
                     sms=sms)


def tf32_round(a: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 explicit mantissa bits) to nearest, ties
    away from zero: ``cvt.rna.tf32.f32``.  The low 13 bits come out zero."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split(a: torch.Tensor):
    """(hi, lo) = (rna(a), rna(a - hi)): the operand split of the SIREN
    kernels.  hi + lo is a to within 2^-22 |a|, exactly when a - hi fits in
    11 significant bits."""
    hi = tf32_round(a)
    return hi, tf32_round(a - hi)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernels' hidden products form it: lo*hi + hi*lo +
    hi*hi, each product of TF32 values exact in float32, summed in float32
    (one float32 matmul over the three stacked terms)."""
    ah, al = tf32_split(a)
    bh, bl = tf32_split(b)
    return torch.cat([al, ah, ah], dim=1) @ torch.cat([bh, bl, bh], dim=0)


def param_leaves(params):
    """The params as one tuple of tensors, layer by layer (w, b)."""
    return tuple(t for layer in params for t in (layer["w"], layer["b"]))


def params_from_leaves(leaves):
    return [{"w": leaves[i], "b": leaves[i + 1]} for i in range(0, len(leaves), 2)]
