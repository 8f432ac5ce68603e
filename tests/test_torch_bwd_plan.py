"""The host side of the backward kernels K2 and K3b (``csrc/siren_bwd.cuh``):
the launch plan of ``ops/kernel_io.py`` (grid, workspaces, W-bar row runs,
device-memory bytes) against hand counts, and the TF32 operand split the
kernels multiply with, in torch on the CPU.

The kernels themselves run only on a GPU (tests/test_torch_cuda.py); these
tests need neither a GPU nor JAX."""

import numpy as np
import pytest
import torch

from diffudf_tpu_torch.fields.siren import SirenSpec, init_siren, params_from_jax
from diffudf_tpu_torch.ops import kernel_io as kio
from diffudf_tpu_torch.ops import vgh as tv

SMS = 132  # an H100 SXM


def _plan(rows, tile, h, n_mm, n):
    return kio.BwdPlan(rows=rows, tile=tile, h=h, n_mm=n_mm, n=n, sms=SMS)


# (rows, tile, n): K2 on the s1 step's 9,990 surface rows, K3b on its 19,980
# off-surface rows, at 8x256 (7 hidden products)
TRAINING = {"K2": (10, 8, 9990), "K3b": (4, 16, 19980)}


@pytest.mark.parametrize("kernel", ["K2", "K3b"])
def test_plan_at_the_training_shapes(kernel):
    rows, tile, n = TRAINING[kernel]
    p = _plan(rows, tile, 256, 7, n)
    assert p.n_tiles == 1249  # 9990 / 8 and 19980 / 16, rounded up
    assert p.grid == 132
    k = 1249 * rows * tile  # 99,920 and 79,936 rows of C and M-bar a layer
    assert p.k_rows == k
    k32 = {"K2": 99936, "K3b": 79936}[kernel]  # stored in blocks of 32 rows
    assert p.blocks == 4  # 128 x 128 blocks of a 256 x 256 W-bar
    # 7 layers x 4 blocks x 33 runs = 924 CTAs: seven full waves of 132
    assert p.splits == 33
    assert p.split_rows == {"K2": 3040, "K3b": 2432}[kernel]
    assert p.split_rows * 33 >= k > p.split_rows * 32
    assert p.sizes == {
        "frag": 2 * 7 * 256 * 256,
        "ws_m": 132 * 7 * rows * tile * 256,
        "cbuf": 7 * 256 * k32,
        "mbar": 7 * 256 * k32,
        "small": 132 * (5 * 256 + 1),
        "wpart": 7 * 33 * (256 * 256 + 256),
    }
    flat = 4 * 256 + 7 * (256 + 256 * 256) + 1 + 256
    assert p.flat == flat == 461_825
    by_hand = 4 * (n * (3 + rows)            # x and the used cotangent columns
                   + (flat - 1) + flat       # weights in, gradient out
                   + 2 * 2 * 7 * 256 * 256   # fragments
                   + 2 * 3 * 7 * 256 * k     # C, M-bar and m, each way
                   + 2 * 132 * 1281          # small partials
                   + 2 * 7 * 33 * 65792)     # W-bar partials
    assert p.bytes_moved == by_hand
    # the numbers the kernels' source notes quote
    assert round(p.bytes_moved / 1e9, 2) == {"K2": 4.43, "K3b": 3.57}[kernel]
    assert round(4 * 7 * 256 * k / 1e9, 3) == {"K2": 0.716, "K3b": 0.573}[kernel]
    print(f"{kernel}: {p.bytes_moved / 1e9:.3f} GB a launch, "
          f"{1e3 * p.bytes_moved / 3.35e12:.3f} ms at 3.35 TB/s")


@pytest.mark.parametrize("rows,tile", [(10, 8), (4, 16)])
@pytest.mark.parametrize("h,n_mm,n", [(32, 3, 1001), (96, 2, 1003), (160, 2, 333),
                                      (64, 2, 5), (64, 0, 1001), (256, 7, 1)])
def test_plan_covers_every_row_once(rows, tile, h, n_mm, n):
    """Every width the kernels take, a ragged last tile, n below one tile and
    no hidden product: the runs cover K with no empty run, in 32-row chunks;
    the grid never exceeds the tiles."""
    p = _plan(rows, tile, h, n_mm, n)
    assert p.n_tiles == -(-n // tile) and 1 <= p.grid <= min(SMS, p.n_tiles)
    assert p.blocks == (-(-h // 128)) ** 2
    if n_mm == 0:
        assert p.splits == 0 and p.sizes["cbuf"] == p.sizes["wpart"] == p.sizes["frag"] == 0
        return
    assert p.split_rows % 32 == 0
    assert (p.splits - 1) * p.split_rows < p.k_rows <= p.splits * p.split_rows


def test_plan_for_no_points_moves_only_the_gradient():
    p = _plan(10, 8, 256, 7, 0)
    assert p.n_tiles == 0 and p.grid == 0
    assert p.bytes_moved == 4 * p.flat


def test_tf32_round_is_cvt_rna():
    """Nearest TF32 value, ties away from zero, low 13 bits zero."""
    one = 1.0
    ulp = 2.0 ** -10  # TF32 spacing in [1, 2)
    a = torch.tensor([one, one + ulp / 2, -(one + ulp / 2), one + ulp / 4, one + 3 * ulp / 4,
                      one + ulp + ulp / 2, 0.0, -0.0, 3.0e-39], dtype=torch.float32)
    want = torch.tensor([one, one + ulp, -(one + ulp), one, one + ulp, one + 2 * ulp, 0.0, -0.0],
                        dtype=torch.float32)
    got = kio.tf32_round(a)
    assert torch.equal(got[:8], want)
    assert int(got.view(torch.int32)[8]) & 0x1FFF == 0  # a subnormal keeps the mask too
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=4096) * 10.0 ** rng.uniform(-6, 6, 4096),
                        dtype=torch.float32)
    r = kio.tf32_round(x)
    assert not (r.view(torch.int32) & 0x1FFF).any()
    # nearest of the two TF32 neighbours: within half a TF32 ulp (2^-11 relative)
    assert bool(((r - x).abs() <= x.abs() * 2.0 ** -11).all())


def test_tf32_split_parts():
    """hi and lo are TF32 values; hi + lo == a exactly when a's residual
    fits in 11 bits (22 significant bits in all), and to within 2^-22 |a|
    for any float32 (the residual a - hi has up to 13 bits)."""
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.normal(size=8192), dtype=torch.float32)
    hi, lo = kio.tf32_split(x)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    assert bool(((x - hi - lo).abs() <= x.abs() * 2.0 ** -22).all())
    short = (x.view(torch.int32) & ~0x3).view(torch.float32)  # 22 significant bits
    hi, lo = kio.tf32_split(short)
    assert torch.equal(hi + lo, short)
    assert bool((lo.abs() <= hi.abs() * 2.0 ** -11).all())


def test_3xtf32_product_against_float64():
    """The three-term product at the shape and magnitudes of K2's products:
    an (80, 256) carry of a tile of 8 points through the first hidden layer
    of a random 8x256 SIREN, times that layer's (256, 256) W, and the
    m-bar W^T product with a unit-normal m-bar.  Its distance from float64
    is held to the float32 product's times chip_smoke.py's WITNESS (2.0),
    the gate the kernel meets on the card; the ratios are printed."""
    spec = SirenSpec(hidden=(256,) * 8)
    params = params_from_jax(init_siren(spec, np.random.default_rng(0)), "cpu")
    x = torch.as_tensor(np.random.default_rng(1).uniform(-1, 1, (8, 3)), dtype=torch.float32)
    _, _, carry = tv._first_layer(params, spec, x)
    _, ww = kio.freqs(spec)
    carry = tv._hidden_layer(params[1], ww, carry, 8)[3]  # the second product's input
    w = params[2]["w"]
    mbar = torch.as_tensor(np.random.default_rng(2).normal(size=(80, 256)), dtype=torch.float32)
    for name, a, b in (("carry W", carry, w), ("m-bar W^T", mbar, w.T.contiguous())):
        exact = a.double() @ b.double()
        e32 = (a @ b).double() - exact
        e3 = kio.matmul_3xtf32(a, b).double() - exact
        ratio_max = float(e3.abs().max() / e32.abs().max())
        ratio_rms = float(e3.square().mean().sqrt() / e32.square().mean().sqrt())
        print(f"{name}: 3xTF32 / float32 distance from float64: max {ratio_max:.3f}, "
              f"RMS {ratio_rms:.3f}")
        assert ratio_max <= 2.0 and ratio_rms <= 2.0
