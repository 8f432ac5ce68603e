"""The host side of the forward kernels K1 and K3a (``csrc/siren_fwd.cuh``):
the launch plan of ``ops/kernel_io.py`` (grid, tiles, fragment workspace,
device-memory bytes) against hand counts and the persistent grid's walk over
the tiles, and a torch rehearsal of the 3xTF32 forward (K3a's product, and
the forward recompute of K2) on the CPU.

The kernels themselves run only on a GPU (tests/test_torch_cuda.py); these
tests need neither a GPU nor JAX."""

import numpy as np
import pytest
import torch

from diffudf_tpu_torch.fields.siren import SirenSpec, init_siren, params_from_jax
from diffudf_tpu_torch.ops import kernel_io as kio
from diffudf_tpu_torch.ops import vgh as tv

SMS = 132  # an H100 SXM
# chip_smoke.py's gate on a kernel's distance from the float64 plain version:
# at most WITNESS times the float32 plain version's, in max and in RMS
WITNESS = 2.0
# points a tile, output columns, tensor-core products (K1 sums in FP32 FMA)
KERNELS = {"K1": (8, 16, False), "K3a": (16, 8, True)}


def _plan(kernel, h, n_mm, n):
    tile, cols, tf32 = KERNELS[kernel]
    return kio.FwdPlan(tile=tile, cols=cols, tf32=tf32, h=h, n_mm=n_mm, n=n, sms=SMS)


# K1 at the s1 step's 9,990 surface rows, the slice figure's 262,144 points
# and the N=256 extraction's 711,714; K3a at the s1 step's 19,980 rows
@pytest.mark.parametrize("kernel,n,tiles", [("K1", 9990, 1249), ("K1", 262144, 32768),
                                            ("K1", 711714, 88965), ("K3a", 19980, 1249)])
def test_plan_at_the_main_path_shapes(kernel, n, tiles):
    tile, cols, tf32 = KERNELS[kernel]
    p = _plan(kernel, 256, 7, n)
    assert p.n_tiles == tiles == -(-n // tile)
    assert p.grid == 132
    # W of each hidden layer in fragment order, one orientation; K1 reads W
    assert p.frag == (7 * 256 * 256 if tf32 else 0)
    weights = 4 * 256 + 7 * (256 * 256 + 256) + 256 + 1
    assert p.bytes_moved == 4 * (n * (3 + cols) + weights + 2 * p.frag)
    # a spec with a different hidden depth and width goes through forward_plan
    q = kio.forward_plan(SirenSpec(hidden=(96,) * 3), n, tile, cols, tf32, SMS)
    assert (q.h, q.n_mm, q.frag) == (96, 2, 2 * 96 * 96 if tf32 else 0)
    waves = tiles / 132
    print(f"{kernel} at {n} points: {tiles} tiles, {waves:.2f} waves of 132 CTAs, "
          f"{p.bytes_moved / 1e6:.3f} MB a launch")


def test_the_training_shapes_leave_a_ragged_last_wave():
    """1,249 tiles on 132 CTAs: 61 CTAs take 10 tiles and 71 take 9."""
    for kernel, n in (("K1", 9990), ("K3a", 19980)):
        p = _plan(kernel, 256, 7, n)
        per_cta = [len(range(c, p.n_tiles, p.grid)) for c in range(p.grid)]
        assert (per_cta.count(10), per_cta.count(9)) == (61, 71)
        # x and the output (76 and 44 bytes a point), the weights (461,825
        # floats) and, for K3a, twice the fragments (7 x 256^2 floats)
        io = {"K1": 9990 * 76, "K3a": 19980 * 44}[kernel]
        frag = {"K1": 0, "K3a": 2 * 4 * 458_752}[kernel]
        assert p.bytes_moved == io + 4 * 461_825 + frag


@pytest.mark.parametrize("kernel", ["K1", "K3a"])
@pytest.mark.parametrize("h,n_mm,n", [(32, 3, 1001), (96, 2, 1003), (160, 2, 333),
                                      (64, 2, 5), (64, 0, 1001), (256, 7, 1), (256, 7, 9990)])
def test_plan_covers_every_point_once(kernel, h, n_mm, n):
    """CTA c of the persistent grid takes tiles c, c + grid, ... and writes
    the points of each below n: every point exactly once, for every width
    the kernels take, a ragged last tile, n below one tile and no hidden
    product."""
    p = _plan(kernel, h, n_mm, n)
    assert 1 <= p.grid <= min(SMS, p.n_tiles)
    assert p.frag == (n_mm * h * h if KERNELS[kernel][2] else 0)
    hits = np.zeros(n, dtype=np.int64)
    for c in range(p.grid):
        for t in range(c, p.n_tiles, p.grid):
            base = t * p.tile
            hits[base:min(base + p.tile, n)] += 1
    assert (hits == 1).all()


def test_plan_for_no_points_launches_nothing():
    p = _plan("K1", 256, 7, 0)
    assert p.n_tiles == 0 and p.grid == 0


def test_3xtf32_forward_against_float64():
    """K1's arithmetic with its hidden products as the tensor-core kernels
    form them (kio.matmul_3xtf32: K2's forward recompute of the same rows),
    at 4x64 on 2,048 points: for f, g and h6 its largest and RMS distance
    from the float64 plain version stay within WITNESS times the float32
    plain version's, chip_smoke.py's witness gate."""
    spec = SirenSpec(hidden=(64,) * 4)
    params = params_from_jax(init_siren(spec, np.random.default_rng(0)), "cpu")
    x = torch.as_tensor(np.random.default_rng(1).uniform(-1, 1, (2048, 3)), dtype=torch.float32)
    p64 = [{k: v.double() for k, v in layer.items()} for layer in params]
    got = tv.vgh_reference(params, spec, x, product=kio.matmul_3xtf32)
    want = tv.vgh_reference(params, spec, x)
    exact = tv.vgh_reference(p64, spec, x.double())
    for k, a, b, e in zip(("f", "g", "h6"), got, want, exact):
        e3, e32 = (a.double() - e).abs(), (b.double() - e).abs()
        ratio_max = float(e3.max() / e32.max())
        ratio_rms = float(e3.square().mean().sqrt() / e32.square().mean().sqrt())
        print(f"{k}: 3xTF32 / float32 distance from float64: max {ratio_max:.3f}, "
              f"RMS {ratio_rms:.3f}")
        assert ratio_max <= WITNESS and ratio_rms <= WITNESS, k


def test_k1_alone_is_built_without_fma_contraction(monkeypatch):
    """K1's elementwise arithmetic rounds op by op as its plain version's
    (its h6 element gate on fitted nets needs it): its library alone is
    built with -fmad=false; K2, K3a and K3b keep nvcc's contraction."""
    from diffudf_tpu_torch.ops import vg as tg

    seen = {}
    for mod in (tv, tg):
        monkeypatch.setattr(mod, "build_shared", lambda name, cmd, srcs: seen.setdefault(name, cmd))
    tv.build(), tv.build_bwd(), tg.build()
    assert seen["vgh"][-1] == "-fmad=false"
    assert "-fmad=false" not in seen["vgh_bwd"] + seen["vg"]
    assert seen["vgh"][:-1] == seen["vg"]
