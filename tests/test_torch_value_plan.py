"""The host side of K4 (``csrc/value.cu`` on ``csrc/siren_fwd.cuh``) and of
K5 (``csrc/min_distance.cu``): K4's launch plan (``ops/kernel_io.py::
ValuePlan``: tile, grid, shared memory, bytes) at the march's buckets and
at every width the kernels take, the bf16 fragment order its tensor-core
product reads (``value_fragments``), the weights laid out once per trace,
and a torch rehearsal of the bf16 product as the kernel blocks it, held to
the JAX Pallas value kernel in interpret mode and to ``value_reference``.

The kernels themselves run only on a GPU (tests/test_torch_cuda.py)."""

import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffudf_tpu.ops.pallas_value as pval
from diffudf_tpu.fields.siren import SirenSpec as JaxSpec
from diffudf_tpu_torch.fields.siren import SirenSpec, init_siren, params_from_jax
from diffudf_tpu_torch.ops import kernel_io as kio
from diffudf_tpu_torch.ops import min_distance as tmd
from diffudf_tpu_torch.ops import value as tval
from diffudf_tpu_torch.ops.sincos import fast_sin
from diffudf_tpu_torch.render import tracer

torch.set_num_threads(2)

SMS = 132  # an H100 SXM
BF16_TOL = 2e-3  # tests/test_pallas.py::TestPallasValue, bf16


def _plan(n, h=256, n_mm=7, mixed=True):
    return kio.value_plan(SirenSpec(hidden=(h,) * (n_mm + 1)), n, mixed, SMS)


# the compacted march's buckets: powers of 4 from 1,024 to the first round's
# 65,536 (PR 6's torus at 720x720); tiles chosen so that each spreads over
# the SMs with the fewest rows a CTA
@pytest.mark.parametrize("n,tile,grid", [(65536, 128, 132), (16384, 128, 128),
                                         (4096, 32, 128), (1024, 16, 64)])
def test_plan_at_the_march_buckets(n, tile, grid):
    for mixed in (True, False):
        p = _plan(n, mixed=mixed)
        assert (p.tile, p.grid, p.n_tiles) == (tile, grid, n // tile)
        w = (2 if mixed else 4) * 7 * 256 * 256
        assert p.w_bytes == w
        # x and f, W once, and w1, b1, the hidden biases, W_last and b_last
        assert p.bytes_moved == 16 * n + w + 4 * (3 * 256 + 256 + 7 * 256 + 256 + 1)
        # every tile reads all of W from L2
        assert p.l2_bytes == (n // tile) * w
    # at the first bucket: 0.47 GB of bf16 W from L2, 0.94 GB at 64-point tiles
    assert _plan(65536).l2_bytes == 512 * 917504


@pytest.mark.parametrize("tile", kio.VALUE_TILES)
@pytest.mark.parametrize("h", [32, 64, 96, 128, 160, 192, 224, 256])
def test_plan_shared_memory_fits_one_cta(tile, h):
    """The bf16 carry (T rows of h + 8) and every warp's 8-deep fragment
    ring; the float32 mode's transposed carry and 3 x 16 rows of W: each
    with the static arrays (x and the head's partial sums) within an SM's
    232,448 bytes."""
    static = 4 * (3 * tile + tile * 8)
    for mixed, want in ((True, 2 * tile * (h + 8) + (h // 32) * 8 * 2048),
                        (False, 4 * (h * 8 * -(-(tile // 8) // 4) * 4 + 3 * 16 * h))):
        p = kio.ValuePlan(tile=tile, mixed=mixed, h=h, n_mm=3, n=1000, sms=SMS)
        assert p.smem_bytes == want
        assert p.smem_bytes + static <= 232448
    assert kio.ValuePlan(tile=128, mixed=True, h=256, n_mm=7, n=1, sms=SMS).smem_bytes == 198656


@pytest.mark.parametrize("n", [1, 5, 16, 17, 1001, 4095, 70000])
def test_plan_covers_every_point_once(n):
    """The persistent grid's walk: CTA c takes tiles c, c + grid, ...; every
    point lands in exactly one tile, n below one tile too."""
    p = _plan(n, h=96, n_mm=2)
    assert 1 <= p.grid <= min(SMS, p.n_tiles)
    hits = np.zeros(n, dtype=np.int64)
    for c in range(p.grid):
        for t in range(c, p.n_tiles, p.grid):
            hits[t * p.tile:min((t + 1) * p.tile, n)] += 1
    assert (hits == 1).all()


def test_fragments_follow_the_mma_b_layout():
    """value_fragments against mma.sync.m16n8k16's B fragment written out:
    lane 4g + t4 of 8-column tile u holds, for k-step 16 ks of k-pair p,
    b0 = W[k0 + 2 t4 + (0, 1)][n] and b1 = W[k0 + 8 + 2 t4 + (0, 1)][n]
    with n = 8u + g and k0 = 32p + 16 ks."""
    n_mm, h = 2, 64
    w = torch.arange(n_mm * h * h, dtype=torch.float32).reshape(n_mm, h, h)
    frag = kio.value_fragments(w)
    assert frag.shape == (n_mm, h // 32, h // 8, 32, 8)
    for l in range(n_mm):
        for p in range(h // 32):
            for u in range(h // 8):
                for lane in range(32):
                    g, t4 = lane // 4, lane % 4
                    want = [w[l, 32 * p + 16 * ks + 8 * i + 2 * t4 + e, 8 * u + g]
                            for ks in (0, 1) for i in (0, 1) for e in (0, 1)]
                    assert frag[l, p, u, lane].tolist() == [float(v) for v in want]


def _from_fragments(frag, h):
    """W (n_mm, h, h) read back from the fragments by the kernel's indexing."""
    n_mm = frag.shape[0]
    w = torch.empty((n_mm, h, h), dtype=frag.dtype)
    lane = torch.arange(32)
    g, t4 = lane // 4, lane % 4
    for p in range(h // 32):
        for u in range(h // 8):
            for r, (ks, i, e) in enumerate((ks, i, e) for ks in (0, 1) for i in (0, 1)
                                           for e in (0, 1)):
                w[:, 32 * p + 16 * ks + 8 * i + 2 * t4 + e, 8 * u + g] = frag[:, p, u, :, r]
    return w


def _kernel_blocked_value(weights: tval.ValueWeights, spec, x):
    """K4's bf16 mode as the kernel blocks it: the first layer in float32,
    each hidden product on the bf16 carry and W read back from the
    fragments, summed in float32 over k-steps of 16 in turn onto 0 (the
    mma.sync chain: a k-step's 16 products are exact in float32), the head
    on the bf16 carry and the bf16-rounded W_last."""
    h, n_mm = spec.hidden[0], len(spec.hidden) - 1
    w0, ww = kio.freqs(spec)
    a = fast_sin(w0 * (x @ weights.w1 + weights.b1))
    w = _from_fragments(weights.w, h).float() if n_mm else None
    for l in range(n_mm):
        ab = a.to(torch.bfloat16).float()
        m = torch.zeros_like(a)
        for k in range(0, h, 16):
            m = m + ab[:, k:k + 16] @ w[l, k:k + 16]
        a = fast_sin(ww * (m + weights.bh[l]))
    return (a.to(torch.bfloat16).float() @ weights.wl)[:, 0] + weights.bl[0]


@pytest.fixture(scope="module")
def net():
    """4x64 net and 1024 points, one tile of the Pallas kernel."""
    hidden = (64,) * 4
    np_params = init_siren(SirenSpec(hidden=hidden), np.random.default_rng(0))
    x = np.random.default_rng(1).uniform(-1, 1, (1024, 3)).astype(np.float32)
    return SirenSpec(hidden=hidden), JaxSpec(hidden=hidden), np_params, x


def test_bf16_product_rehearsal_matches_pallas_and_plain(net, monkeypatch):
    """The blocked bf16 product against the JAX package's Pallas value
    kernel in interpret mode (bf16) and against value_reference, at the
    Pallas value test's 2e-3."""
    spec, jspec, np_params, x = net
    orig = pl.pallas_call

    def interp_call(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(pval.pl, "pallas_call", interp_call)
    jparams = [{k: jnp.asarray(v) for k, v in layer.items()} for layer in np_params]
    want = np.asarray(pval.value_pallas(jparams, jspec, jnp.asarray(x), tile=1024,
                                        compute_dtype=jnp.bfloat16))
    params = params_from_jax(np_params, "cpu")
    xt = torch.from_numpy(x)
    got = _kernel_blocked_value(tval.prepare(params, spec, torch.bfloat16), spec, xt)
    plain = tval.value_reference(params, spec, xt, compute_dtype=torch.bfloat16)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=BF16_TOL)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0, atol=BF16_TOL)


@pytest.mark.parametrize("hidden", [(32,), (32,) * 3, (64,) * 3])
def test_prepared_weights(hidden):
    """prepare() in each mode: float32 W stacked, or its bf16 fragments
    that read back to W rounded to bf16; W_last rounded in the bf16 mode
    alone; a net with no hidden product (n_mm = 0) too."""
    spec = SirenSpec(hidden=hidden)
    params = params_from_jax(init_siren(spec, np.random.default_rng(2)), "cpu")
    h, n_mm = hidden[0], len(hidden) - 1
    f32 = tval.prepare(params, spec)
    bf = tval.prepare(params, spec, torch.bfloat16)
    assert not f32.mixed and bf.mixed
    assert torch.equal(f32.wl, params[-1]["w"])
    assert torch.equal(bf.wl, params[-1]["w"].to(torch.bfloat16).float())
    if n_mm:
        wh = torch.stack([p["w"] for p in params[1:-1]])
        assert torch.equal(f32.w, wh)
        assert bf.w.dtype == torch.bfloat16 and bf.w.is_contiguous()
        assert torch.equal(_from_fragments(bf.w, h), wh.to(torch.bfloat16))
    with pytest.raises(ValueError):
        tval.prepare(params_from_jax(init_siren(SirenSpec(hidden=(48,) * 2),
                                                np.random.default_rng(0)), "cpu"),
                     SirenSpec(hidden=(48,) * 2))


def test_march_lays_out_k4_weights_once_per_trace(net, monkeypatch):
    """trace_rays_compacted prepares K4's weights once and hands the same
    object to every launch of the march."""
    spec, _, np_params, _ = net
    params = params_from_jax(np_params, "cpu")
    prepared, seen = [], []
    real_prepare, real_value = tval.prepare, tval.value

    def prepare(*a, **k):
        prepared.append(real_prepare(*a, **k))
        return prepared[-1]

    def value(*a, weights=None, **k):
        seen.append(weights)
        return real_value(*a, weights=weights, **k)

    monkeypatch.setattr(tval, "prepare", prepare)
    monkeypatch.setattr(tval, "value", value)
    rng = np.random.default_rng(5)
    n = 300
    rays = rng.normal(size=(n, 3)).astype(np.float32)
    rays /= np.linalg.norm(rays, axis=1, keepdims=True)
    origins = (-0.9 * rays).astype(np.float32)
    _, _, it = tracer.trace_rays_compacted(params, spec, origins, rays, np.ones(n, bool),
                                           gt_mode="tanh", alpha=10.0, surface_threshold=1e-3,
                                           max_iterations=12, segment=4, use_pallas=True)
    assert len(prepared) == 1 and prepared[0].mixed
    assert len(seen) == it and all(w is prepared[0] for w in seen)


@pytest.mark.parametrize("m,tile,floats", [(1, 1024, 4096), (1024, 1024, 4096),
                                           (1025, 1024, 8192), (100000, 1024, 401408)])
def test_k5_workspace_holds_whole_tiles(m, tile, floats):
    assert tmd.workspace_floats(m, tile) == floats
