"""The port's CUDA kernels (K1, K2, K3a, K3b, K4, K5) against their plain
torch versions, on a GPU, the paths that run them (the auxiliary
regularisers among them), the device sign relaxation, and the plain path
for nets the kernels do not take.

Marked ``cuda``; each test skips without a CUDA device.  This file imports
neither jax nor the JAX package, so it also runs on a machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from diffudf_tpu_torch.fields.siren import SirenSpec, init_siren, params_from_jax
from diffudf_tpu_torch.ops import min_distance as tmd
from diffudf_tpu_torch.ops import value as tval
from diffudf_tpu_torch.ops import value_vjp as tvv
from diffudf_tpu_torch.ops import vg as tg
from diffudf_tpu_torch.ops import vgh as tv

# tests/test_pallas.py::TestPallasVGH::test_matches_reference
TOL = {"f": 1e-5, "g": 1e-4, "h6": 5e-3}


@pytest.mark.cuda
@pytest.mark.parametrize("hidden,n", [((256,) * 8, 65536), ((64,) * 3, 1001)])
def test_vgh_kernel_matches_plain_version(hidden, n):
    """K1 against vgh_reference on the card, a ragged last tile included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 has no CPU mode")
    spec = SirenSpec(hidden=hidden)
    params = params_from_jax(init_siren(spec, np.random.default_rng(0)), "cuda")
    x = torch.as_tensor(np.random.default_rng(1).uniform(-1, 1, (n, 3)), dtype=torch.float32,
                        device="cuda")
    before = tv.launches
    got = tv.vgh(params, spec, x)
    torch.cuda.synchronize()
    assert tv.launches == before + 1
    for k, a, b in zip(("f", "g", "h6"), got, tv.vgh_reference(params, spec, x)):
        assert float((a - b).abs().max()) <= TOL[k], k


# Backward kernels against their plain versions: each gradient element
# within GTOL * max(max |plain grad of that param|, 1) + RTOL * |plain|.
# GTOL is the Pallas gradcheck's (tests/test_pallas.py: 2e-5 for the vgh
# VJP, 1e-5 for the vg VJP); RTOL covers float32 sums taken in another order
# over thousands of rows.
GTOL = {"vgh_bwd": 2e-5, "vg_bwd": 1e-5}
RTOL = 1e-4


def _case(hidden, n, seed=0):
    spec = SirenSpec(hidden=hidden)
    params = params_from_jax(init_siren(spec, np.random.default_rng(seed)), "cuda")
    rng = np.random.default_rng(seed + 1)
    x = torch.as_tensor(rng.uniform(-1, 1, (n, 3)), dtype=torch.float32, device="cuda")
    cot = torch.as_tensor(rng.normal(size=(n, 16)), dtype=torch.float32, device="cuda")
    return spec, params, x, cot


def _bwd(kernel, cot):
    """(module, wrapper, plain version, cotangent) of a backward kernel."""
    if kernel == "vgh_bwd":
        c = cot.clone()
        c[:, 10:] = 0
        return tv, tv.vgh_bwd, tv.vgh_bwd_reference, c
    c = cot[:, :8].contiguous()
    c[:, 4:] = 0
    return tg, tg.vg_bwd, tg.vg_bwd_reference, c


def _grad_errors(got, want, gtol):
    """Worst |kernel - plain| / limit over each param tensor."""
    worst = 0.0
    for g, w in zip(got, want):
        for k in ("w", "b"):
            limit = gtol * max(float(w[k].abs().max()), 1.0) + RTOL * w[k].abs()
            worst = max(worst, float(((g[k] - w[k]).abs() / limit).max()))
    return worst


@pytest.mark.cuda
@pytest.mark.parametrize("hidden,n", [((256,) * 8, 9990), ((64,) * 3, 1001)])
def test_vg_kernel_matches_plain_version(hidden, n):
    """K3a against vg_reference on the card, a ragged last tile included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K3a has no CPU mode")
    spec, params, x, _ = _case(hidden, n)
    before = tg.launches
    got = tg.vg(params, spec, x)
    torch.cuda.synchronize()
    assert tg.launches == before + 1
    for k, a, b in zip(("f", "g"), got, tg.vg_reference(params, spec, x)):
        assert float((a - b).abs().max()) <= TOL[k], k


# The forward kernels K1 and K3a (csrc/siren_fwd.cuh: K1's products in FP32
# FMA, K3a's in 3xTF32) at every width class the tiling treats apart: each
# output element within TOL + RTOL * |plain| of the plain version, the
# element gate of chip_smoke.py's phase 8.
FWD = {"vgh": (tv, tv.vgh, tv.vgh_reference, ("f", "g", "h6")),
       "vg": (tg, tg.vg, tg.vg_reference, ("f", "g"))}


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["vgh", "vg"])
@pytest.mark.parametrize("hidden,n", [
    ((32,) * 4, 1001),   # one warp a CTA; a ragged last tile of 8 and of 16
    ((96,) * 3, 1003),
    ((160,) * 3, 333),
    ((64,) * 3, 5),      # fewer points than one tile
    ((64,), 1001),       # one hidden layer: no hidden product (n_mm = 0)
])
def test_forward_kernel_matches_plain_version(kernel, hidden, n):
    """K1 / K3a against their plain versions on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 and K3a have no CPU mode")
    mod, fn, plain, names = FWD[kernel]
    spec, params, x, _ = _case(hidden, n)
    before = mod.launches
    got = fn(params, spec, x)
    torch.cuda.synchronize()
    assert mod.launches == before + 1
    for k, a, b in zip(names, got, plain(params, spec, x)):
        assert a.shape == b.shape
        assert float(((a - b).abs() / (TOL[k] + RTOL * b.abs())).max()) <= 1.0, k


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["vgh", "vg"])
def test_forward_kernel_is_bit_reproducible(kernel):
    """Two launches on the same input give the same bits: one writer per
    output element, a fixed-order head sum, no atomics."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, fn, _, _ = FWD[kernel]
    spec, params, x, _ = _case((256,) * 8, 9990, seed=4)
    first = fn(params, spec, x)
    second = fn(params, spec, x)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["vgh_bwd", "vg_bwd"])
@pytest.mark.parametrize("hidden,n", [
    ((256,) * 8, 9990),  # the training shape, a ragged last tile of 8 and of 16
    ((64,) * 3, 1001),
    ((32,) * 4, 1001),   # one warp a CTA
    ((96,) * 3, 1003),   # a W-bar block of 128 rows and columns, 96 of them used
    ((160,) * 3, 333),   # a second W-bar block, 32 of its 128 used
    ((64,) * 3, 5),      # fewer points than one tile
    ((64,), 1001),       # one hidden layer: no hidden product (n_mm = 0)
])
def test_backward_kernel_matches_plain_version(kernel, hidden, n):
    """K2 / K3b against their plain versions on the card: every width class
    the tiling treats apart, ragged N, N below one tile, no hidden product."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K2 and K3b have no CPU mode")
    spec, params, x, cot = _case(hidden, n)
    mod, fn, plain, c = _bwd(kernel, cot)
    before = mod.bwd_launches
    got = fn(params, spec, x, c)
    torch.cuda.synchronize()
    assert mod.bwd_launches == before + 1
    assert _grad_errors(got, plain(params, spec, x, c), GTOL[kernel]) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["vgh_bwd", "vg_bwd"])
def test_backward_kernel_is_bit_reproducible(kernel):
    """Two launches on the same input give the same bits: partial sums per
    CTA and a fixed-order reduction, no float atomics."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spec, params, x, cot = _case((256,) * 8, 9990, seed=4)
    _, fn, _, c = _bwd(kernel, cot)
    first = fn(params, spec, x, c)
    second = fn(params, spec, x, c)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a["w"], b["w"]) and torch.equal(a["b"], b["b"])


# s2's value pair (ops/value_vjp.py) against its plain versions: f element by
# element within TOL["f"] + RTOL * |plain|, the gradient under K3b's gate.
@pytest.mark.cuda
@pytest.mark.parametrize("hidden,n", [
    ((256,) * 8, 9990),  # a training batch's surface rows: 125 tiles of 80
    ((256,) * 8, 4999),  # ragged, tiles of 16
    ((64,) * 3, 1001),
    ((32,) * 4, 1001),   # one warp a CTA
    ((160,) * 3, 333),   # a second W-bar block, 32 of its 128 used
    ((64,) * 3, 0),      # a data-parallel rank with no surface rows
    ((64,), 1001),       # one hidden layer: no hidden product (n_mm = 0)
])
def test_value_vjp_kernels_match_plain_version(hidden, n):
    """The forward and its VJP against value_vjp_reference and
    value_vjp_bwd_reference on the card; one launch each (none at N = 0,
    where the gradient is zero)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the pair has no CPU mode")
    spec, params, x, cot = _case(hidden, n)
    fbar = cot[:, 0].contiguous()
    before = (tvv.launches, tvv.bwd_launches)
    f, saved = tvv.value_vjp_fwd(params, spec, x)
    got = tvv.value_vjp_bwd(params, spec, x, saved, fbar)
    torch.cuda.synchronize()
    assert (tvv.launches, tvv.bwd_launches) == (before[0] + (n > 0), before[1] + (n > 0))
    f_ref, saved_ref = tvv.value_vjp_reference(params, spec, x)
    assert f.shape == f_ref.shape
    if n:
        assert float(((f - f_ref).abs() / (TOL["f"] + RTOL * f_ref.abs())).max()) <= 1.0
    want = tvv.value_vjp_bwd_reference(params, spec, x, saved_ref, fbar)
    if n:
        assert _grad_errors(got, want, GTOL["vg_bwd"]) <= 1.0
    else:
        assert all(float(g[k].abs().max()) == 0.0 for g in got for k in ("w", "b"))


@pytest.mark.cuda
def test_value_vjp_kernels_are_bit_reproducible():
    """Two launches of the pair on the same input give the same bits: one
    writer per output element, per-CTA partials added in a fixed order, no
    float atomics."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spec, params, x, cot = _case((256,) * 8, 9990, seed=4)
    fbar = cot[:, 0].contiguous()
    runs = []
    for _ in range(2):
        f, saved = tvv.value_vjp_fwd(params, spec, x)
        runs.append((f, tvv.value_vjp_bwd(params, spec, x, saved, fbar)))
    torch.cuda.synchronize()
    (f1, g1), (f2, g2) = runs
    assert torch.equal(f1, f2)
    for a, b in zip(g1, g2):
        assert torch.equal(a["w"], b["w"]) and torch.equal(a["b"], b["b"])


# K4 against value_reference, element by element: TOL + RTOL * |plain|, TOL
# the Pallas value test's (tests/test_pallas.py: f32 1e-5, bf16 2e-3).
K4_TOL = {"f32": 1e-5, "bf16": 2e-3}
K4_DTYPE = {"f32": None, "bf16": torch.bfloat16}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["f32", "bf16"])
@pytest.mark.parametrize("hidden,n", [((256,) * 8, 262144), ((64,) * 3, 1001)])
def test_value_kernel_matches_plain_version(hidden, n, mode):
    """K4 against value_reference on the card, at the march's first bucket
    and on a ragged last tile."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K4 has no CPU mode")
    spec, params, x, _ = _case(hidden, n)
    before = (tval.launches, tval.points)
    got = tval.value(params, spec, x, compute_dtype=K4_DTYPE[mode])
    torch.cuda.synchronize()
    assert (tval.launches, tval.points) == (before[0] + 1, before[1] + n)
    want = tval.value_reference(params, spec, x, compute_dtype=K4_DTYPE[mode])
    assert float(((got - want).abs() / (K4_TOL[mode] + RTOL * want.abs())).max()) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_value_kernel_is_bit_reproducible(mode):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spec, params, x, _ = _case((256,) * 8, 65536, seed=4)
    first = tval.value(params, spec, x, compute_dtype=K4_DTYPE[mode])
    second = tval.value(params, spec, x, compute_dtype=K4_DTYPE[mode])
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def _k4_gate(got, want, mode):
    return float(((got - want).abs() / (K4_TOL[mode] + RTOL * want.abs())).max())


# the march's buckets at 8x256; widths 32-256 with a ragged last tile; n
# below one tile; a net with no hidden product (n_mm = 0)
@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["f32", "bf16"])
@pytest.mark.parametrize("hidden,n", [((256,) * 8, 1024), ((256,) * 8, 4096),
                                      ((256,) * 8, 16384), ((256,) * 8, 65536),
                                      ((32,) * 4, 3001), ((96,) * 3, 1001), ((160,) * 3, 777),
                                      ((256,) * 3, 2049), ((64,) * 3, 5), ((64,), 1000)])
def test_value_kernel_at_the_march_buckets_and_widths(hidden, n, mode):
    """K4 on the tile design against value_reference: every tile size the
    plan picks, every width class, ragged and tiny n, n_mm = 0; weights laid
    out once (as the march does) give the same bits as weights laid out by
    the launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K4 has no CPU mode")
    spec, params, x, _ = _case(hidden, n, seed=len(hidden) + n)
    dt = K4_DTYPE[mode]
    weights = tval.prepare(params, spec, compute_dtype=dt)
    before = (tval.launches, tval.points, tval.launches_at[n])
    got = tval.value(params, spec, x, compute_dtype=dt, weights=weights)
    again = tval.value(params, spec, x, compute_dtype=dt)
    torch.cuda.synchronize()
    assert (tval.launches, tval.points, tval.launches_at[n]) == (
        before[0] + 2, before[1] + 2 * n, before[2] + 2)
    assert torch.equal(got, again)
    want = tval.value_reference(params, spec, x, compute_dtype=dt)
    assert got.shape == (n,) and bool(torch.isfinite(got).all())
    assert _k4_gate(got, want, mode) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_value_kernel_bits_do_not_depend_on_the_tile(mode):
    """A point's f sums in the same order at every tile size: the first
    1,024 points of a 65,536-point launch (tiles of 128) and a 1,024-point
    launch (tiles of 16) give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from diffudf_tpu_torch.ops import kernel_io as kio

    spec, params, x, _ = _case((256,) * 8, 65536, seed=6)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tiles = {kio.value_plan(spec, n, mode == "bf16", sms).tile for n in (65536, 4096, 1024)}
    assert len(tiles) == 3
    full = tval.value(params, spec, x, compute_dtype=K4_DTYPE[mode])
    for n in (4096, 1024):
        part = tval.value(params, spec, x[:n].contiguous(), compute_dtype=K4_DTYPE[mode])
        torch.cuda.synchronize()
        assert torch.equal(part, full[:n]), n


@pytest.mark.cuda
def test_value_plan_shared_memory_matches_the_library():
    """ValuePlan.smem_bytes against the library's own value_smem for every
    tile, width and mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from diffudf_tpu_torch.ops import kernel_io as kio

    lib = tval._lib()
    for tile in kio.VALUE_TILES:
        for h in range(32, 257, 32):
            for mixed in (False, True):
                p = kio.ValuePlan(tile=tile, mixed=mixed, h=h, n_mm=2, n=1, sms=132)
                assert lib.value_smem(tile, h, int(mixed)) == p.smem_bytes, (tile, h, mixed)
    assert lib.value_smem(8, 256, 1) == -1


@pytest.mark.cuda
def test_wide_net_takes_the_plain_path():
    """A 512-wide net is beyond the kernels (at most 256 columns): on the
    card evaluate_field runs the plain Taylor-mode path and launches no K1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from diffudf_tpu_torch.autodiff.ops import value_grad_hessian_packed
    from diffudf_tpu_torch.ops.evaluate import evaluate_field

    spec, params, x, _ = _case((512,) * 3, 4096)
    before = tv.launches
    ev = evaluate_field(params, spec, x, want_hess=True)
    torch.cuda.synchronize()
    assert tv.launches == before
    f, g, _ = value_grad_hessian_packed(params, spec, x)
    assert torch.equal(ev.f, f) and torch.equal(ev.grad, g)
    assert bool(torch.isfinite(ev.hess).all())


def _torus_cloud(m, rng, big=0.55, small=0.22):
    """m points on a torus about the x axis, so the x=0 plane cuts it."""
    u, v = rng.uniform(0, 2 * np.pi, (2, m))
    ring = big + small * np.cos(v)
    return np.stack([small * np.sin(v), ring * np.cos(u), ring * np.sin(u)], 1)


def _plane(width):
    r = np.linspace(1.0, -1.0, width)
    zz, yy = np.meshgrid(r, r, indexing="xy")
    return np.stack([np.zeros_like(zz), yy, zz], -1).reshape(-1, 3)


# K5 against min_distance_reference, element by element, at the Pallas
# distance test's 1e-4 (tests/test_pallas.py::TestPallasDistance), and
# against the plain version in float64 at the same 1e-4.
K5_TOL = 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["gauss_300x3000", "one_query", "ragged_513x2049",
                                  "small_cloud_4097x1000", "torus_plane_65536x100000"])
def test_min_distance_kernel_matches_plain_version(case):
    """K5 against its plain version and the float64 witness: Q = 1, Q not a
    multiple of 512, M below and not a multiple of 2048, and near-surface
    plane queries against a torus cloud."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K5 has no CPU mode")
    rng = np.random.default_rng(0)
    if case == "torus_plane_65536x100000":
        q, cloud = _plane(256), _torus_cloud(100000, rng)
    else:
        n, m = {"gauss_300x3000": (300, 3000), "one_query": (1, 3000),
                "ragged_513x2049": (513, 2049), "small_cloud_4097x1000": (4097, 1000)}[case]
        cloud, q = rng.normal(size=(m, 3)), rng.normal(size=(n, 3))
    q = torch.as_tensor(q, dtype=torch.float32, device="cuda")
    cloud = torch.as_tensor(cloud, dtype=torch.float32, device="cuda")
    before = (tmd.launches, tmd.queries)
    got = tmd.min_distance(q, cloud)
    torch.cuda.synchronize()
    assert (tmd.launches, tmd.queries) == (before[0] + 1, before[1] + len(q))
    torch.backends.cuda.matmul.allow_tf32 = False
    want = tmd.min_distance_reference(q, cloud)
    exact = tmd.min_distance_reference(q.double(), cloud.double())
    assert got.shape == (len(q),) and bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= K5_TOL
    assert float((got.double() - exact).abs().max()) <= K5_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("nq,m", [(1023, 5000), (2049, 1024), (3001, 1025), (4095, 3)])
def test_min_distance_kernel_at_ragged_query_blocks(nq, m):
    """Odd query counts, none a multiple of K5's queries a CTA (a power of
    two), so the last CTA masks some of its queries; clouds of one tile,
    one point past a tile and below a tile's 64-point groups."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K5 has no CPU mode")
    rng = np.random.default_rng(nq + m)
    q = torch.as_tensor(rng.normal(size=(nq, 3)), dtype=torch.float32, device="cuda")
    cloud = torch.as_tensor(rng.normal(size=(m, 3)), dtype=torch.float32, device="cuda")
    got = tmd.min_distance(q, cloud)
    torch.cuda.synchronize()
    torch.backends.cuda.matmul.allow_tf32 = False
    want = tmd.min_distance_reference(q, cloud)
    exact = tmd.min_distance_reference(q.double(), cloud.double())
    assert got.shape == (nq,) and bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= K5_TOL
    assert float((got.double() - exact).abs().max()) <= K5_TOL


@pytest.mark.cuda
def test_point_cloud_distance_launches_k5_once():
    """On the card the figure's oracle is one K5 launch, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from diffudf_tpu_torch.data.mesh_distance import point_cloud_distance

    rng = np.random.default_rng(1)
    q = torch.as_tensor(_plane(64), dtype=torch.float32, device="cuda")
    cloud = torch.as_tensor(_torus_cloud(5000, rng), dtype=torch.float32, device="cuda")
    before = tmd.launches
    d = point_cloud_distance(q, cloud)
    torch.cuda.synchronize()
    assert tmd.launches == before + 1
    assert torch.equal(d, tmd.min_distance(q, cloud))


def _torus_shell(nu=48, nv=24):
    """(T, 3, 3) triangles of the torus shell |(r - 0.6, z)| = 0.25."""
    u, v = np.meshgrid(np.linspace(0, 2 * np.pi, nu, endpoint=False),
                       np.linspace(0, 2 * np.pi, nv, endpoint=False), indexing="ij")
    verts = np.stack([(0.6 + 0.25 * np.cos(v)) * np.cos(u), (0.6 + 0.25 * np.cos(v)) * np.sin(u),
                      0.25 * np.sin(v)], -1).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(nu), np.arange(nv), indexing="ij")
    a, b = i * nv + j, (i + 1) % nu * nv + j
    c, d = (i + 1) % nu * nv + (j + 1) % nv, i * nv + (j + 1) % nv
    faces = np.concatenate([np.stack([a, b, c], -1).reshape(-1, 3),
                            np.stack([a, c, d], -1).reshape(-1, 3)])
    return verts[faces].astype(np.float32)


def _mesh_queries(n, seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(-1.05, 1.05, (n, 3)),
                           0.85 * rng.normal(size=(n, 3)) / np.sqrt(3)]).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("oracle", ["table", "pruned"])
def test_mesh_oracle_on_the_card_matches_the_cpu(oracle):
    """The triangle table and the pruned sweep (float32 centroid ranking,
    TF32 on or off outside) on the card within 1e-6 of the CPU results."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from diffudf_tpu_torch.data import mesh_distance as md

    tris, q = _torus_shell(), _mesh_queries(3000, 2)
    if oracle == "table":
        cand = md.build_candidate_grid(tris, g=24)
        run = lambda dev: md.point_triangle_distance_table(  # noqa: E731
            torch.as_tensor(q, device=dev),
            md.build_triangle_table(torch.as_tensor(tris, device=dev), cand), g=24)
    else:
        run = lambda dev: md.point_triangle_distance_pruned(  # noqa: E731
            torch.as_tensor(q, device=dev), torch.as_tensor(tris, device=dev))
    want = run("cpu")
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True  # the oracle turns it off itself
        got = run("cuda").cpu()
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    assert float((got - want).abs().max()) <= 1e-6


@pytest.mark.cuda
def test_mesh_bootstrap_on_the_card_matches_the_brute_sweep():
    """The bootstrap's blocks of BOOT_SLAB triangles, at a triangle count
    that is no multiple of the slab, against the flat brute sweep."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from diffudf_tpu_torch.data import mesh_distance as md

    tris = torch.as_tensor(_torus_shell(96, 27), device="cuda")  # 5,184 triangles
    assert tris.shape[0] % md.BOOT_SLAB
    q = torch.as_tensor(_mesh_queries(2500, 3), device="cuda")
    got = md.point_triangle_distance_bootstrap(q, tris)
    want = md.point_triangle_distance(q, tris)
    assert float((got - want).abs().max()) <= 1e-6


@pytest.mark.cuda
def test_point_cloud_bootstrap_step_launches_k5_once():
    """A batch of the point-cloud bootstrap sampler: one K5 launch on its far
    rows, whose GT it gives."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from diffudf_tpu_torch.data.sampling import TrainingSampler

    rng = np.random.default_rng(4)
    cloud = _torus_cloud(20000, rng)
    sampler = TrainingSampler.from_point_cloud_bootstrap(cloud, np.ones_like(cloud), 30000,
                                                         (0.333, 0.666), device="cuda")
    before = tmd.launches
    pts, _, sdf = sampler.sample(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    assert tmd.launches == before + 1
    sz = sampler.sizes
    far = pts[sz.on_surface:sz.on_surface + sz.far].contiguous()
    assert torch.equal(sdf[sz.on_surface:sz.on_surface + sz.far, 0],
                       tmd.min_distance(far, sampler.surface_points))


# Projections (pc/sampler.py, extract/refine.py) on the card against the same
# projections through the plain versions on the card, within the golden
# point-cloud tolerance (tests/test_golden_pc.py), on the fixture's field: a
# 3x32x32x1 net the kernels take, positive everywhere (well-conditioned steps).
PROJ_TOL = 5e-4


def _pc_field():
    import os.path as osp

    g = np.load(osp.join(osp.dirname(__file__), "golden", "pc_golden.npz"))
    params = params_from_jax([{"w": g[f"w{i}"], "b": g[f"b{i}"]} for i in range(3)], "cuda")
    return params, SirenSpec(hidden=(32, 32), w0=float(g["freq_w0"])), float(g["alpha"])


@pytest.mark.cuda
def test_project_points_kernels_match_plain_versions():
    """K3a for each step and K1 for the last, against vg_reference and
    vgh_reference on the card: positions, steps and normals."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from diffudf_tpu_torch.pc.sampler import project_points

    params, spec, alpha = _pc_field()
    x0 = torch.as_tensor(np.random.default_rng(2).uniform(-1, 1, (65537, 3)), dtype=torch.float32,
                         device="cuda")
    kw = dict(gt_mode="tanh", alpha=alpha, num_steps=3, want_hessian_normals=True)
    before = (tg.launches, tv.launches)
    x, step, nrm = project_points(params, spec, x0, **kw)
    torch.cuda.synchronize()
    assert (tg.launches, tv.launches) == (before[0] + 2, before[1] + 1)
    px, pstep, pnrm = project_points(params, spec, x0, vg_fn=tg.vg_reference,
                                     vgh_fn=tv.vgh_reference, **kw)
    assert float((x - px).abs().max()) <= PROJ_TOL
    assert float((step - pstep).abs().max()) <= PROJ_TOL
    assert float(((nrm * pnrm).sum(1).abs() > 0.999).float().mean()) >= 0.99


@pytest.mark.cuda
def test_refine_vertices_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from diffudf_tpu_torch.extract.refine import refine_vertices

    params, spec, alpha = _pc_field()
    verts = np.random.default_rng(3).uniform(-1, 1, (20001, 3)).astype(np.float32)
    kw = dict(gt_mode="tanh", alpha=alpha, N=256, steps=2)
    before = tg.launches
    got = refine_vertices(params, spec, verts, **kw)
    assert tg.launches == before + 2
    want = refine_vertices(params, spec, verts, vg_fn=tg.vg_reference, **kw)
    assert np.abs(got - want).max() <= PROJ_TOL
    assert np.linalg.norm(got - verts, axis=1).max() <= 0.5 * 2 / 255 + 1e-6


@pytest.mark.cuda
def test_point_cloud_round_launches():
    """One round of generate_point_cloud at ref_steps 3: K3a twice, K1 once,
    as its stats record them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import warnings

    from diffudf_tpu_torch.pc.sampler import generate_point_cloud

    params, spec, alpha = _pc_field()
    stats = {}
    before = (tg.launches, tv.launches)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        generate_point_cloud(params, spec, gt_mode="tanh", alpha=alpha, num_steps=3,
                             num_points=10000, surf_thresh=0.2, max_iter=1, stats=stats)
    assert (tg.launches - before[0], tv.launches - before[1]) == (2, 1)
    assert (stats["rounds"], stats["k3a_launches"], stats["k1_launches"]) == (1, 2, 1)


def _regulariser_case(hidden, n, seed=4):
    spec = SirenSpec(hidden=hidden)
    p = init_siren(spec, np.random.default_rng(seed))
    rng = np.random.default_rng(seed + 1)
    x = torch.as_tensor(rng.uniform(-1, 1, (n, 3)), dtype=torch.float32, device="cuda")
    nrm = torch.as_tensor(rng.normal(size=(n, 3)), dtype=torch.float32, device="cuda")
    nrm = nrm / nrm.norm(dim=1, keepdim=True)
    sdf = (x.norm(dim=1, keepdim=True) - 0.6).abs()
    return spec, p, x, nrm, sdf


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["total_variation", "grad_consistency"])
@pytest.mark.parametrize("hidden,n", [((256,) * 8, 4099), ((64,) * 3, 1001)])
def test_regularisers_run_on_the_kernels(name, hidden, n):
    """total_variation on K1 + K2 and grad_consistency on K3a + K3b, one
    launch each with the backward, against the plain Taylor-mode path on
    the card: each term within the tolerance of the output it is built on
    + RTOL |plain|, each gradient in the backward kernel's GTOL form."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1, K2, K3a and K3b have no CPU mode")
    from diffudf_tpu_torch.autodiff.ops import value_grad, value_grad_hessian_packed
    from diffudf_tpu_torch.train import losses

    spec, p, x, nrm, sdf = _regulariser_case(hidden, n)

    def run(**kw):
        leaves = params_from_jax(p, "cuda")
        for layer in leaves:
            for t in layer.values():
                t.requires_grad_(True)
        if name == "total_variation":
            vals = (losses.total_variation(leaves, spec, x, sdf, 10.0, **kw),)
        else:
            gen = torch.Generator(device="cuda").manual_seed(5)
            vals = losses.grad_consistency(leaves, spec, gen, x, nrm, 10.0, **kw)
        flat = [t for layer in leaves for t in (layer["w"], layer["b"])]
        grads = torch.autograd.grad(sum(vals), flat, allow_unused=True)
        return ([float(v.detach()) for v in vals],
                [torch.zeros_like(t) if g is None else g for t, g in zip(flat, grads)])

    mods = (tv, tv) if name == "total_variation" else (tg, tg)
    before = (mods[0].launches, mods[1].bwd_launches)
    got = run()
    torch.cuda.synchronize()
    assert (mods[0].launches - before[0], mods[1].bwd_launches - before[1]) == (1, 1)
    if name == "total_variation":
        want, tols, gtol = run(vgh_fn=value_grad_hessian_packed), ("h6",), GTOL["vgh_bwd"]
    else:
        want, tols, gtol = run(vg_fn=value_grad), ("g", "f", "g"), GTOL["vg_bwd"]
    for g, w, k in zip(got[0], want[0], tols):
        assert abs(g - w) <= TOL[k] + RTOL * abs(w), (g, w)
    for g, w in zip(got[1], want[1]):
        limit = gtol * max(float(w.abs().max()), 1.0) + RTOL * w.abs()
        assert float(((g - w).abs() / limit).max()) <= 1


@pytest.mark.cuda
def test_device_relaxation_matches_the_loop_on_the_cpu(monkeypatch):
    """The relaxation loop on the card gives the CPU run's signs, and
    DIFFUDF_RELAX_ON_DEVICE=1 with a CUDA device takes it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from diffudf_tpu_torch.extract import meshudf

    rng = np.random.default_rng(2)
    n = 64
    s = rng.choice([-1.0, 0.0, 1.0], size=(n, n, n)).astype(np.float32)
    w = [(rng.normal(size=sh) * (rng.random(sh) < 0.8)).astype(np.float32)
         for sh in ((n - 1, n, n), (n, n - 1, n), (n, n, n - 1))]
    cpu = meshudf._relax_device(torch.from_numpy(s), [torch.from_numpy(a) for a in w], 30)
    gpu = meshudf._relax_device(torch.from_numpy(s).cuda(),
                                [torch.from_numpy(a).cuda() for a in w], 30)
    assert torch.equal(cpu[0], gpu[0].cpu())
    participate = s != 0
    signs = np.where(s < 0, -1, 1).astype(np.int8)
    monkeypatch.setenv("DIFFUDF_RELAX_ON_DEVICE", "1")
    got = meshudf._relax(signs, w, participate, 30, "cuda")
    want_s = cpu[0].numpy()
    nz = (want_s != 0) & participate
    want = signs.copy()
    want[nz] = want_s[nz].astype(np.int8)
    assert np.array_equal(got[0], want)


# The training epoch as a CUDA graph (train/loop.py): from one initial state
# and one generator state, graphed epochs against the same epochs run
# eagerly, on a 3x64 net and a batch of 3,000 drawn from a sphere's cloud.

GRAPH_PCT = (1.0 / 3.0, 2.0 / 3.0)


def _sphere_cloud(n=2000, seed=0):
    rng = np.random.default_rng(seed)
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return (0.5 * nrm).astype(np.float32), nrm.astype(np.float32)


def _graph_trainer(stage, hidden=(64, 64, 64), batch=3000, oracle="table"):
    from diffudf_tpu_torch.config import TrainConfig
    from diffudf_tpu_torch.data.sampling import TrainingSampler
    from diffudf_tpu_torch.train import loop

    pts, nrm = _sphere_cloud()
    make = (TrainingSampler.from_point_cloud if oracle == "table"
            else TrainingSampler.from_point_cloud_bootstrap)
    sampler = make(pts, nrm, batch, GRAPH_PCT, device="cuda")
    cfg = TrainConfig(batch_size=batch, sampling_percentiles=GRAPH_PCT, num_epochs=3000,
                      s1_epochs=2000, gt_mode="siren" if stage == "siren" else "tanh",
                      lr_s2=1e-4)
    return loop.Trainer(SirenSpec(hidden=hidden), sampler, cfg)


class _BatchRecorder:
    """A sampler that keeps a copy of every batch it hands out."""

    def __init__(self, inner):
        self.inner, self.batches = inner, []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def sample(self, gen):
        out = self.inner.sample(gen)
        self.batches.append(tuple(t.clone() for t in out))
        return out


def _graph_counts():
    from diffudf_tpu_torch.train import loop

    return np.array([loop.graph_replays, loop.graph_captures, loop.eager_steps])


def _state_leaves(state):
    from diffudf_tpu_torch.train.loop import _leaves

    return {"params": _leaves(state.params), "mu": _leaves(state.opt_state.mu),
            "nu": _leaves(state.opt_state.nu), "best_params": _leaves(state.best_params),
            "best_loss": [state.best_loss]}


@pytest.mark.cuda
@pytest.mark.parametrize("stage", ["s2", "siren"])
def test_graphed_epochs_match_eager_epochs(stage, monkeypatch):
    """Five graphed epochs (eager on the side stream, capture, three
    replays) against five eager ones from the same state and generator:
    bit-identical batches; rows, params, Adam moments and best params within
    float32 rounding (4 ulp of each tensor's largest element); rows of their
    own; the counters as the eager and graphed paths count them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graph captures CUDA work")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    runs = {}
    for graphed in (True, False):
        trainer = _graph_trainer(stage)
        if not graphed:
            monkeypatch.setattr(trainer, "_graphable", lambda stage: False)
        trainer.sampler = rec = _BatchRecorder(trainer.sampler)
        state = trainer.init_state()
        gen = torch.Generator(device="cuda").manual_seed(2**31 + 77)
        counts = _graph_counts()
        rows = [trainer.epoch(state, stage, 2000 + e, gen) for e in range(5)]
        torch.cuda.synchronize()
        runs[graphed] = dict(rows=rows, state=_state_leaves(state), batches=rec.batches,
                             counts=_graph_counts() - counts, count=state.opt_state.count)
    g, e = runs[True], runs[False]
    assert g["counts"].tolist() == [3, 1, 1] and e["counts"].tolist() == [0, 0, 5]
    assert g["count"] == e["count"] == 5
    for a, b in zip(g["batches"], e["batches"]):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    assert len({r.data_ptr() for r in g["rows"]}) == 5

    def close(a, b, what):
        a, b = a.detach(), b.detach()
        ulp = 4 * torch.finfo(torch.float32).eps * float(b.abs().max().clamp(min=1e-30))
        err = float((a - b).abs().max())
        print(f"{stage} {what}: max |graphed - eager| {err!r}, limit {ulp!r}")
        assert err <= ulp, what

    close(torch.stack(g["rows"]), torch.stack(e["rows"]), "rows")
    for name in g["state"]:
        for i, (a, b) in enumerate(zip(g["state"][name], e["state"][name])):
            close(a, b, f"{name}[{i}]")


@pytest.mark.cuda
def test_graph_is_captured_again_for_a_new_state_only():
    """A sampler swap at the same batch shape (bootstrap to table, as the
    overlapped oracle build hands over) replays the graph captured before
    it; a new TrainState runs eagerly once and is captured again; s1 stays
    eager on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graph captures CUDA work")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    trainer = _graph_trainer("s2", oracle="bootstrap")
    state = trainer.init_state()
    gen = torch.Generator(device="cuda").manual_seed(9)
    counts = _graph_counts()
    for e in range(3):
        trainer.epoch(state, "s2", 2000 + e, gen)
    assert (_graph_counts() - counts).tolist() == [1, 1, 1]
    graph = trainer._graph
    trainer.sampler = _graph_trainer("s2").sampler
    trainer.epoch(state, "s2", 2003, gen)
    assert (_graph_counts() - counts).tolist() == [2, 1, 1] and trainer._graph is graph
    fresh = trainer.init_state()
    for e in range(2):
        trainer.epoch(fresh, "s2", 2000 + e, gen)
    assert (_graph_counts() - counts).tolist() == [2, 2, 2] and trainer._graph is not graph
    torch.cuda.synchronize()
    assert torch.isfinite(fresh.best_loss) and fresh.opt_state.count == 2

    plain = _graph_trainer("s1", hidden=(48, 48))  # not a kernel width: no nvcc build
    s1_state = plain.init_state()
    counts = _graph_counts()
    for e in range(3):
        plain.epoch(s1_state, "s1", 1000 + e, gen)
    assert (_graph_counts() - counts).tolist() == [0, 0, 3] and plain._graph is None
