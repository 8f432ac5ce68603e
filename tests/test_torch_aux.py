"""Port parity: the last of the JAX package's functions in
``diffudf_tpu_torch`` (the autodiff oracle, ``value_grad_hessian``,
``deriv_dtype``, ``param_count``, the auxiliary regularisers, the winding
number and the signed mesh distance, the device sign relaxation and the
package-level names), against the JAX package on shared numpy inputs.

Small sizes: a 3×32 net, a few hundred points, coarse meshes; no JAX
training."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffudf_tpu.autodiff import ops as jops
from diffudf_tpu.data import mesh_distance as jmd
from diffudf_tpu.extract import meshudf as jmu
from diffudf_tpu.fields import siren as jsiren
from diffudf_tpu.train import losses as jl
from diffudf_tpu_torch.autodiff import ops as tops
from diffudf_tpu_torch.data import mesh_distance as tmd
from diffudf_tpu_torch.extract import meshudf as tmu
from diffudf_tpu_torch.fields.siren import SirenSpec, init_siren, param_count, params_from_jax
from diffudf_tpu_torch.train import losses as tl

torch.set_num_threads(2)

HIDDEN = (32, 32, 32)
# tests/test_autodiff.py's tolerances for the fused derivatives against
# autodiff; tests/test_torch_train.py's for loss terms (relative) and param
# gradients (GRAD_TOL * max(max |grad|, 1) per tensor).
TOL = {"f": 1e-5, "g": 1e-4, "h": 5e-3}
TERM_RTOL = 1e-4
GRAD_TOL = 2e-4
# The port's bf16 carries may be at most this many times as far from the
# float64 truth as the JAX package's bf16 carries: two bf16 roundings in
# another order are not held element by element.
BF16_RATIO = 2.0


def _net(activation="sine", seed=0, n=128):
    spec = SirenSpec(hidden=HIDDEN, activation=activation)
    p = init_siren(spec, np.random.default_rng(seed))
    x = np.random.default_rng(seed + 1).uniform(-1, 1, (n, 3)).astype(np.float32)
    jspec = jsiren.SirenSpec(hidden=HIDDEN, activation=activation)
    jp = [{k: jnp.asarray(v) for k, v in layer.items()} for layer in p]
    return spec, p, x, jspec, jp


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want), atol=atol)


@pytest.mark.parametrize("activation", ["sine", "relu"])
def test_value_grad_hessian_and_the_ad_oracle_match_jax(activation):
    spec, p, x, jspec, jp = _net(activation)
    tp, tx = params_from_jax(p, "cpu"), torch.from_numpy(x)
    want = jax.jit(lambda q, y: jops.value_grad_hessian(q, jspec, y))(jp, jnp.asarray(x))
    want_ad = jax.jit(lambda q, y: jops.value_grad_hessian_ad(q, jspec, y))(jp, jnp.asarray(x))
    got = tops.value_grad_hessian(tp, spec, tx)
    got_ad = tops.value_grad_hessian_ad(tp, spec, tx)
    assert got[2].shape == got_ad[2].shape == (len(x), 3, 3)
    for name, g, w, g_ad, w_ad in zip("fgh", got, want, got_ad, want_ad):
        _close(g, w, TOL[name])
        _close(g_ad, w_ad, TOL[name])
        _close(g, g_ad.detach().numpy(), TOL[name])


@pytest.mark.parametrize("fn", ["value_grad", "value_grad_hessian_packed"])
def test_bf16_carries_are_as_close_to_float64_as_the_jax_ones(fn):
    spec, p, x, jspec, jp = _net(n=256)
    tp, tx = params_from_jax(p, "cpu"), torch.from_numpy(x)
    p64 = [{k: v.double() for k, v in layer.items()} for layer in tp]
    truth = [t.numpy() for t in getattr(tops, fn)(p64, spec, tx.double())]
    got = getattr(tops, fn)(tp, spec, tx, deriv_dtype=torch.bfloat16)
    want = jax.jit(lambda q, y: getattr(jops, fn)(q, jspec, y, deriv_dtype=jnp.bfloat16))(
        jp, jnp.asarray(x))
    # None and the points' own dtype keep the float32 carries bit for bit
    plain = getattr(tops, fn)(tp, spec, tx)
    for a, b, c in zip(plain, getattr(tops, fn)(tp, spec, tx, deriv_dtype=None),
                       getattr(tops, fn)(tp, spec, tx, deriv_dtype=torch.float32)):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert torch.equal(got[0], plain[0])  # the value path stays float32
    for g, w, t in zip(got[1:], want[1:], truth[1:]):
        assert g.dtype == torch.float32
        e_port = np.abs(g.numpy().astype(np.float64) - t)
        e_jax = np.abs(np.asarray(w, np.float64) - t)
        assert e_port.max() <= BF16_RATIO * e_jax.max()
        assert np.sqrt((e_port ** 2).mean()) <= BF16_RATIO * np.sqrt((e_jax ** 2).mean())


@pytest.mark.parametrize("hidden", [(32, 32, 32), (256,) * 8, (48, 16)])
def test_param_count_matches_jax(hidden):
    spec = SirenSpec(hidden=hidden)
    p = init_siren(spec, np.random.default_rng(0))
    # the JAX init's shapes alone (param_count reads nothing else)
    jp = jax.eval_shape(lambda k: jsiren.init_siren(k, jsiren.SirenSpec(hidden=hidden)),
                        jax.random.PRNGKey(0))
    assert param_count(params_from_jax(p, "cpu")) == param_count(p) == jsiren.param_count(jp)


def _leaves(p):
    return [{k: torch.tensor(v, requires_grad=True) for k, v in layer.items()} for layer in p]


def _compare_loss(t_value, t_params, j_fn, jp):
    """The port's value and param gradients against jax.grad of j_fn."""
    j_value, j_grads = jax.jit(jax.value_and_grad(j_fn))(jp)
    np.testing.assert_allclose(float(t_value.detach()), float(j_value), rtol=TERM_RTOL)
    leaves = [t for layer in t_params for t in layer.values()]
    # the head's bias moves no derivative: its gradient is None, JAX's 0
    t_grads = torch.autograd.grad(t_value, leaves, allow_unused=True, retain_graph=True)
    it = iter(t_grads)
    for t_layer, j_layer in zip(t_params, j_grads):
        for k, t in t_layer.items():
            g, w = next(it), np.asarray(j_layer[k])
            g = np.zeros_like(w) if g is None else g.numpy()
            np.testing.assert_allclose(g, w, atol=GRAD_TOL * max(np.abs(w).max(), 1.0))


def _surface(n=96, seed=3):
    rng = np.random.default_rng(seed)
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return (0.6 * nrm).astype(np.float32), nrm.astype(np.float32)


def test_total_variation_matches_jax():
    spec, p, x, jspec, jp = _net(n=160)
    on, _ = _surface(32)
    pts = np.concatenate([on, x])  # on-surface rows are masked out
    sdf = np.concatenate([np.zeros(32), np.abs(np.linalg.norm(x, axis=1) - 0.6)])
    sdf = sdf.astype(np.float32)[:, None]
    tp = _leaves(p)
    got = tl.total_variation(tp, spec, torch.from_numpy(pts), torch.from_numpy(sdf), 10.0)
    _compare_loss(got, tp, lambda q: jl.total_variation(q, jspec, jnp.asarray(pts),
                                                        jnp.asarray(sdf), 10.0), jp)


def test_grad_consistency_matches_jax_on_its_eps():
    spec, p, _, jspec, jp = _net()
    pts, nrm = _surface()
    key, stddev = jax.random.PRNGKey(5), 0.01
    eps = stddev * jax.random.normal(key, (len(pts), 1))  # as the JAX function draws it
    tp = _leaves(p)
    got = tl._grad_consistency_at(tp, spec, torch.from_numpy(np.array(eps)),
                                  torch.from_numpy(pts), torch.from_numpy(nrm), 10.0)

    def j_fn(q):
        return jl.grad_consistency(q, jspec, key, jnp.asarray(pts), jnp.asarray(nrm), 10.0,
                                   stddev=stddev)

    for g, w in zip(got, jax.jit(j_fn)(jp)):
        np.testing.assert_allclose(float(g.detach()), float(w), rtol=TERM_RTOL)
    _compare_loss(sum(got), tp, lambda q: sum(j_fn(q)), jp)


def test_grad_consistency_draws_eps_from_the_generator(monkeypatch):
    spec, p, _, _, _ = _net()
    pts, nrm = _surface(n=20000)
    seen = []
    real = tl._grad_consistency_at
    monkeypatch.setattr(tl, "_grad_consistency_at",
                        lambda *a, **k: seen.append(a[2]) or real(*a, **k))
    tp, stddev = params_from_jax(p, "cpu"), 0.01
    args = (tp, spec, None, torch.from_numpy(pts), torch.from_numpy(nrm), 10.0, stddev)
    first = tl.grad_consistency(*args[:2], torch.Generator().manual_seed(1), *args[3:])
    again = tl.grad_consistency(*args[:2], torch.Generator().manual_seed(1), *args[3:])
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    eps = seen[0][:, 0].double()
    assert seen[0].shape == (len(pts), 1) and torch.equal(seen[0], seen[1])
    # the mean within 4 standard errors, the std within 2%
    assert abs(float(eps.mean())) < 4 * stddev / np.sqrt(len(eps))
    assert abs(float(eps.std()) / stddev - 1) < 0.02


def _cube():
    v = np.array([[x, y, z] for x in (-0.5, 0.5) for y in (-0.5, 0.5) for z in (-0.5, 0.5)])
    f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
                  [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]])
    return v, f


def _torus(nu=32, nv=16, R=0.6, r=0.25):
    """scripts/make_demo.py's torus (its grid_surface, closed in u and v)
    at a coarse tessellation."""
    uu, vv = np.meshgrid(np.linspace(0, 2 * np.pi, nu, endpoint=False),
                         np.linspace(0, 2 * np.pi, nv, endpoint=False), indexing="ij")
    verts = np.stack([(R + r * np.cos(vv)) * np.cos(uu), (R + r * np.cos(vv)) * np.sin(uu),
                      r * np.sin(vv)], -1).reshape(-1, 3)
    faces = []
    for i in range(nu):
        for j in range(nv):
            a, b = i * nv + j, ((i + 1) % nu) * nv + j
            c, d = ((i + 1) % nu) * nv + (j + 1) % nv, i * nv + (j + 1) % nv
            faces += [[a, b, c], [a, c, d]]
    return verts, np.asarray(faces)


@pytest.mark.parametrize("shape", ["cube", "torus"])
def test_winding_number_and_signed_distance_match_jax(shape):
    rng = np.random.default_rng(11)
    if shape == "cube":
        v, f = _cube()
        q = np.concatenate([(rng.random((50, 3)) - 0.5) * 0.9,
                            2.0 * rng.normal(size=(50, 3)),
                            [[0.0, 0.0, 0.0], [1.0, 0.0, 0.0]]]).astype(np.float32)
        inside = np.abs(q).max(1) < 0.5
    else:
        v, f = _torus()
        q = rng.uniform([-0.9, -0.9, -0.3], [0.9, 0.9, 0.3], (300, 3)).astype(np.float32)
        inside = (np.hypot(q[:, 0], q[:, 1]) - 0.6) ** 2 + q[:, 2] ** 2 < 0.25 ** 2
    tris = v.astype(np.float32)[f]
    jtris, tq, ttris = jnp.asarray(tris), torch.from_numpy(q), torch.from_numpy(tris)
    w_got = tmd.winding_number(tq, ttris, tile=64).numpy()
    w_want = np.asarray(jax.jit(lambda a, b: jmd.winding_number(a, b, tile=64))(
        jnp.asarray(q), jtris))
    np.testing.assert_allclose(w_got, w_want, atol=1e-5)
    s_got = tmd.signed_mesh_distance(tq, ttris, tile=64).numpy()
    s_want = np.asarray(jax.jit(lambda a, b: jmd.signed_mesh_distance(a, b, tile=64))(
        jnp.asarray(q), jtris))
    np.testing.assert_allclose(s_got, s_want, atol=1e-6)
    assert np.array_equal(np.abs(s_got), tmd.point_triangle_distance(tq, ttris).numpy())
    # the sign against the shape's own inside test, off the facets' sagitta
    far = np.abs(s_got) > (1e-6 if shape == "cube" else 0.02)
    assert np.array_equal((s_got < 0)[far], inside[far])
    if shape == "cube":
        np.testing.assert_allclose(s_got[-2:], [-0.5, 0.5], atol=1e-5)


def test_device_relaxation_loop_matches_jax():
    rng = np.random.default_rng(2)
    n = 12
    s = rng.choice([-1.0, 0.0, 1.0], size=(n, n, n)).astype(np.float32)
    w = [(rng.normal(size=shape) * (rng.random(shape) < 0.8)).astype(np.float32)
         for shape in ((n - 1, n, n), (n, n - 1, n), (n, n, n - 1))]
    got_s, got_acc = tmu._relax_device(torch.from_numpy(s), [torch.from_numpy(x) for x in w], 30)
    want_s, want_acc = jmu._relax_device(jnp.asarray(s), tuple(jnp.asarray(x) for x in w), 30)
    assert np.array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_allclose(got_acc.numpy(), np.asarray(want_acc), rtol=1e-6, atol=1e-6)


def test_relaxation_flag_keeps_the_host_loop_off_the_gpu(monkeypatch):
    """DIFFUDF_RELAX_ON_DEVICE=1 takes the device loop only for a GPU
    device: on the CPU, or with no device, the host loop runs as without
    it, and gives the JAX package's host-loop signs."""
    n = 24
    g = (np.arange(n) - (n - 1) / 2) * (2.0 / (n - 1))
    pts = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).astype(np.float32)
    r = np.linalg.norm(pts, axis=-1)
    udf = np.abs(r - 0.5).astype(np.float32)
    dirs = (pts / np.maximum(r, 1e-6)[..., None] * np.sign(r - 0.5)[..., None]).astype(np.float32)
    voxel = 2.0 / (n - 1)
    participate = udf < 2.0 * voxel
    signs = np.where(np.random.default_rng(0).random(udf.shape) < 0.1, -1, 1).astype(np.int8)
    monkeypatch.delenv("DIFFUDF_RELAX_ON_DEVICE", raising=False)
    want = jmu.majority_relaxation(signs, udf, dirs, participate, voxel)
    base = tmu.majority_relaxation(signs, udf, dirs, participate, voxel)
    monkeypatch.setenv("DIFFUDF_RELAX_ON_DEVICE", "1")
    for device in (None, "cpu"):
        got = tmu.majority_relaxation(signs, udf, dirs, participate, voxel, device=device)
        for a, b, c in zip(got, base, want):
            assert np.array_equal(a, b) and np.array_equal(a, c)


JAX_PACKAGES = ("autodiff", "data", "eval", "extract", "fields", "grid", "ops", "parallel",
                "pc", "render", "train", "utils")
# the JAX device mesh: DataGroup and run_group take its place
JAX_MESH_NAMES = {"batch_spec", "data_mesh", "replicate", "shard_batch"}
# names of the JAX package that the port replaces: package -> {JAX name: port name}
REPLACED = {"parallel": dict.fromkeys(JAX_MESH_NAMES, "DataGroup"),
            "utils": {"PhaseTimer": "span"}}


@pytest.mark.parametrize("package", JAX_PACKAGES)
def test_every_jax_package_name_imports_from_the_port(package):
    jax_names = set(importlib.import_module(f"diffudf_tpu.{package}").__all__)
    port = importlib.import_module(f"diffudf_tpu_torch.{package}")
    replaced = REPLACED.get(package, {})
    missing = jax_names - set(port.__all__) - set(replaced)
    assert not missing, f"diffudf_tpu_torch.{package} lacks {sorted(missing)}"
    for name in port.__all__:
        assert getattr(port, name) is not None
    assert set(replaced.values()) <= set(port.__all__)
    assert not set(replaced) & set(port.__all__)
    if package == "parallel":
        assert "run_group" in port.__all__
