"""Port parity: the fused (f, ∇f, packed H) kernel K1 and its VJP K2
(``diffudf_tpu_torch.ops.vgh``), and the field evaluation that dispatches
to K1.

On the CPU the wrappers run their plain torch versions, which are held
against the JAX package's Taylor-mode function, ``jax.grad`` of it, and the
Pallas forward kernel (interpret mode, patched as tests/test_pallas.py
does).  The kernels themselves are held against the plain versions on a
GPU, in tests/test_torch_cuda.py."""

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffudf_tpu.ops.pallas_vgh as pv
from diffudf_tpu.autodiff.ops import value_grad_hessian_packed
from diffudf_tpu.fields.siren import SirenSpec as JaxSpec
from diffudf_tpu.ops.evaluate import evaluate_field as jax_evaluate_field
from diffudf_tpu_torch.fields.siren import SirenSpec, init_siren, params_from_jax
from diffudf_tpu_torch.ops import vgh as tv
from diffudf_tpu_torch.ops.evaluate import evaluate_field

torch.set_num_threads(2)

# tests/test_pallas.py::TestPallasVGH::test_matches_reference
TOL = {"f": 1e-5, "g": 1e-4, "h6": 5e-3}


def _case(hidden, n, seed=0):
    spec = SirenSpec(hidden=hidden)
    np_params = init_siren(spec, np.random.default_rng(seed))
    x = np.random.default_rng(seed + 1).uniform(-1, 1, (n, 3)).astype(np.float32)
    jparams = [{k: jnp.asarray(v) for k, v in layer.items()} for layer in np_params]
    return spec, JaxSpec(hidden=hidden), np_params, jparams, x


def _assert_close(got, want):
    for k, a, b in zip(("f", "g", "h6"), got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=TOL[k], err_msg=k)


@pytest.fixture(scope="module")
def flagship():
    """8x256 net and 512 points, the shape of the JAX kernel test."""
    return _case((256,) * 8, 512)


def test_reference_matches_jax_taylor_mode(flagship):
    spec, jspec, np_params, jparams, x = flagship
    got = tv.vgh_reference(params_from_jax(np_params, "cpu"), spec, torch.from_numpy(x))
    want = jax.jit(lambda p, y: value_grad_hessian_packed(p, jspec, y))(jparams, jnp.asarray(x))
    _assert_close([t.numpy() for t in got], want)


def test_reference_matches_pallas_interpret(flagship, monkeypatch):
    orig = pl.pallas_call

    def interp_call(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(pv.pl, "pallas_call", interp_call)
    spec, jspec, np_params, jparams, x = flagship
    got = tv.vgh_reference(params_from_jax(np_params, "cpu"), spec, torch.from_numpy(x))
    _assert_close([t.numpy() for t in got], pv.vgh_pallas(jparams, jspec, jnp.asarray(x), tile=256))


def test_wrapper_on_cpu_runs_the_plain_version():
    spec, _, np_params, _, x = _case((64, 64, 64), 100)
    params = params_from_jax(np_params, "cpu")
    before = tv.launches
    got = tv.vgh(params, spec, torch.from_numpy(x))
    want = tv.vgh_reference(params, spec, torch.from_numpy(x))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert tv.launches == before


@pytest.mark.parametrize("spec", [
    SirenSpec(hidden=(64, 128)), SirenSpec(hidden=(64, 64), activation="relu"),
    SirenSpec(hidden=(64, 64), n_out=2),
])
def test_rejects_what_the_kernel_does_not_compute(spec):
    params = params_from_jax(init_siren(spec, np.random.default_rng(0)), "cpu")
    with pytest.raises(ValueError):
        tv.vgh(params, spec, torch.zeros((8, 3)))


@pytest.mark.parametrize("want", ["value", "grad", "hess"])
def test_evaluate_field_matches_jax(want):
    spec, jspec, np_params, jparams, x = _case((64, 64, 64), 700, seed=3)
    kw = dict(want_grad=want != "value", want_hess=want == "hess", tile=256)
    got = evaluate_field(params_from_jax(np_params, "cpu"), spec, torch.from_numpy(x), **kw)
    ref = jax_evaluate_field(jparams, jspec, jnp.asarray(x), deriv_dtype=None, **kw)
    np.testing.assert_allclose(got.f.numpy(), np.asarray(ref.f), rtol=0, atol=1e-5)
    if want == "value":
        assert got.grad is None and got.hess is None
    else:
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref.grad), rtol=0, atol=1e-4)
    if want == "hess":
        np.testing.assert_allclose(got.hess.numpy(), np.asarray(ref.hess), rtol=0, atol=5e-3)


# K2: tests/test_pallas.py::TestPallasVGHGrad, every gradient within
# 2e-5 * max(max |grad|, 1) of jax.grad of the Taylor-mode reference.
GTOL_VGH = 2e-5


@pytest.mark.parametrize("hidden,n", [((32,) * 4, 1001)])
def test_backward_matches_jax_grad(hidden, n):
    """vgh_bwd_reference (the hand-derived backward of
    pallas_vgh_vjp.py) and the autograd op VghOp, both against jax.grad of
    value_grad_hessian_packed on L = Σ sin f + Σ g² + Σ cos h6."""
    spec, jspec, np_params, jparams, x = _case(hidden, n, seed=5)

    def loss(p):
        f, g, h6 = value_grad_hessian_packed(p, jspec, jnp.asarray(x))
        return jnp.sum(jnp.sin(f)) + jnp.sum(g * g) + jnp.sum(jnp.cos(h6))

    want = jax.jit(jax.grad(loss))(jparams)

    def check(got):
        for layer, (a, b) in enumerate(zip(got, want)):
            for k in ("w", "b"):
                b_k = np.asarray(b[k])
                scale = max(float(np.abs(b_k).max()), 1.0)
                err = float(np.abs(np.asarray(a[k]) - b_k).max())
                assert err < GTOL_VGH * scale, (layer, k, err, GTOL_VGH * scale)

    params = params_from_jax(np_params, "cpu")
    xt = torch.from_numpy(x)
    f, g, h6 = tv.vgh_reference(params, spec, xt)
    cot = torch.cat([torch.cos(f)[:, None], 2 * g, -torch.sin(h6), torch.zeros((n, 6))], dim=1)
    check(tv.vgh_bwd(params, spec, xt, cot))

    for layer in params:
        for t in layer.values():
            t.requires_grad_(True)
    f, g, h6 = tv.vgh_op(params, spec, xt)
    (torch.sin(f).sum() + (g * g).sum() + torch.cos(h6).sum()).backward()
    check([{k: t.grad for k, t in layer.items()} for layer in params])


def test_backward_wrapper_on_cpu_runs_the_plain_version():
    spec, _, np_params, _, x = _case((32, 32, 32), 40)
    params = params_from_jax(np_params, "cpu")
    cot = torch.from_numpy(np.random.default_rng(9).normal(size=(40, 16)).astype(np.float32))
    before = tv.bwd_launches
    got = tv.vgh_bwd(params, spec, torch.from_numpy(x), cot)
    want = tv.vgh_bwd_reference(params, spec, torch.from_numpy(x), cot)
    for a, b in zip(got, want):
        assert torch.equal(a["w"], b["w"]) and torch.equal(a["b"], b["b"])
    assert tv.bwd_launches == before
    with pytest.raises(ValueError):
        tv.vgh_bwd(params, spec, torch.from_numpy(x), cot[:, :8])
