"""Port parity: the fused (f, ∇f, packed H) kernel K1 (``diffudf_tpu_torch.
ops.vgh``) and the field evaluation that dispatches to it.

On the CPU the wrapper runs its plain torch version, which is held against
the JAX package's Taylor-mode function and its Pallas kernel (interpret
mode, patched as tests/test_pallas.py does).  The kernel itself is held
against the plain version on a GPU, in tests/test_torch_cuda.py."""

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
    _assert_close([t.numpy() for t in got], value_grad_hessian_packed(jparams, jspec, jnp.asarray(x)))


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
