"""Port parity: the fused (f, ∇f) kernel K3a and its VJP K3b
(``diffudf_tpu_torch.ops.vg``) against the JAX package.

On the CPU the wrappers run their plain torch versions, held here against
the JAX package's Taylor-mode ``value_grad`` and ``jax.grad`` of it, as
tests/test_pallas.py::TestPallasVG holds the Pallas kernels.  The kernels
themselves are held against the plain versions on a GPU, in
tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffudf_tpu.autodiff.ops import value_grad
from diffudf_tpu.fields.siren import SirenSpec as JaxSpec
from diffudf_tpu_torch.fields.siren import SirenSpec, init_siren, params_from_jax
from diffudf_tpu_torch.ops import vg as tg

torch.set_num_threads(2)

# tests/test_pallas.py::TestPallasVG: f 1e-5, g 1e-4 absolute; each gradient
# within GTOL * max(max |grad|, 1) of jax.grad
TOL = {"f": 1e-5, "g": 1e-4}
GTOL = 1e-5


def _case(hidden, n, seed=0):
    spec = SirenSpec(hidden=hidden)
    np_params = init_siren(spec, np.random.default_rng(seed))
    x = np.random.default_rng(seed + 1).uniform(-1, 1, (n, 3)).astype(np.float32)
    jparams = [{k: jnp.asarray(v) for k, v in layer.items()} for layer in np_params]
    return spec, JaxSpec(hidden=hidden), np_params, jparams, x


def _jax_grads(jparams, jspec, x):
    def loss(p):
        f, g = value_grad(p, jspec, jnp.asarray(x))
        return jnp.sum(jnp.sin(f)) + jnp.sum(g * g)

    return jax.jit(jax.grad(loss))(jparams)


def _assert_grads_close(got, want, gtol):
    for layer, (a, b) in enumerate(zip(got, want)):
        for k in ("w", "b"):
            b_k = np.asarray(b[k])
            scale = max(float(np.abs(b_k).max()), 1.0)
            err = float(np.abs(np.asarray(a[k]) - b_k).max())
            assert err < gtol * scale, (layer, k, err, gtol * scale)


@pytest.mark.parametrize("hidden,n", [((64,) * 4, 128), ((32,) * 3, 1001)])
def test_reference_matches_jax_value_grad(hidden, n):
    spec, jspec, np_params, jparams, x = _case(hidden, n)
    got = tg.vg_reference(params_from_jax(np_params, "cpu"), spec, torch.from_numpy(x))
    want = jax.jit(lambda p, y: value_grad(p, jspec, y))(jparams, jnp.asarray(x))
    for k, a, b in zip(("f", "g"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=TOL[k], err_msg=k)


@pytest.mark.parametrize("hidden,n", [((64,) * 4, 1001)])
def test_backward_matches_jax_grad(hidden, n):
    """vg_bwd_reference (the hand-derived backward) and the autograd op
    VgOp, both against jax.grad of value_grad on L = Σ sin f + Σ g²."""
    spec, jspec, np_params, jparams, x = _case(hidden, n, seed=2)
    want = _jax_grads(jparams, jspec, x)

    params = params_from_jax(np_params, "cpu")
    xt = torch.from_numpy(x)
    f, g = tg.vg_reference(params, spec, xt)
    cot = torch.cat([torch.cos(f)[:, None], 2 * g, torch.zeros((n, 4))], dim=1)
    _assert_grads_close(tg.vg_bwd(params, spec, xt, cot), want, GTOL)

    for layer in params:
        for t in layer.values():
            t.requires_grad_(True)
    f, g = tg.vg_op(params, spec, xt)
    (torch.sin(f).sum() + (g * g).sum()).backward()
    _assert_grads_close([{k: t.grad for k, t in layer.items()} for layer in params], want, GTOL)


def test_wrappers_on_cpu_run_the_plain_versions():
    spec, _, np_params, _, x = _case((32, 32, 32), 50)
    params = params_from_jax(np_params, "cpu")
    xt = torch.from_numpy(x)
    before = (tg.launches, tg.bwd_launches)
    for a, b in zip(tg.vg(params, spec, xt), tg.vg_reference(params, spec, xt)):
        assert torch.equal(a, b)
    cot = torch.ones((50, 8))
    got = tg.vg_bwd(params, spec, xt, cot)
    for a, b in zip(got, tg.vg_bwd_reference(params, spec, xt, cot)):
        assert torch.equal(a["w"], b["w"]) and torch.equal(a["b"], b["b"])
    assert (tg.launches, tg.bwd_launches) == before


@pytest.mark.parametrize("spec", [SirenSpec(hidden=(32, 64)),
                                  SirenSpec(hidden=(32, 32), activation="relu")])
def test_rejects_what_the_kernels_do_not_compute(spec):
    params = params_from_jax(init_siren(spec, np.random.default_rng(0)), "cpu")
    with pytest.raises(ValueError):
        tg.vg(params, spec, torch.zeros((8, 3)))
    with pytest.raises(ValueError):
        tg.vg_bwd(params, spec, torch.zeros((8, 3)), torch.zeros((8, 8)))
