"""Port parity: SIREN, transforms, fused derivatives, eigh3 and checkpoints
of ``diffudf_tpu_torch`` against the JAX package, on the same numpy inputs."""

import os.path as osp

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffudf_tpu.autodiff import eigh3 as jeigh
from diffudf_tpu.autodiff import ops as jops
from diffudf_tpu.fields import siren as jsiren
from diffudf_tpu.fields import transforms as jtf
from diffudf_tpu.train import checkpoint as jckpt
from diffudf_tpu.utils.buckets import next_bucket as jax_next_bucket
from diffudf_tpu_torch.autodiff import eigh3, ops
from diffudf_tpu_torch.fields import siren, transforms
from diffudf_tpu_torch.train import checkpoint
from diffudf_tpu_torch.utils.buckets import next_bucket

torch.set_num_threads(2)

GOLDEN = osp.join(osp.dirname(__file__), "golden", "field_losses_golden.npz")
HIDDEN = (64, 64, 64)


@pytest.fixture(scope="module")
def net():
    spec = siren.SirenSpec(hidden=HIDDEN)
    np_params = siren.init_siren(spec, np.random.default_rng(0))
    x = np.random.default_rng(1).uniform(-1, 1, (300, 3)).astype(np.float32)
    jparams = [{k: jnp.asarray(v) for k, v in layer.items()} for layer in np_params]
    return spec, jsiren.SirenSpec(hidden=HIDDEN), np_params, jparams, x


def test_init_has_the_jax_layout_and_bounds(net):
    spec, jspec, np_params, _, _ = net
    jparams = jsiren.init_siren(__import__("jax").random.PRNGKey(0), jspec)
    assert [(p["w"].shape, p["b"].shape) for p in np_params] == \
        [(p["w"].shape, p["b"].shape) for p in jparams]
    dims = spec.layer_dims
    for i, p in enumerate(np_params):
        bound = 1.0 / dims[i] if i == 0 else np.sqrt(6.0 / dims[i]) / spec.w0
        assert np.abs(p["w"]).max() <= bound and np.abs(p["w"]).max() > 0.9 * bound
        assert np.abs(p["b"]).max() <= 1.0 / np.sqrt(dims[i])


def test_siren_apply_and_module_match_jax(net):
    spec, jspec, np_params, jparams, x = net
    want = np.asarray(jsiren.siren_apply(jparams, jspec, jnp.asarray(x)))
    params = siren.params_from_jax(np_params, "cpu")
    np.testing.assert_allclose(siren.siren_apply(params, spec, torch.from_numpy(x)).numpy(),
                               want, rtol=0, atol=1e-5)
    module = siren.Siren(spec, np_params)
    with torch.no_grad():
        np.testing.assert_allclose(module(torch.from_numpy(x)).numpy(), want, rtol=0, atol=1e-5)
    for a, b in zip(siren.params_to_jax(module.params()), np_params):
        assert np.array_equal(a["w"], b["w"]) and np.array_equal(a["b"], b["b"])


def test_fused_derivatives_match_jax(net):
    spec, jspec, np_params, jparams, x = net
    params = siren.params_from_jax(np_params, "cpu")
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    f, g, h6 = ops.value_grad_hessian_packed(params, spec, xt)
    f0, g0, h0 = jops.value_grad_hessian_packed(jparams, jspec, xj)
    np.testing.assert_allclose(f.numpy(), np.asarray(f0), rtol=0, atol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(g0), rtol=0, atol=1e-4)
    np.testing.assert_allclose(h6.numpy(), np.asarray(h0), rtol=0, atol=5e-3)
    f1, g1 = ops.value_grad(params, spec, xt)
    np.testing.assert_allclose(f1.numpy(), f.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(g1.numpy(), g.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ops.value(params, spec, xt).numpy(), f.numpy(), rtol=0, atol=1e-6)
    full = ops.hess_from_packed(h6)
    np.testing.assert_array_equal(full.numpy(), np.asarray(jops.hess_from_packed(jnp.asarray(h6.numpy()))))
    assert torch.equal(ops.pack_hess(full), h6)


def test_autograd_hessian_agrees(net):
    """The hand-rolled forward propagation against torch autograd."""
    spec, _, np_params, _, x = net
    params = siren.params_from_jax(np_params, "cpu")
    pts = torch.from_numpy(x[:20]).double()
    p64 = [{k: v.double() for k, v in layer.items()} for layer in params]
    _, g, h6 = ops.value_grad_hessian_packed(p64, spec, pts)
    fn = lambda p: ops.value(p64, spec, p[None])[0]  # noqa: E731
    for i in range(len(pts)):
        hess = torch.autograd.functional.hessian(fn, pts[i])
        grad = torch.autograd.functional.jacobian(fn, pts[i])
        np.testing.assert_allclose(g[i].numpy(), grad.numpy(), rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(h6[i].numpy(), ops.pack_hess(hess).numpy(), rtol=1e-8, atol=1e-8)


def test_inverse_map_matches_reference_golden():
    """The asserts of tests/test_golden_losses.py on the port's inverse maps."""
    g = np.load(GOLDEN)
    alpha = float(g["alpha"])
    for mode in ("tanh", "squared", "siren"):
        ours = transforms.inverse_map(mode, torch.from_numpy(g["inverse_vals"]), alpha)
        np.testing.assert_allclose(ours.numpy(), g[f"inverse_{mode}"], rtol=1e-6, atol=1e-7)
    for mode in ("squared", "siren"):
        ours = transforms.inverse_map(mode, torch.from_numpy(g["inverse_vals_neg"]), alpha)
        np.testing.assert_allclose(ours.numpy(), g[f"inverse_{mode}_neg"], rtol=1e-6, atol=1e-7)


def test_gt_transforms_match_jax():
    d = np.random.default_rng(2).uniform(0, 1, 1000).astype(np.float32)
    for mode in ("tanh", "squared", "siren"):
        for fn in ("gt_transform", "gt_grad_norm"):
            got = getattr(transforms, fn)(mode, torch.from_numpy(d), 10.0).numpy()
            want = np.asarray(getattr(jtf, fn)(mode, jnp.asarray(d), 10.0))
            # the two libraries' tanh differ by ulps, which 1 - tanh² amplifies
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        transforms.inverse_map("bogus", torch.zeros(1), 10.0)


def test_eigh3_matches_jax_and_numpy():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(500, 3, 3)).astype(np.float32)
    a = a + np.swapaxes(a, -1, -2)
    a[:5] = np.diag([2.0, 2.0, 2.0])  # isotropic: the ẑ fallback
    lam, vec = eigh3.eigh3x3(torch.from_numpy(a))
    np.testing.assert_allclose(lam.numpy(), np.linalg.eigvalsh(a.astype(np.float64)), atol=2e-4)
    # the isotropic rows' eigenvectors all fall back to ẑ: no basis to rebuild
    recon = vec[5:] @ torch.diag_embed(lam[5:]) @ vec[5:].transpose(-1, -2)
    np.testing.assert_allclose(recon.numpy(), a[5:], atol=2e-3)
    top = eigh3.top_eigenvector(torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(top, np.asarray(jeigh.top_eigenvector(jnp.asarray(a))), atol=1e-4)
    np.testing.assert_array_equal(top[:5], np.tile([0.0, 0.0, 1.0], (5, 1)))


def test_eigh3_gradient_guards():
    """Isotropic and zero matrices keep finite gradients (eigh3.py:31-40)."""
    a = torch.zeros((3, 3, 3), dtype=torch.float32)
    a[1] = torch.eye(3)
    a[2] = torch.diag(torch.tensor([1.0, 1.0, 3.0]))
    a.requires_grad_(True)
    eigh3.top_eigenvector(a).sum().backward()
    assert torch.isfinite(a.grad).all()


def test_checkpoint_round_trips_both_ways(tmp_path, net):
    spec, jspec, np_params, jparams, _ = net
    # JAX writes, the port reads
    jckpt.save_params(str(tmp_path / "j.npz"), jparams, jspec)
    loaded = checkpoint.load_params(str(tmp_path / "j.npz"), device="cpu")
    assert checkpoint.load_spec(str(tmp_path / "j.npz")) == spec
    checkpoint.check_params_match_spec(loaded, spec)
    # the port writes, JAX reads
    checkpoint.save_params(str(tmp_path / "t.npz"), loaded, spec)
    back = jckpt.load_params(str(tmp_path / "t.npz"))
    assert jckpt.load_spec(str(tmp_path / "t.npz")) == jspec
    for a, b in zip(back, np_params):
        assert np.array_equal(np.asarray(a["w"]), b["w"]) and np.array_equal(np.asarray(a["b"]), b["b"])
    with pytest.raises(ValueError, match="layer dims"):
        checkpoint.check_params_match_spec(loaded, siren.SirenSpec(hidden=(64, 64)))


def test_next_bucket_matches_jax():
    for n in (0, 1, 4095, 4096, 4097, 10**6):
        for factor, cap in ((2, None), (4, None), (4, 65536)):
            assert next_bucket(n, 4096, factor, cap) == jax_next_bucket(n, 4096, factor, cap)
