"""s2's value path as one kernel pair (``diffudf_tpu_torch.ops.value_vjp``)
on the CPU: the plain versions of the forward and its hand-derived VJP
against autograd through ``autodiff.ops.value`` (exact ``torch.sin``),
``loss_s2`` with and without the op, a Trainer's s2 epoch through it, and
the kernels' plan.  The kernels themselves are held against the plain
versions on a GPU, in tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from diffudf_tpu_torch.autodiff.ops import value
from diffudf_tpu_torch.fields.siren import SirenSpec, init_siren, params_from_jax
from diffudf_tpu_torch.ops import value_vjp as vv
from diffudf_tpu_torch.train import losses as tl

torch.set_num_threads(2)

# f within the Pallas value test's 1e-5 (tests/test_pallas.py); each
# gradient element within GTOL * max(max |autograd's|, 1), the vg VJP's
# gradcheck tolerance.  The plain pair's fast_sincos is within 6.3e-7 of
# torch.sin (ops/sincos.py), the rest is float32 rounding.
F_TOL = 1e-5
GTOL = 1e-5


def _case(hidden, n, seed=0):
    spec = SirenSpec(hidden=hidden)
    params = params_from_jax(init_siren(spec, np.random.default_rng(seed)), "cpu")
    rng = np.random.default_rng(seed + 1)
    x = torch.as_tensor(rng.uniform(-1, 1, (n, 3)), dtype=torch.float32)
    fbar = torch.as_tensor(rng.normal(size=n), dtype=torch.float32)
    return spec, params, x, fbar


def _leaves(params):
    return [t for layer in params for t in (layer["w"], layer["b"])]


def _autograd(params, spec, x, fbar):
    """(f, gradient of sum(fbar * f)) by autograd through autodiff.ops.value."""
    leaves = [t.detach().clone().requires_grad_(True) for t in _leaves(params)]
    p = [{"w": leaves[i], "b": leaves[i + 1]} for i in range(0, len(leaves), 2)]
    f = value(p, spec, x)
    return f.detach(), torch.autograd.grad((fbar * f).sum(), leaves, allow_unused=True)


def _assert_grads_close(got, want):
    for i, (a, b) in enumerate(zip(got, want)):
        b = torch.zeros_like(a) if b is None else b
        assert a.shape == b.shape, i
        err = float((a - b).abs().max()) if a.numel() else 0.0
        assert err <= GTOL * max(float(b.abs().max()) if b.numel() else 0.0, 1.0), (i, err)


@pytest.mark.parametrize("hidden,n", [
    ((64,) * 4, 1001),  # ragged: no multiple of any tile
    ((32,) * 3, 0),     # a data-parallel rank with no surface rows
    ((32,), 77),        # one hidden layer: no hidden product
])
def test_plain_pair_matches_autograd_through_value(hidden, n):
    """The plain forward and its hand-derived VJP, alone and through the
    autograd op, against autograd through the exact value path."""
    spec, params, x, fbar = _case(hidden, n)
    want_f, want_g = _autograd(params, spec, x, fbar)

    f, saved = vv.value_vjp_reference(params, spec, x)
    assert f.shape == (n,)
    if n:
        assert float((f - want_f).abs().max()) <= F_TOL
    grads = vv.value_vjp_bwd_reference(params, spec, x, saved, fbar)
    _assert_grads_close(_leaves(grads), want_g)

    leaves = [t.clone().requires_grad_(True) for t in _leaves(params)]
    p = [{"w": leaves[i], "b": leaves[i + 1]} for i in range(0, len(leaves), 2)]
    f_op = vv.value_vjp_op(p, spec, x)
    assert torch.equal(f_op.detach(), f)
    _assert_grads_close(torch.autograd.grad((fbar * f_op).sum(), leaves), want_g)


def test_wrappers_on_cpu_run_the_plain_versions():
    spec, params, x, fbar = _case((32, 32, 32), 50)
    before = (vv.launches, vv.bwd_launches)
    f, saved = vv.value_vjp_fwd(params, spec, x)
    f_ref, saved_ref = vv.value_vjp_reference(params, spec, x)
    assert torch.equal(f, f_ref)
    got = vv.value_vjp_bwd(params, spec, x, saved, fbar)
    for a, b in zip(got, vv.value_vjp_bwd_reference(params, spec, x, saved_ref, fbar)):
        assert torch.equal(a["w"], b["w"]) and torch.equal(a["b"], b["b"])
    assert (vv.launches, vv.bwd_launches) == before


@pytest.mark.parametrize("spec", [SirenSpec(hidden=(32, 64)),
                                  SirenSpec(hidden=(32, 32), activation="relu")])
def test_rejects_what_the_kernels_do_not_compute(spec):
    params = params_from_jax(init_siren(spec, np.random.default_rng(0)), "cpu")
    with pytest.raises(ValueError):
        vv.value_vjp_fwd(params, spec, torch.zeros((8, 3)))


@pytest.mark.parametrize("n,sms,tile,grid", [
    (9990, 132, 80, 125),  # a training batch's surface rows: one wave of 80-point tiles
    (999, 132, 16, 63),    # the card tests' 3,000-row batch
    (4995, 132, 16, 132),  # a batch's surface rows over two ranks: three tiles a CTA
    (0, 132, 80, 0),
])
def test_plan_takes_the_fewest_rows_a_cta(n, sms, tile, grid):
    spec = SirenSpec(hidden=(256,) * 8)
    plan = vv.vjp_plan(spec, n, sms)
    assert (plan.tile, plan.grid) == (tile, grid)
    rows = -(-plan.n_tiles // sms) * plan.tile if n else 0
    assert all(rows <= -(-(-(-n // t)) // sms) * t for t in vv.TILES)
    z = plan.sizes
    assert z["dbuf"] == 8 * plan.k_rows * 256 and z["frag"] == 2 * 7 * 256 * 256
    if n:
        assert plan.splits * plan.split_rows >= plan.k_rows and plan.split_rows % 32 == 0
        assert z["cbuf"] == z["mbar"] >= 7 * 256 * plan.k_rows
    else:
        assert plan.splits == 0 and z["wpart"] == z["small"] == 0


def _batch(n_on, n_off, seed=5):
    rng = np.random.default_rng(seed)
    pts = torch.as_tensor(rng.uniform(-1, 1, (n_on + n_off, 3)), dtype=torch.float32)
    nrm = torch.as_tensor(rng.normal(size=(n_on + n_off, 3)), dtype=torch.float32)
    sdf = torch.zeros((n_on + n_off, 1))
    sdf[n_on:, 0] = torch.as_tensor(rng.uniform(0.01, 0.5, n_off), dtype=torch.float32)
    return pts, nrm, sdf


@pytest.mark.parametrize("n_on", [333, 0])
def test_loss_s2_with_value_fn_matches_without(n_on):
    """loss_s2 through the op against the exact value path: each term within
    1e-5 of its value, each gradient as the plain pair's."""
    spec, params, _, _ = _case((64,) * 3, 0, seed=3)
    pts, nrm, sdf = _batch(n_on, 667)
    runs = []
    for fn in (vv.value_vjp_op, None):
        leaves = [t.clone().requires_grad_(True) for t in _leaves(params)]
        p = [{"w": leaves[i], "b": leaves[i + 1]} for i in range(0, len(leaves), 2)]
        terms = tl.loss_s2(p, spec, pts, nrm, sdf, (1e5, 1e5), 10.0, n_surface=n_on,
                           value_fn=fn)
        total = sum(terms.values())
        runs.append((terms, torch.autograd.grad(total, leaves, allow_unused=True)))
    (got, got_g), (want, want_g) = runs
    assert set(got) == set(want) == {"sdf_on_surf", "std_on_surf"}
    for k in want:
        assert float(got[k].detach()) == pytest.approx(float(want[k].detach()), rel=1e-5,
                                                       abs=1e-5), k
    scale = max(float(g.abs().max()) for g in want_g if g is not None)
    for a, b in zip(got_g, want_g):
        b = torch.zeros_like(a) if b is None else b
        assert float((a - b).abs().max()) <= GTOL * max(scale, 1.0)


def test_cpu_s2_epoch_goes_through_the_op(monkeypatch):
    """A Trainer on a net the kernels take runs its s2 loss through the op
    (its plain versions on the CPU): one forward a step, on the batch's
    surface rows, and the step moves every leaf."""
    from diffudf_tpu_torch.config import TrainConfig
    from diffudf_tpu_torch.data.sampling import TrainingSampler
    from diffudf_tpu_torch.train import loop

    calls, real = [], vv.value_vjp_fwd

    def spy(params, spec, x, *args, **kwargs):
        calls.append(x.shape[0])
        return real(params, spec, x, *args, **kwargs)

    monkeypatch.setattr(vv, "value_vjp_fwd", spy)
    rng = np.random.default_rng(7)
    cloud = rng.uniform(-0.5, 0.5, (64, 3)).astype(np.float32)
    normals = np.tile(np.float32([0.0, 0.0, 1.0]), (64, 1))
    pct = (1.0 / 3.0, 2.0 / 3.0)
    sampler = TrainingSampler.from_point_cloud_bootstrap(cloud, normals, 30, pct, device="cpu")
    cfg = TrainConfig(batch_size=30, sampling_percentiles=pct, num_epochs=8, s1_epochs=2,
                      lr_s2=1e-4)
    trainer = loop.Trainer(SirenSpec(hidden=(32, 32)), sampler, cfg)
    assert trainer._value_op is vv.value_vjp_op
    state = trainer.init_state()
    before = [t.detach().clone() for t in _leaves(state.params)]
    gen = torch.Generator().manual_seed(3)
    for e in range(2):
        row = trainer.epoch(state, "s2", 2 + e, gen)
        assert torch.isfinite(row).all()
    assert calls == [sampler.sizes.on_surface] * 2
    assert all(not torch.equal(a, b.detach()) for a, b in zip(before, _leaves(state.params)))
