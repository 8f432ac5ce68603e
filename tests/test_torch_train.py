"""Port parity: the training slice of ``diffudf_tpu_torch`` (losses, schedule,
Adam, train-state files, config, the trainer and ``cli.train``) against the
JAX package, on shared numpy inputs.

The JAX losses run with ``deriv_dtype=None`` (float32 carries, the JAX
trainer's CPU default is bfloat16) and without the Pallas ops, so they
compute the Taylor-mode reference with exact sin/cos; the port's s1 loss
runs its fused ops, whose plain versions use ``fast_sincos``.  No JAX
trainer runs here: it compiles."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffudf_tpu import config as jcfg
from diffudf_tpu.fields.siren import SirenSpec as JaxSpec
from diffudf_tpu.train import checkpoint as jckpt
from diffudf_tpu.train import losses as jl
from diffudf_tpu.train.schedule import lr_for_epoch as jax_lr
from diffudf_tpu_torch import config as tcfg
from diffudf_tpu_torch.cli import preprocess as tpre
from diffudf_tpu_torch.cli import train as tcli
from diffudf_tpu_torch.fields.siren import SirenSpec, init_siren
from diffudf_tpu_torch.ops import value_vjp as tvv
from diffudf_tpu_torch.ops.vg import vg_op
from diffudf_tpu_torch.ops.vgh import vgh_op
from diffudf_tpu_torch.train import checkpoint as tckpt
from diffudf_tpu_torch.train import losses as tl
from diffudf_tpu_torch.config import TrainConfig
from diffudf_tpu_torch.data.sampling import TrainingSampler
from diffudf_tpu_torch.train import loop as tloop
from diffudf_tpu_torch.train.loop import adam_apply, adam_scalars, adam_update, key_from_seed
from diffudf_tpu_torch.train.schedule import lr_for_epoch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIDDEN = (32, 32, 32)
N_ON = 32
# Loss terms: relative 1e-4 (float32 sums; the fused ops' fast_sincos is
# within 6.3e-7 of sin).  Param grads: 2e-4 * max(max |grad|, 1) per tensor,
# ten times the Pallas gradcheck's 2e-5, because the loss chains the
# Hessian's eigenvector and a normalisation onto the VJP.
TERM_RTOL = 1e-4
GRAD_TOL = 2e-4


def _batch(seed=0, n_on=N_ON, n_off=64):
    """Sphere batch in the sampler's layout: [on-surface | off-surface]."""
    rng = np.random.default_rng(seed)
    on = rng.normal(size=(n_on, 3))
    on /= np.linalg.norm(on, axis=1, keepdims=True)
    off = rng.uniform(-1, 1, size=(n_off, 3))
    pts = np.concatenate([0.6 * on, off]).astype(np.float32)
    nrm = np.concatenate([on, np.zeros((n_off, 3))]).astype(np.float32)
    sdf = np.concatenate([np.zeros(n_on), np.abs(np.linalg.norm(off, axis=1) - 0.6)])
    return pts, nrm, sdf.astype(np.float32)[:, None]


def _params(seed=0):
    return init_siren(SirenSpec(hidden=HIDDEN), np.random.default_rng(seed))


def _torch_leaves(np_params):
    return [{k: torch.tensor(v, requires_grad=True) for k, v in layer.items()}
            for layer in np_params]


def _compare(t_terms, t_params, j_fn, np_params):
    """Terms and every param grad of the port against JAX's."""
    jparams = [{k: jnp.asarray(v) for k, v in layer.items()} for layer in np_params]

    def total(p):
        terms = j_fn(p)
        return sum(terms.values()), terms

    (_, j_terms), j_grads = jax.jit(jax.value_and_grad(total, has_aux=True))(jparams)
    assert set(t_terms) == set(j_terms)
    for k, v in t_terms.items():
        np.testing.assert_allclose(float(v.detach()), float(j_terms[k]), rtol=TERM_RTOL, atol=1e-6,
                                   err_msg=k)
    sum(t_terms.values()).backward()
    for i, (a, b) in enumerate(zip(t_params, j_grads)):
        for k in ("w", "b"):
            want = np.asarray(b[k])
            err = float(np.abs(a[k].grad.numpy() - want).max())
            assert err <= GRAD_TOL * max(float(np.abs(want).max()), 1.0), (i, k, err)


def test_loss_s1_split_path_matches_jax():
    pts, nrm, sdf = _batch()
    np_params = _params(1)
    spec, jspec = SirenSpec(hidden=HIDDEN), JaxSpec(hidden=HIDDEN)
    weights, alpha = (1e4, 1e4, 1e4, 1e3), 10.0
    tp = _torch_leaves(np_params)
    t_terms = tl.loss_s1(tp, spec, torch.from_numpy(pts), torch.from_numpy(nrm),
                         torch.from_numpy(sdf), weights, alpha, n_surface=N_ON,
                         vgh_fn=vgh_op, vg_fn=vg_op)
    _compare(t_terms, tp, lambda p: jl.loss_s1(
        p, jspec, jnp.asarray(pts), jnp.asarray(nrm), jnp.asarray(sdf), weights, alpha,
        deriv_dtype=None, n_surface=N_ON), np_params)


@pytest.mark.parametrize("which", ["s2", "s2_layout", "siren"])
def test_loss_s2_and_siren_match_jax(which):
    """``s2_layout``: the port evaluates the leading surface rows alone
    (``n_surface``), JAX masks every row of a batch whose zeros are only
    those rows."""
    pts, nrm, sdf = _batch(seed=3)
    assert not (sdf[N_ON:] == 0).any()
    np_params = _params(4)
    spec, jspec = SirenSpec(hidden=HIDDEN), JaxSpec(hidden=HIDDEN)
    tp = _torch_leaves(np_params)
    args = (torch.from_numpy(pts), torch.from_numpy(nrm), torch.from_numpy(sdf))
    jargs = (jnp.asarray(pts), jnp.asarray(nrm), jnp.asarray(sdf))
    if which.startswith("s2"):
        w = (1e5, 1e5)
        kw = {"n_surface": N_ON} if which == "s2_layout" else {}
        t_terms = tl.loss_s2(tp, spec, *args, w, 10.0, **kw)
        j_fn = lambda p: jl.loss_s2(p, jspec, *jargs, w, 10.0)  # noqa: E731
    else:
        w = (3e3, 1e2, 1e2, 5e1)
        t_terms = tl.loss_siren(tp, spec, *args, w)
        j_fn = lambda p: jl.loss_siren(p, jspec, *jargs, w, deriv_dtype=None)  # noqa: E731
    _compare(t_terms, tp, j_fn, np_params)


def _spy_value(monkeypatch):
    """Wraps the loss module's ``value`` and the forward of the kernels'
    value op (``ops.value_vjp.value_vjp_fwd``, the Trainer's s2 value path on
    a net the kernels take); -> the list that records the rows of each
    call."""
    calls = []

    def wrap(real):
        def spy(params, spec, x, *args, **kwargs):
            calls.append(x.shape[:-1].numel())
            return real(params, spec, x, *args, **kwargs)
        return spy

    monkeypatch.setattr(tl, "value", wrap(tl.value))
    monkeypatch.setattr(tvv, "value_vjp_fwd", wrap(tvv.value_vjp_fwd))
    return calls


@pytest.mark.parametrize("planted", [False, True])
def test_loss_s2_layout_path_matches_mask_path(planted, monkeypatch):
    """On a [surface | far | near] batch from the port's sampler,
    ``loss_s2(..., n_surface=)`` evaluates the surface rows alone and gives
    the terms of the mask over every row (relative 1e-6) and the gradient of
    their sum.  ``planted``: a far row whose distance reads exactly 0.0 (as
    a mesh oracle can round one): the layout path leaves it out, as the
    mask of the true distances does, where the mask of the read ones takes
    it in."""
    rng = np.random.default_rng(5)
    on = rng.normal(size=(512, 3))
    on /= np.linalg.norm(on, axis=1, keepdims=True)
    sampler = TrainingSampler.from_point_cloud_bootstrap(
        (0.6 * on).astype(np.float32), on.astype(np.float32), 3000, PCT, device="cpu")
    pts, nrm, sdf = sampler.sample(torch.Generator().manual_seed(2**31 + 5))
    n_on = sampler.sizes.on_surface
    assert (sdf[:n_on] == 0).all() and not (sdf[n_on:] == 0).any()
    read = sdf.clone()
    if planted:
        read[n_on] = 0.0
    spec = SirenSpec(hidden=HIDDEN)

    def run(gt_sdf, **kw):
        tp = _torch_leaves(_params(6))
        terms = tl.loss_s2(tp, spec, pts, nrm, gt_sdf, (1e5, 1e5), 10.0, **kw)
        leaves = [t for layer in tp for t in layer.values()]
        return terms, torch.autograd.grad(sum(terms.values()), leaves)

    calls = _spy_value(monkeypatch)
    got, got_grads = run(read, n_surface=n_on)
    assert calls == [n_on]
    want, want_grads = run(sdf)
    for k in want:
        assert float(got[k].detach()) == pytest.approx(float(want[k].detach()), rel=1e-6), k
    # each weight gradient sums its rows' products; the GEMMs block 1,000
    # and 3,000 rows differently, which moves the sum by a few ulp of its
    # largest element (at most 7.9e-7 of it over six seeds): 1e-5 of it
    for a, b in zip(got_grads, want_grads):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    if planted:
        misread, _ = run(read)
        assert float(misread["std_on_surf"].detach()) != float(want["std_on_surf"].detach())


def test_lr_schedule_matches_jax_over_the_recipe():
    kw = dict(num_epochs=3000, s1_epochs=2000, warmup_epochs=1000, warmup_lr=1e-4,
              lr_s1=1e-5, lr_s2=1e-7)
    epochs = np.arange(3000)
    got = lr_for_epoch(torch.from_numpy(epochs), **kw).numpy()
    want = np.asarray(jax_lr(jnp.asarray(epochs), **kw))
    # the two libraries' float32 cos differ by an ulp, which 1 + cos(pi t)
    # magnifies near t = 1: relative 1e-6, absolute 1e-6 * lr_s2
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * kw["lr_s2"])
    assert got[0] == np.float32(1e-4) and got[1500] == np.float32(1e-5)


def test_adam_step_matches_optax():
    """Two steps of the port's Adam against optax.scale_by_adam followed by
    p - lr * u (the JAX trainer's update), relative 1e-6."""
    rng = np.random.default_rng(7)
    np_params = _params(2)
    grads = [[{k: rng.normal(size=v.shape).astype(np.float32) for k, v in layer.items()}
              for layer in np_params] for _ in range(2)]
    lr = 1e-3

    opt = optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-8)

    @jax.jit
    def step(p, s, g):
        u, s = opt.update(g, s, p)
        return jax.tree.map(lambda p, u: p - lr * u, p, u), s

    jp = [{k: jnp.asarray(v) for k, v in layer.items()} for layer in np_params]
    js = opt.init(jp)
    for g in grads:
        jp, js = step(jp, js, [{k: jnp.asarray(v) for k, v in layer.items()} for layer in g])

    tp = [{k: torch.tensor(v) for k, v in layer.items()} for layer in np_params]
    zeros = [{k: torch.zeros_like(v) for k, v in layer.items()} for layer in tp]
    ts = tckpt.AdamState(0, zeros, [{k: v.clone() for k, v in z.items()} for z in zeros])
    for g in grads:
        ts = adam_update(tp, [torch.tensor(layer[k]) for layer in g for k in ("w", "b")], ts, lr)
    assert ts.count == 2 and int(js.count) == 2
    for a, b in zip(tp, jp):
        for k in ("w", "b"):
            np.testing.assert_allclose(a[k].numpy(), np.asarray(b[k]), rtol=1e-6, atol=1e-9)


def test_device_scalar_adam_matches_optax():
    """The Adam of the graphed epoch: ``adam_apply`` reading its learning
    rate and bias corrections from one device buffer that ``adam_scalars``
    refills before each step, as a replay reads them, against optax with
    the learning rate of each step, relative 1e-6."""
    rng = np.random.default_rng(11)
    np_params = _params(3)
    lrs = (1e-3, 5e-4, 2e-4)
    grads = [[{k: rng.normal(size=v.shape).astype(np.float32) for k, v in layer.items()}
              for layer in np_params] for _ in lrs]
    opt = optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-8)

    @jax.jit
    def step(p, s, g, lr):
        u, s = opt.update(g, s, p)
        return jax.tree.map(lambda p, u: p - lr * u, p, u), s

    jp = [{k: jnp.asarray(v) for k, v in layer.items()} for layer in np_params]
    js = opt.init(jp)
    for g, lr in zip(grads, lrs):
        jp, js = step(jp, js, [{k: jnp.asarray(v) for k, v in layer.items()} for layer in g],
                      jnp.float32(lr))

    tp = [{k: torch.tensor(v) for k, v in layer.items()} for layer in np_params]
    mu = [{k: torch.zeros_like(v) for k, v in layer.items()} for layer in tp]
    nu = [{k: torch.zeros_like(v) for k, v in layer.items()} for layer in tp]
    scalars = adam_scalars([1], lrs[0], "cpu")
    for count, (g, lr) in enumerate(zip(grads, lrs), start=1):
        assert adam_scalars([count], lr, "cpu", out=scalars) is scalars
        adam_apply(tp, [torch.tensor(layer[k]) for layer in g for k in ("w", "b")], mu, nu,
                   scalars[0])
    np.testing.assert_allclose(scalars[0].numpy(), [np.float32(lrs[-1]), 1 - np.float32(0.9) ** 3,
                                                    1 - np.float32(0.999) ** 3], rtol=0)
    for a, b in zip(tp, jp):
        for k in ("w", "b"):
            np.testing.assert_allclose(a[k].numpy(), np.asarray(b[k]), rtol=1e-6, atol=1e-9)
    for a, b in zip(mu + nu, list(js.mu) + list(js.nu)):
        for k in ("w", "b"):
            np.testing.assert_allclose(a[k].numpy(), np.asarray(b[k]), rtol=1e-6, atol=1e-12)


PCT = (1.0 / 3.0, 2.0 / 3.0)


def _cpu_trainer(gt_mode="tanh"):
    rng = np.random.default_rng(0)
    cloud = rng.uniform(-0.5, 0.5, (64, 3)).astype(np.float32)
    normals = np.tile(np.float32([0.0, 0.0, 1.0]), (64, 1))
    sampler = TrainingSampler.from_point_cloud_bootstrap(cloud, normals, 30, PCT, device="cpu")
    cfg = TrainConfig(batch_size=30, sampling_percentiles=PCT, num_epochs=8, s1_epochs=2,
                      gt_mode=gt_mode)
    trainer = tloop.Trainer(SirenSpec(hidden=(32, 32)), sampler, cfg)
    return trainer, trainer.init_state(), torch.Generator().manual_seed(3)


def _graph_counts():
    return tloop.graph_replays, tloop.graph_captures, tloop.eager_steps


@pytest.mark.parametrize("stage", ["s1", "s2", "siren"])
def test_cpu_epochs_stay_eager(stage):
    """On the CPU every epoch takes the eager step: ``eager_steps`` counts
    each, and no graph is captured or replayed."""
    trainer, state, gen = _cpu_trainer("siren" if stage == "siren" else "tanh")
    replays, captures, eager = _graph_counts()
    for e in range(4):
        trainer.epoch(state, stage, e, gen)
    assert _graph_counts() == (replays, captures, eager + 4)
    assert trainer._graph is None and state.opt_state.count == 4


def test_epoch_rows_do_not_alias():
    """The rows ``epoch`` returns are tensors of their own: stacked after
    several epochs, each still holds the values it had when returned, and
    the best loss is the state's tensor, updated in place."""
    trainer, state, gen = _cpu_trainer()
    best = state.best_loss
    rows, seen = [], []
    for e in range(5):
        rows.append(trainer.epoch(state, "s2", 2 + e, gen))
        seen.append(rows[-1].clone())
    assert len({r.data_ptr() for r in rows}) == len(rows)
    assert torch.equal(torch.stack(rows), torch.stack(seen))
    assert state.best_loss is best
    assert float(best) == float(torch.stack(seen)[:, -1].min())


@pytest.mark.parametrize("stage", ["s1", "s2", "siren"])
def test_epoch_evaluates_the_surface_rows_alone(stage, monkeypatch):
    """s2's loss calls the value path once a batch, on the batch's
    on-surface rows alone; s1 and siren take the derivative paths and never
    call it."""
    calls = _spy_value(monkeypatch)
    trainer, state, gen = _cpu_trainer("siren" if stage == "siren" else "tanh")
    for e in range(3):
        trainer.epoch(state, stage, e, gen)
    steps = 3 * trainer.cfg.batches_per_epoch
    assert calls == ([trainer.sampler.sizes.on_surface] * steps if stage == "s2" else [])


def test_train_state_files_cross_load(tmp_path):
    """A port train_state.npz loads with the JAX package's loader and the
    reverse, with equal params, moments, count, epoch and key."""
    spec = SirenSpec(hidden=HIDDEN)
    rng = np.random.default_rng(11)
    np_params = _params(5)
    mu = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in l.items()} for l in np_params]
    nu = [{k: rng.random(size=v.shape).astype(np.float32) for k, v in l.items()} for l in np_params]
    to_t = lambda tree: [{k: torch.tensor(v) for k, v in l.items()} for l in tree]  # noqa: E731
    to_j = lambda tree: [{k: jnp.asarray(v) for k, v in l.items()} for l in tree]  # noqa: E731
    key = key_from_seed(123)
    np.testing.assert_array_equal(key, np.asarray(jax.random.PRNGKey(123)))

    port_file = str(tmp_path / "port.npz")
    tckpt.save_train_state(port_file, to_t(np_params), tckpt.AdamState(17, to_t(mu), to_t(nu)),
                           42, key)
    opt = optax.scale_by_adam()
    tmpl_p = to_j(np_params)
    params, js, epoch, jkey = jckpt.load_train_state(port_file, tmpl_p, opt.init(tmpl_p))
    assert epoch == 42 and int(js.count) == 17
    np.testing.assert_array_equal(np.asarray(jkey), key)
    for got, want in ((params, np_params), (js.mu, mu), (js.nu, nu)):
        for a, b in zip(got, want):
            for k in ("w", "b"):
                np.testing.assert_array_equal(np.asarray(a[k]), b[k])

    jax_file = str(tmp_path / "jax.npz")
    jckpt.save_train_state(jax_file, tmpl_p,
                           optax.ScaleByAdamState(jnp.asarray(9, jnp.int32), to_j(mu), to_j(nu)),
                           7, jax.random.PRNGKey(5))
    tp, ts, epoch, tkey = tckpt.load_train_state(jax_file, spec, device="cpu")
    assert epoch == 7 and ts.count == 9
    np.testing.assert_array_equal(tkey, np.asarray(jax.random.PRNGKey(5)))
    for got, want in ((tp, np_params), (ts.mu, mu), (ts.nu, nu)):
        for a, b in zip(got, want):
            for k in ("w", "b"):
                np.testing.assert_array_equal(a[k].numpy(), b[k])


def test_config_round_trips_like_jax():
    with open(os.path.join(REPO, "configs", "train_cfg.json")) as fh:
        d = json.load(fh)
    d["onlyPCloud"] = True
    t, j = tcfg.TrainConfig.from_dict(d), jcfg.TrainConfig.from_dict(d)
    assert t.to_dict() == j.to_dict()
    assert t.network.to_spec().layer_dims == j.network.to_spec().layer_dims
    for f in ("deriv_dtype", "use_pallas", "only_pcloud", "seed"):
        assert getattr(t, f) == getattr(j, f)


def test_cli_trains_across_the_stage_boundary(tmp_path, monkeypatch):
    """Five CPU epochs through cli.train (s1 for three, s2 for two) on a
    preprocessed torus: finite losses, losses.csv in the JAX package's
    format, checkpoints, the slice figure (at width 32 here: 512 in the
    CLI) and both meshes; then a resume continues from the saved state."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tcli, "SLICE_WIDTH", 32)
    tpre.preprocess_mesh("demo", os.path.join(REPO, "data", "demo", "torus.obj"), 3000)
    cfg = {
        "dataset": "demo/torus", "experiment_name": "t", "checkpoint_path": "out",
        "num_epochs": 5, "s1_epochs": 3, "warmup_epochs": 1, "batch_size": 300,
        "gt_mode": "tanh", "alpha": 10, "onlyPCloud": True, "resolution": 24,
        "optimizer": {"type": "adam", "lr_s1": 1e-5, "lr_s2": 1e-7},
        "network": {"hidden_layer_nodes": [32, 32, 32], "w0": 30},
    }
    with open("cfg.json", "w") as fh:
        json.dump(cfg, fh)
    (_, meshes, state), stats = tcli.main(["cfg.json", "--device", "cpu"])
    assert stats["s1_steps"] == 3 and stats["s2_steps"] == 2
    assert all(len(m.faces) for m in meshes)
    out = os.path.join("out", "t")
    with open(os.path.join(out, "losses.csv")) as fh:
        rows = [line.rstrip("\n").split(";") for line in fh]
    assert rows[0] == ["grad_constraint", "hessian_constraint", "sdf_off_surf", "sdf_on_surf",
                       "std_on_surf", "total"]
    assert len(rows) == 6
    assert all(np.isfinite(float(v)) for r in rows[1:] for v in r if v)
    assert rows[1][4] == "" and rows[4][0] == ""  # s1 rows lack std, s2 rows lack grad
    for name in ("model_best", "model_current", "model_final"):
        assert os.path.exists(os.path.join(out, "models", name + ".npz"))
    assert os.listdir(os.path.join(out, "summaries"))  # TensorBoard event files
    assert set(stats["figure"]) == {"predict_s", "gt_s", "render_s"}
    for name in ("distance_fields.png", "pred_grad.png"):
        assert os.path.exists(os.path.join(out, "reconstructions", name))

    cfg["num_epochs"] = 6
    with open("cfg.json", "w") as fh:
        json.dump(cfg, fh)
    _, stats = tcli.main(["cfg.json", "--device", "cpu", "--resume"])
    assert stats.get("s1_steps", 0) == 0 and stats["s2_steps"] == 1


@pytest.mark.parametrize("stage", ["s1", "s2", "siren"])
def test_loss_terms_match_reference_golden(stage):
    """The port's losses against the reference's own values in
    tests/golden/field_losses_golden.npz (32-wide net, 256 points), at
    tests/test_golden_losses.py's tolerance: rel 2e-3, abs 1e-4."""
    g = np.load(os.path.join(REPO, "tests", "golden", "field_losses_golden.npz"))
    n = sum(1 for k in g.files if k[0] == "w" and k[1:].isdigit())
    params = [{"w": torch.from_numpy(g[f"w{i}"]), "b": torch.from_numpy(g[f"b{i}"])}
              for i in range(n)]
    spec = SirenSpec(hidden=tuple(g[f"w{i}"].shape[1] for i in range(n - 1)),
                     w0=float(g["freq_w0"]))
    pts, nrm, sdf = (torch.from_numpy(g[k][0]) for k in ("pts", "normals", "sdf"))
    weights = tuple(float(w) for w in g[f"{stage}_weights"])
    fn = {"s1": tl.loss_s1, "s2": tl.loss_s2, "siren": tl.loss_siren}[stage]
    terms = fn(params, spec, pts, nrm, sdf, weights, float(g["alpha"]))
    prefix = f"loss_{stage}_"
    assert set(terms) == {k[len(prefix):] for k in g.files if k.startswith(prefix)}
    for k, v in terms.items():
        ref = float(g[prefix + k])
        assert float(v) == pytest.approx(ref, rel=2e-3, abs=1e-4), (stage, k, float(v), ref)
