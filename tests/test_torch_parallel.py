"""Port parity: data parallelism (``diffudf_tpu_torch.parallel.mesh``, the
data-parallel ``Trainer`` and ``cli.train``, the sharded serving paths) and
``utils/timing`` / ``utils/profiling``, against the JAX package on shared
numpy inputs.

The port's groups are gloo process groups of CPU ranks started by
``run_group``; each launch costs a few seconds of process start, so the
file makes two: one of 2 ranks (collectives, the fast DP steps, the oracle
swap's agreement, a short ``setup_train`` run, the sharded serving calls,
and a spawned rank free of JAX, matplotlib and PIL) and one of 4 (the
fallback step).  The JAX references run on a 2- and a 4-device slice of
the conftest's 8-device CPU mesh, on a thread of their own while the ranks
run.  The rank functions live here and are imported by the spawned ranks,
so JAX is imported inside the tests only.  Each launch has a time limit of
its own (``GROUP_TIMEOUT_S``): a rank that hangs fails its test.
"""

import concurrent.futures
import dataclasses
import json
import os
import re
import sys

import numpy as np
import pytest
import torch

from diffudf_tpu_torch.cli import preprocess as tpre
from diffudf_tpu_torch.cli import train as tcli
from diffudf_tpu_torch.config import TrainConfig
from diffudf_tpu_torch.data.sampling import TrainingSampler
from diffudf_tpu_torch.fields.siren import SirenSpec, params_from_jax
from diffudf_tpu_torch.grid import lattice
from diffudf_tpu_torch.ops.evaluate import evaluate_field
from diffudf_tpu_torch.parallel import mesh
from diffudf_tpu_torch.pc.sampler import project_points
from diffudf_tpu_torch.render import tracer
from diffudf_tpu_torch.train.loop import TERM_NAMES, Trainer
from diffudf_tpu_torch.utils.metrics import ScalarLogger
from diffudf_tpu_torch.utils.profiling import trace_to
from diffudf_tpu_torch.utils import timing
from diffudf_tpu_torch.utils.timing import force_sync

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden", "grid_rays_golden.npz")
# the tolerances of tests/test_torch_train.py: terms relative 1e-4, each
# gradient element within 2e-4 * max(max |grad|, 1) of its tensor
TERM_RTOL = 1e-4
GRAD_TOL = 2e-4
HIDDEN = (32, 32)
PCT = (1.0 / 3.0, 2.0 / 3.0)
# the DP steps' recipe, as __graft_entry__.py's dry run sets it; batch 48
# splits 16 / 16 / 16 (every group divides 2), batch 30 splits 10 / 10 / 10
# (no group divides 4: the fallback)
STEP_CFG = dict(num_epochs=4, s1_epochs=3, warmup_epochs=0, sampling_percentiles=PCT,
                alpha=10.0, lr_s1=1e-5, lr_s2=1e-7)
FAST_BATCH, FALLBACK_BATCH = 48, 30
SERVE = dict(gt_mode="tanh", alpha=10.0)
MARCH = dict(surface_threshold=0.03, max_iterations=40, fast=False)
# seconds a launch's rendezvous, collectives and exit may wait for a rank
GROUP_TIMEOUT_S = 240
# packages the port's ranks never import
FOREIGN = ("jax", "diffudf_tpu", "matplotlib", "PIL")


@dataclasses.dataclass
class _FixedSampler(TrainingSampler):
    """A sampler that draws one given batch (host arrays) every time."""

    batch: tuple = ()

    def sample(self, gen):
        return tuple(torch.as_tensor(a) for a in self.batch)


def _golden_net():
    g = np.load(GOLDEN)
    n = sum(1 for k in g.files if re.fullmatch(r"w\d+", k))
    return g, [{"w": g[f"w{i}"], "b": g[f"b{i}"]} for i in range(n)]


def _fixed_trainer(group, batch, batch_size):
    """A Trainer on ``group`` whose sampler always draws ``batch``."""
    zeros = np.zeros((8, 3), np.float32)
    boot = TrainingSampler.from_point_cloud_bootstrap(zeros, zeros, batch_size, PCT,
                                                      device="cpu")
    sampler = _FixedSampler(**{f.name: getattr(boot, f.name)
                               for f in dataclasses.fields(boot)}, batch=batch)
    cfg = TrainConfig(batch_size=batch_size, **STEP_CFG)
    return Trainer(SirenSpec(hidden=HIDDEN), sampler, cfg, group=group)


def _steps(trainer, group, np_params):
    """The s1 and s2 steps of this rank -> {stage: (terms row, grads as
    numpy, whether every rank holds the same gradient bits)}."""
    params = trainer.as_leaves(np_params)
    out = {}
    for stage in ("s1", "s2"):
        row, _, grads = trainer.batch_step(stage, params, *trainer.draw(None))
        flat = torch.cat([g.reshape(-1) for g in grads])
        same = np.all(group.per_rank(flat.numpy()) == flat.numpy()[None])
        out[stage] = (row.detach().numpy(), [g.numpy() for g in grads], bool(same))
    return out


def _two_ranks(group, inp):
    """Everything the 2-rank launch checks; -> rank 0's results."""
    out = {}
    # collectives: gather_rows (floats with signed zeros, bools) and the
    # differentiable all-reduce, forward and backward
    rows = group.shard_rows(5)
    block = torch.full((rows.stop - rows.start, 2), -0.0 if group.rank else 1.5)
    out["gather"] = group.gather_rows(block, 5).numpy()
    out["gather_bool"] = group.gather_rows(
        torch.full((rows.stop - rows.start,), group.rank == 1), 5).numpy()
    x = torch.arange(4.0, requires_grad=True) * 1.0
    x.retain_grad()
    y = group.all_reduce_sum(x * (group.rank + 1))
    (y * y).sum().backward()
    out["all_reduce"], out["all_reduce_grad"] = y.detach().numpy(), x.grad.numpy()

    # the fast DP steps on JAX's per-device batches
    trainer = _fixed_trainer(group, inp["batches"][group.rank], FAST_BATCH)
    out["dp"] = trainer.dp
    out["steps"] = _steps(trainer, group, inp["np_params"])

    # the sharded serving calls
    params = params_from_jax(inp["field"], "cpu")
    spec = SirenSpec(hidden=HIDDEN, w0=30.0)
    ev = evaluate_field(params, spec, torch.as_tensor(inp["eval_points"]), want_hess=True,
                        group=group)
    out["eval"] = tuple(t.numpy() for t in ev)
    out["sparse"] = lattice.extract_fields_sparse(params, spec, 33, "tanh", 10.0, group=group)
    origins, dirs = inp["rays"]
    ones = np.ones(len(origins), bool)
    pos, hits, it = tracer.trace_rays(params, spec, origins, dirs, ones, **SERVE, **MARCH,
                                      group=group)
    out["march"] = (pos.numpy(), hits.numpy(), it)
    out["compacted"] = tracer.trace_rays_compacted(params, spec, origins, dirs, ones, **SERVE,
                                                   **MARCH, group=group)
    x, step, nrm = project_points(params, spec, torch.as_tensor(inp["samples"]), **SERVE,
                                  num_steps=3, want_hessian_normals=True, group=group)
    out["project"] = (x.numpy(), step.numpy(), nrm.numpy())

    # the oracle swap: each rank's build hands over at its own poll (None
    # for ever: a failed build); the ranks swap together, or not at all
    swaps = []
    for ready_at in ((0, 2), (1, None)):
        at = ready_at[group.rank]
        polls = iter([None] * at + [trainer.sampler]) if at is not None else iter(())
        trainer.run(sampler_update=lambda: next(polls, None))
        swaps.append(trainer.last_swap_epoch)
    out["swaps"] = group.per_rank([-1 if e is None else e for e in swaps]).tolist()

    # a short run of setup_train: rank 1 is pointed at a directory of its
    # own, which must stay absent (rank 0 alone writes)
    cfg = dict(inp["train_cfg"])
    if group.rank:
        cfg["checkpoint_path"] = inp["rank1_out"]
    _, meshes, state = tcli.setup_train(TrainConfig.from_dict(cfg), make_meshes=False,
                                        verbose=False, device="cpu", group=group)
    out["meshes"] = meshes
    for name in ("params", "best_params"):
        flat = torch.cat([t.detach().reshape(-1) for layer in getattr(state, name)
                          for t in (layer["w"], layer["b"])]).numpy()
        out[name + "_equal"] = bool(np.all(group.per_rank(flat) == flat[None]))
    # the foreign packages each rank holds after all of the above (rank 0 is
    # the test process)
    foreign = [k for k in sys.modules if k.split(".")[0] in FOREIGN]
    out["foreign"] = group.per_rank(np.array([len(foreign)])).ravel().tolist()
    return out


def _four_ranks(group, batch, np_params):
    trainer = _fixed_trainer(group, batch, FALLBACK_BATCH)
    return {"dp": trainer.dp, "rows": trainer.draw(None)[3:], "steps": _steps(
        trainer, group, np_params)}


def _jax_trainer(batch_size, n_devices):
    import jax

    from diffudf_tpu.config import TrainConfig as JaxConfig
    from diffudf_tpu.data.sampling import BatchSizes, SamplerStatic
    from diffudf_tpu.data.sampling import TrainingSampler as JaxSampler
    from diffudf_tpu.fields.siren import SirenSpec as JaxSpec
    from diffudf_tpu.parallel.mesh import data_mesh
    from diffudf_tpu.train.loop import Trainer as JaxTrainer

    rng = np.random.default_rng(0)
    pts = rng.normal(size=(512, 3)).astype(np.float32)
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    # deriv_dtype None: float32 derivative carries (the JAX CPU default is bf16)
    cfg = JaxConfig(batch_size=batch_size, deriv_dtype=None, **STEP_CFG)
    # no candidate grid: the exact nearest-point sweep answers
    sampler = JaxSampler(jax.numpy.asarray(pts), jax.numpy.asarray(pts),
                         SamplerStatic(BatchSizes.from_config(batch_size, PCT), "pointcloud"))
    trainer = JaxTrainer(JaxSpec(hidden=HIDDEN), sampler, cfg, mesh=data_mesh(n_devices))
    state = trainer.init_state()
    np_params = [{k: np.asarray(v) for k, v in layer.items()} for layer in state.params]
    return jax, trainer, sampler, state, np_params


def _jax_steps(jax, build, sampler, state, key):
    out = {}
    for stage in ("s1", "s2"):
        step = jax.jit(build(stage))
        (_, _, grads), (_, terms) = step((state.params, state.opt_state), sampler, key)
        out[stage] = ([float(terms[k]) for k in TERM_NAMES[stage]],
                      [np.asarray(layer[k]) for layer in grads for k in ("w", "b")])
    return out


def _check_steps(got, want):
    for stage, (row, grads, same) in got.items():
        np.testing.assert_allclose(row, want[stage][0], rtol=TERM_RTOL, atol=1e-6,
                                   err_msg=stage)
        assert same, f"{stage}: the ranks apply different gradients"
        for i, (a, b) in enumerate(zip(grads, want[stage][1])):
            err = float(np.abs(a - b).max())
            assert err <= GRAD_TOL * max(float(np.abs(b).max()), 1.0), (stage, i, err)


def test_local_sizes_and_error_match_jax():
    from diffudf_tpu.data.sampling import BatchSizes as JaxSizes
    from diffudf_tpu.data.sampling import SamplerStatic, TrainingSampler as JaxSampler

    zeros = np.zeros((8, 3), np.float32)
    for batch, n in ((30000, 2), (30000, 3), (48, 2), (30000, 4), (30, 4)):
        boot = TrainingSampler.from_point_cloud_bootstrap(zeros, zeros, batch, (0.333, 0.666),
                                                          device="cpu")
        sizes = JaxSizes.from_config(batch, (0.333, 0.666))
        jax_sampler = JaxSampler(zeros, zeros, SamplerStatic(sizes, "pointcloud"))
        try:
            want = jax_sampler.local(n).static.sizes
        except ValueError as exc:
            with pytest.raises(ValueError, match=re.escape(str(exc))):
                boot.local(n)
            continue
        assert dataclasses.astuple(boot.local(n).sizes) == dataclasses.astuple(want)
        assert boot.local(n).sizes.total * n == boot.sizes.total


def test_group_of_one_is_a_no_op():
    g = mesh.single("cpu")
    t = torch.arange(3.0)
    assert g.all_reduce_sum(t) is t and g.gather_rows(t, 3) is t and g.broadcast(t) is t
    assert g.shard_rows(7) == slice(0, 7) and g.all_true(True) and not g.all_true(False)
    assert mesh.pad_to_multiple(9990, 4) == 9992 and mesh.pad_to_multiple(8, 4) == 8
    assert [mesh.DataGroup(r, 4).shard_rows(30) for r in range(4)] == [
        slice(0, 8), slice(8, 16), slice(16, 24), slice(24, 30)]
    assert mesh.pick_backend(["cuda:0", "cuda:1"]) == "nccl"
    assert mesh.pick_backend(["cuda:0", "cuda:0"]) == mesh.pick_backend(["cpu"] * 2) == "gloo"
    assert mesh.run_group(lambda group, x: (group.size, x), 1, (5,), devices=["cpu"]) == (1, 5)


def test_spread_keeps_a_named_device(tmp_path, monkeypatch):
    """spread: an index without N runs on that device alone, N >= 2 under an
    index other than 0 raises; cli.train's ordinal names the device."""
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)

    def echo(device, group, x):
        return str(device), group.size, group.backend, x

    assert mesh.spread(echo, "cuda:1", x=3) == ("cuda:1", 1, None, 3)
    assert mesh.spread(echo, "cuda:1", 1, x=3) == ("cuda:1", 1, None, 3)
    assert mesh.spread(echo, "cpu", x=4) == ("cpu", 1, None, 4)
    with pytest.raises(ValueError, match="cannot lead"):
        mesh.spread(echo, "cuda:1", 2, x=3)

    calls = []
    monkeypatch.setattr(tcli, "setup_train",
                        lambda cfg, **kw: calls.append(kw) or (0.0, None, None))
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(TrainConfig().to_dict()))
    tcli.main([str(cfg_path), "1"])
    tcli.main([str(cfg_path), "--mesh", "2"])
    tcli.main([str(cfg_path), "--device", "cpu"])
    assert [(c["device"], c["n_mesh_devices"]) for c in calls] == [
        ("cuda:1", 0), ("cuda", 2), ("cpu", 0)]


def test_two_ranks_match_jax_and_one_rank(tmp_path, monkeypatch):
    """One launch of 2 gloo ranks: the collectives; the fast s1 and s2 steps
    on JAX's per-device batches against JAX's sharded step on a 2-device
    mesh; the sharded evaluate_field, extract_fields_sparse, trace_rays
    (both marches) and project_points against the port at one rank and the
    JAX package on a 2-device mesh; a short setup_train run (params and
    best params equal on both ranks, rank 0 alone writes); the spawned rank
    imports neither jax, the JAX package, matplotlib nor PIL."""
    import jax.numpy as jnp

    from diffudf_tpu.fields.siren import SirenSpec as JaxSpec
    from diffudf_tpu.grid import lattice as jlat
    from diffudf_tpu.ops.evaluate import evaluate_field as jeval
    from diffudf_tpu.parallel.mesh import data_mesh
    from diffudf_tpu.pc import sampler as jpc
    from diffudf_tpu.render import tracer as jtr

    jax, jtrainer, jsampler, jstate, np_params = _jax_trainer(FAST_BATCH, 2)
    key = jax.random.PRNGKey(42)
    local = jsampler.local(2)
    batches = [tuple(np.asarray(a) for a in local.sample(jax.random.fold_in(key, i)))
               for i in range(2)]

    g, field = _golden_net()
    rng = np.random.default_rng(3)
    inp = {"batches": batches, "np_params": np_params, "field": field,
           "eval_points": rng.uniform(-1, 1, (301, 3)).astype(np.float32),
           "rays": (g["ray_origins"], g["ray_dirs"]),
           "samples": rng.uniform(-1, 1, (400, 3)).astype(np.float32),
           "rank1_out": str(tmp_path / "rank1")}
    jparams = [{k: jnp.asarray(v) for k, v in layer.items()} for layer in field]
    jspec, jmesh = JaxSpec(hidden=HIDDEN, w0=30.0), data_mesh(2)
    ones = np.ones(len(g["ray_origins"]), bool)
    kw = dict(SERVE, num_steps=3, want_hessian_normals=True)

    def jax_refs():
        """The JAX package's step and serving calls on the 2-device mesh."""
        return {
            "steps": _jax_steps(jax, jtrainer._build_sharded_batch_step, jsampler, jstate, key),
            "eval": jeval(jparams, jspec, inp["eval_points"], want_grad=True, want_hess=True,
                          tile=64, mesh=jmesh),
            "sparse": jlat.extract_fields_sparse(jparams, jspec, 33, "tanh", 10.0,
                                                 deriv_dtype=None, mesh=jmesh),
            "march": jtr.trace_rays(jparams, jspec, jnp.asarray(g["ray_origins"]),
                                    jnp.asarray(g["ray_dirs"]), jnp.asarray(ones), **SERVE,
                                    surface_threshold=0.03, max_iterations=40, fast=False,
                                    mesh=jmesh),
            "project": jpc.project_points(jparams, jspec, jnp.asarray(inp["samples"]),
                                          mesh=jmesh, **kw)}

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tcli, "SLICE_WIDTH", 16)
    tpre.preprocess_mesh("demo", os.path.join(REPO, "data", "demo", "torus.obj"), 2000)
    inp["train_cfg"] = {
        "dataset": "demo/torus", "experiment_name": "t", "checkpoint_path": "out",
        "num_epochs": 4, "s1_epochs": 3, "warmup_epochs": 1, "batch_size": FAST_BATCH,
        "sampling_percentiles": list(PCT),
        "gt_mode": "tanh", "alpha": 10, "onlyPCloud": True, "resolution": 0,
        "network": {"hidden_layer_nodes": list(HIDDEN), "w0": 30}}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        refs = pool.submit(jax_refs)
        out = mesh.run_group(_two_ranks, 2, (inp,), devices=["cpu", "cpu"],
                             timeout_s=GROUP_TIMEOUT_S)
        want = refs.result()

    assert out["foreign"][1] == 0, "the spawned rank imported jax, diffudf_tpu, matplotlib or PIL"
    assert np.array_equal(out["gather"], [[1.5, 1.5]] * 3 + [[-0.0, -0.0]] * 2)
    assert np.signbit(out["gather"][3:]).all()
    assert out["gather_bool"].tolist() == [False] * 3 + [True] * 2
    np.testing.assert_array_equal(out["all_reduce"], 3 * np.arange(4.0))
    # d/dx_r of sum((Σ_r (r+1) x)²) summed over both ranks' identical losses
    np.testing.assert_array_equal(out["all_reduce_grad"], 2 * 2 * 3 * np.arange(4.0))

    assert out["dp"] == "sharded"
    _check_steps(out["steps"], want["steps"])
    assert out["swaps"] == [[2, -1], [2, -1]]

    params, spec = params_from_jax(field, "cpu"), SirenSpec(hidden=HIDDEN, w0=30.0)
    one = evaluate_field(params, spec, torch.as_tensor(inp["eval_points"]), want_hess=True)
    for got, ref, jref, tol in zip(out["eval"], one, want["eval"], (1e-6, 1e-5, 1e-3)):
        np.testing.assert_allclose(got, ref.numpy(), rtol=0, atol=tol)
        np.testing.assert_allclose(got, np.asarray(jref), rtol=1e-4, atol=tol)

    udf, dirs = out["sparse"]
    udf1, dirs1 = lattice.extract_fields_sparse(params, spec, 33, "tanh", 10.0)
    udf0, dirs0 = want["sparse"]
    np.testing.assert_allclose(udf, udf1, rtol=0, atol=1e-6)
    np.testing.assert_allclose(dirs, dirs1, rtol=0, atol=1e-5)
    diff = np.abs(udf - udf0)
    assert np.median(diff) < 1e-5 and diff.max() < 2e-3, (np.median(diff), diff.max())
    has = np.linalg.norm(dirs0, axis=-1) > 0
    assert (has == (np.linalg.norm(dirs, axis=-1) > 0)).mean() > 0.999 and has.sum() > 100
    assert (np.sum(dirs[has] * dirs0[has], axis=-1) > 0.999).mean() > 0.99

    pos1, hits1, it1 = tracer.trace_rays(params, spec, *inp["rays"], ones, **SERVE, **MARCH)
    jpos, jhits, jit = want["march"]
    cpos1, chits1, cit1 = tracer.trace_rays_compacted(params, spec, *inp["rays"], ones,
                                                      **SERVE, **MARCH)
    for (pos, hits, it), (ref_pos, ref_hits, ref_it) in (
            (out["march"], (pos1.numpy(), hits1.numpy(), it1)),
            (out["march"], (np.asarray(jpos), np.asarray(jhits), int(jit))),
            (out["compacted"], (cpos1, chits1, cit1))):
        assert hits.sum() > 50 and it == ref_it
        np.testing.assert_array_equal(hits, ref_hits)
        np.testing.assert_allclose(pos[hits], ref_pos[hits], rtol=0, atol=1e-4)

    one = project_points(params, spec, torch.as_tensor(inp["samples"]), **kw)
    for ref in ((t.numpy() for t in one), (np.asarray(t) for t in want["project"])):
        x, step, nrm = ref
        err = np.abs(out["project"][0] - x).max(axis=1)
        assert err.max() <= 1e-5 and np.median(err) <= 1e-6, (err.max(), np.median(err))
        assert np.abs(out["project"][1] - step).max() <= 1e-6
        assert np.mean(1 - np.abs(np.sum(out["project"][2] * nrm, axis=1)) <= 1e-5) >= 0.99

    assert out["meshes"] is None and out["params_equal"] and out["best_params_equal"]
    assert not os.path.exists(inp["rank1_out"])
    run = os.path.join("out", "t")
    assert os.path.exists(os.path.join(run, "losses.csv"))
    assert os.path.exists(os.path.join(run, "models", "model_final.npz"))
    assert os.listdir(os.path.join(run, "summaries"))  # TensorBoard events
    for name in ("distance_fields.png", "pred_grad.png"):
        assert os.path.exists(os.path.join(run, "reconstructions", name))


def test_four_rank_fallback_matches_jax_and_one_device():
    """No batch group of 30 rows (10 / 10 / 10) divides 4: each of 4 ranks
    takes its block of one batch (8, 8, 8 and 6 rows; the first all surface,
    the last two none), against JAX's constrained step on a 4-device mesh
    and the port's single-device step on the same batch."""
    jax, jtrainer, jsampler, jstate, np_params = _jax_trainer(FALLBACK_BATCH, 4)
    key = jax.random.PRNGKey(7)
    batch = tuple(np.asarray(a) for a in jsampler.sample(key))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        want = pool.submit(_jax_steps, jax, jtrainer._build_constrained_batch_step, jsampler,
                           jstate, key)
        with pytest.warns(RuntimeWarning,
                          match="falling back to the constrained-sharding DP step"):
            out = mesh.run_group(_four_ranks, 4, (batch, np_params), devices=["cpu"] * 4,
                                 timeout_s=GROUP_TIMEOUT_S)
        want = want.result()
    assert out["dp"] == "constrained" and out["rows"] == (8, 8 / 30)
    _check_steps(out["steps"], want)
    single = _steps(_fixed_trainer(None, batch, FALLBACK_BATCH), mesh.single(), np_params)
    for stage, (row, grads, _) in single.items():
        np.testing.assert_allclose(out["steps"][stage][0], row, rtol=1e-5, atol=1e-7)
        for a, b in zip(out["steps"][stage][1], grads):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6 * max(np.abs(b).max(), 1.0))


def test_phase_timer_trace_to_and_event_file(tmp_path):
    """tests/test_utils_aux.py's PhaseTimer case, on the span recorder's
    ``summary()``, which takes PhaseTimer's place; force_sync reads one
    element; trace_to writes a Chrome trace on the CPU; the logger's
    TensorBoard event file decodes with TensorBoard's own Event proto."""
    import struct
    import time

    from tensorboard.compat.proto import event_pb2

    from diffudf_tpu_torch.utils.metrics import crc32c

    lg = ScalarLogger(str(tmp_path / "log"), tensorboard=True)
    lg.log_array("loss", 0, [3.0, 2.0, 1.5])
    lg.close()
    (name,) = os.listdir(tmp_path / "log" / "summaries")
    data = (tmp_path / "log" / "summaries" / name).read_bytes()
    events = []
    while data:
        n = struct.unpack("<Q", data[:8])[0]
        events.append(event_pb2.Event.FromString(data[12:12 + n]))
        data = data[16 + n:]
    assert events[0].file_version == "brain.Event:2"
    assert [(e.step, e.summary.value[0].tag, e.summary.value[0].simple_value)
            for e in events[1:]] == [(0, "loss", 3.0), (1, "loss", 2.0), (2, "loss", 1.5)]
    assert crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value

    timing.clear()
    timing.enable(True)
    try:
        with timing.span("a"):
            time.sleep(0.01)
        with timing.span("a"):
            time.sleep(0.01)
        with timing.span("b"):
            pass
    finally:
        timing.enable(False)
    rep = timing.summary()
    timing.clear()
    assert rep["a"]["calls"] == 2 and rep["a"]["total_ns"] >= 0.02e9 and "b" in rep
    assert rep["a"]["self_ns"] == rep["a"]["total_ns"]
    with trace_to(str(tmp_path)):
        x = torch.ones(4, 4) @ torch.ones(4, 4)
    assert force_sync({"x": [x]}) == 4.0
    traces = [f for f in os.listdir(tmp_path) if f.endswith(".pt.trace.json")]
    assert len(traces) == 1 and os.path.getsize(tmp_path / traces[0]) > 0
