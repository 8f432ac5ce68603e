"""Driver of a training mix: one DUDF fit of ``diffudf_tpu_torch`` on one
device, through its library entry points.

A mix (``traffic/<mix>.json``) names the ``stage`` ("s1" or "s2"), its
``first_epoch`` and ``read_every``, the epochs between two reads of the
loss rows.  The stage runs to the configuration's ``s1_epochs`` (s1) or
``num_epochs`` (s2).

Set-up preprocesses the configuration's mesh (``cli.preprocess.
preprocess_mesh``) into ``benchmark/_work/<config>/``, builds the sampler
and its oracle (``cli.train.build_sampler``, which keeps its disk cache
beside the preprocessed files), makes the SIREN's initial weights from the
seed on the device, and builds one ``train.loop.Trainer`` and its state.
It drives that trainer through its first ``CHECKED_STEPS`` epochs with
``Trainer.epoch`` on the window's generator, keeping each batch, each loss
row, the Adam moments after the first step and the parameters after the
last, then through ``WARMUP_STEPS`` more epochs and one read of the loss
rows, so that every shape the window uses is built.

The window calls ``Trainer.epoch`` for the epochs that follow, reads the
loss rows to the host once every ``read_every`` epochs, as ``Trainer.run``
does, and stops enqueuing once ``--seconds`` have passed; the rate is all
the epochs over all the time to the device's last synchronisation.

A traced run times the sampler alone with CUDA events, then profiles
``TRACE_STEPS`` epochs.  Every run then reads the memory peak, frees the
program's state and holds the data set and the first steps to the
reference (``benchmark/reference.py``), on the device in blocks.
"""

from __future__ import annotations

import dataclasses
import gc
import os
import sys
import time
import types

import numpy as np
import torch

from benchmark import checks, reference, tracing
from benchmark.cells import HERE, REPO, Cell

WORK = os.path.join(HERE, "_work")  # preprocessed data and oracle caches
CHECKED_STEPS = 3  # epochs held to the reference
WARMUP_STEPS = 22  # further epochs of set-up, to the first read of the loss rows
TRACE_STEPS = 60  # epochs a traced run profiles with device activity only
NAMED_GAP_STEPS = 10  # epochs profiled with the host's operators, to name idle gaps
SAMPLE_CALLS = 100  # calls of the sampler alone between two CUDA events
STAGE_END = {"s1": "s1_epochs", "s2": "num_epochs"}  # the configuration's key


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def seeds(seed: int) -> tuple[int, int, int]:
    """Seeds of the initial weights, the batch stream and the sampler's own
    timing stream, from the run's seed."""
    ss = np.random.SeedSequence(int(seed) % 2**64)
    return tuple(int(s) for s in ss.generate_state(3, np.uint64))


def recipe(config: dict) -> dict:
    """The frozen recipe constants the reference and the window use."""
    t = config["train"]
    return {
        "warmup_lr": t["warmup_lr"], "warmup_epochs": t["warmup_epochs"],
        "s1_epochs": t["s1_epochs"], "num_epochs": t["num_epochs"],
        "lr_s1": t["optimizer"]["lr_s1"], "lr_s2": t["optimizer"]["lr_s2"],
        "alpha": t["alpha"], "loss_s1_weights": t["loss_s1_weights"],
        "loss_s2_weights": t["loss_s2_weights"],
        "adam_b1": config["adam"]["b1"], "adam_b2": config["adam"]["b2"],
        "adam_eps": config["adam"]["eps"],
    }


def stage_epochs(cell: Cell) -> tuple[int, int]:
    """The mix's first epoch and the end of its stage."""
    return (cell.traffic["first_epoch"],
            cell.config["train"][STAGE_END[cell.traffic["stage"]]])


def init_params(hidden, w0: float, seed: int, device):
    """SIREN initial weights (the published bounds: first layer U(±1/fan_in),
    others U(±sqrt(6/fan_in)/w0), biases U(±1/sqrt(fan_in))) from one draw
    on the device: [{"w": (in, out), "b": (out,)}], float32."""
    dims = [3] + list(hidden) + [1]
    shapes, bounds = [], []
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        shapes += [(a, b), (b,)]
        bounds += [1.0 / a if i == 0 else float(np.sqrt(6.0 / a) / w0), 1.0 / float(np.sqrt(a))]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(sum(int(np.prod(s)) for s in shapes), generator=gen, device=device)
    leaves, o = [], 0
    for s, bound in zip(shapes, bounds):
        n = int(np.prod(s))
        leaves.append(((flat[o:o + n] * 2.0 - 1.0) * bound).view(s))
        o += n
    return [{"w": leaves[2 * i], "b": leaves[2 * i + 1]} for i in range(len(leaves) // 2)]


def leaves(params):
    return [t for layer in params for t in (layer["w"], layer["b"])]


@dataclasses.dataclass
class Prepared:
    cfg: object  # TrainConfig
    spec: object  # SirenSpec
    sampler: object  # TrainingSampler
    dataset: str  # the preprocessed files' common prefix
    oracle_build_s: float


def prepare(cell: Cell, device) -> Prepared:
    """Preprocess the configuration's mesh and build the sampler."""
    from diffudf_tpu_torch.cli.preprocess import preprocess_mesh
    from diffudf_tpu_torch.cli.train import build_sampler
    from diffudf_tpu_torch.config import TrainConfig

    c = cell.config
    out = os.path.join(WORK, c["name"])
    name = preprocess_mesh(out, os.path.join(REPO, c["mesh"]), c["surface_points"],
                           seed=c["preprocess_seed"])
    d = dict(c["train"], network=c["network"], dataset=os.path.join(out, name),
             onlyPCloud=c["input"] == "pointcloud")
    cfg = TrainConfig.from_dict(d)
    t0 = time.perf_counter()
    sampler, _, _ = build_sampler(cfg, device=device)
    sync(device)
    return Prepared(cfg, cfg.network.to_spec(), sampler, d["dataset"], time.perf_counter() - t0)


class _Recorder:
    """The sampler, keeping a copy of every batch it hands out."""

    def __init__(self, inner):
        self.inner = inner
        self.batches = []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def sample(self, gen):
        out = self.inner.sample(gen)
        self.batches.append(tuple(t.detach().clone() for t in out))
        return out


@dataclasses.dataclass
class FirstSteps:
    """What the program produced in its first steps, on the host."""

    params0: list  # initial leaves, float32 arrays
    gen_states: list  # the generator's state before each step
    batches: list  # (points, normals, sdf) arrays a step
    terms: np.ndarray  # (steps, terms + 1): the stage's terms and their sum
    grad1: list  # the first gradient, from Adam's first moment
    delta1: list  # the parameters' change in the first step
    delta: list  # the parameters' change over the steps


def start(cell: Cell, prep: Prepared, seed: int, device):
    """One trainer and its state from the seed, driven through the checked
    steps.  -> (trainer, state, generator, next epoch, FirstSteps)."""
    from diffudf_tpu_torch.train.loop import Trainer

    stage = cell.traffic["stage"]
    p_seed, b_seed, _ = seeds(seed)
    trainer = Trainer(prep.spec, prep.sampler, prep.cfg)
    params = init_params(prep.spec.hidden, prep.spec.w0, p_seed, device)
    params0 = [t.detach().cpu().numpy().copy() for t in leaves(params)]
    state = trainer.init_state(params=params)
    gen = torch.Generator(device=device).manual_seed(b_seed)
    epoch = cell.traffic["first_epoch"]
    rec = _Recorder(trainer.sampler)
    trainer.sampler = rec
    states, rows, mu1, delta1 = [], [], None, None
    try:
        for k in range(CHECKED_STEPS):
            states.append(gen.get_state())
            rows.append(trainer.epoch(state, stage, epoch, gen))
            epoch += 1
            if k == 0:
                mu1 = [t.detach().double().cpu().numpy() for t in leaves(state.opt_state.mu)]
                delta1 = [t.detach().double().cpu().numpy() - p0
                          for t, p0 in zip(leaves(state.params), params0)]
    finally:
        trainer.sampler = rec.inner
    b1 = cell.config["adam"]["b1"]
    first = FirstSteps(
        params0=params0,
        gen_states=states,
        batches=[tuple(t.cpu().numpy() for t in b) for b in rec.batches],
        terms=torch.stack(rows)[:, :-1].double().cpu().numpy(),  # less epoch_loss
        grad1=[m / (1.0 - b1) for m in mu1],
        delta1=delta1,
        delta=[t.detach().double().cpu().numpy() - p0
               for t, p0 in zip(leaves(state.params), params0)],
    )
    return trainer, state, gen, epoch, first


def run_epochs(trainer, state, gen, stage, epoch, n):
    rows = [trainer.epoch(state, stage, epoch + k, gen) for k in range(n)]
    return torch.stack(rows).cpu().numpy() if rows else np.zeros((0, 6))


def window(trainer, state, gen, cell: Cell, epoch, seconds, device):
    """Epochs from ``epoch`` for ``seconds``; past the stage's last epoch
    the epoch index starts again at the stage's first, so the learning rate
    stays the stage's.  -> (epochs completed, seconds to the last
    synchronisation, epochs whose loss row is not finite)."""
    stage, read_every = cell.traffic["stage"], cell.traffic["read_every"]
    lo, hi = stage_epochs(cell)
    rows, failed, e, reads = [], 0, epoch, []

    def read():
        n = len(rows)
        table = torch.stack(rows).cpu().numpy()
        rows.clear()
        reads.append((n, time.perf_counter()))
        return int((~np.isfinite(table).all(axis=1)).sum())

    sync(device)
    t0 = time.perf_counter()
    while True:
        rows.append(trainer.epoch(state, stage, lo + (e - lo) % (hi - lo), gen))
        e += 1
        if len(rows) == read_every:
            failed += read()
        if time.perf_counter() - t0 >= seconds:
            break
    if rows:
        failed += read()
    sync(device)
    ends = [t0] + [t for _, t in reads]
    log(f"window's reads from unix time {time.time() - (time.perf_counter() - t0):.1f}, "
        "steps/s: " + ", ".join(
        f"{n / (b - a):.3f}" for (n, _), a, b in zip(reads, ends, ends[1:])))
    return e - epoch, time.perf_counter() - t0, failed


def time_sampler(sampler, seed: int, calls: int, device) -> float:
    """Mean ms of the program's ``sampler.sample(gen)`` called alone."""
    gen = torch.Generator(device=device).manual_seed(seed)
    for _ in range(3):
        sampler.sample(gen)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        sampler.sample(gen)
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / calls


def launch_counts():
    from diffudf_tpu_torch.ops import vg, vgh

    return {"K1": vgh.launches, "K2": vgh.bwd_launches, "K3a": vg.launches,
            "K3b": vg.bwd_launches}


def reference_data(cell: Cell, prep: Prepared, device) -> tuple[dict, float]:
    """The data set as the reference reads it: the source mesh normalised by
    the reference itself, and the program's point cloud once it is held to
    that mesh.  -> (data, ``data_gap``: the largest of the vertex gap of the
    program's normalised mesh and the cloud's distance from the mesh, each
    point to the nearest triangle whose normal is its own; infinite where
    the counts differ)."""
    c = cell.config
    tris = reference.normalized_triangles(os.path.join(REPO, c["mesh"]))
    theirs = reference.read_obj_triangles(prep.dataset + "_t.obj")
    mesh_gap = (float(np.abs(theirs - tris).max()) if theirs.shape == tris.shape
                else float("inf"))
    pts, nrm = reference.read_ply_points(prep.dataset + "_pc.ply")
    tris = torch.as_tensor(tris, device=device)
    data = {"cloud": torch.as_tensor(pts, device=device),
            "normals": torch.as_tensor(nrm, device=device),
            "triangles": None if c["input"] == "pointcloud" else tris}
    cloud_gap = (float(reference.cloud_off_mesh(data["cloud"], data["normals"], tris).max())
                 if len(pts) == c["surface_points"] else float("inf"))
    log(f"data set: mesh gap {mesh_gap!r}, cloud gap {cloud_gap!r}")
    return data, max(mesh_gap, cloud_gap)


def reference_steps(cell: Cell, data: dict, first: FirstSteps, device, tf32=False,
                    rows=None, alter=None, eig_dtype=torch.float64):
    """The reference's batches and its run through them from the same
    initial weights.  ``alter(batches)`` (optional) changes the reference's
    batches before it trains on them.  -> (batches as arrays, result)."""
    t = cell.config["train"]
    split = reference.Split.of(t["batch_size"], t["sampling_percentiles"])
    t0 = time.perf_counter()
    batches = [reference.draw_batch(s, data, split, cell.config["sampler"]["stddev"], device)
               for s in first.gen_states]
    sync(device)
    t1 = time.perf_counter()
    if alter is not None:
        batches = alter(batches)
    res = reference.follow(first.params0, [b + (split.on,) for b in batches], recipe(cell.config),
                           cell.traffic["stage"], cell.traffic["first_epoch"],
                           float(cell.config["network"]["w0"]), device, tf32=tf32, rows=rows,
                           eig_dtype=eig_dtype)
    sync(device)
    log(f"reference: batches {t1 - t0:.3f} s, steps {time.perf_counter() - t1:.3f} s")
    return [tuple(x.cpu().numpy() for x in b) for b in batches], res


def judge(cell: Cell, prep: Prepared, first: FirstSteps, device):
    """-> (correct, {name: {"value", "limit"}}, reference seconds)."""
    t0 = time.perf_counter()
    data, data_gap = reference_data(cell, prep, device)
    ref_batches, ref = reference_steps(cell, data, first, device)
    numbers = checks.gaps(dataclasses.asdict(first), ref, first.batches, ref_batches,
                          cell.traffic["stage"])
    numbers["data_gap"] = data_gap
    sync(device)
    ok, table = checks.verdict(numbers, cell.limits)
    log("readings not compared: " + ", ".join(
        f"{k} {v!r}" for k, v in numbers.items() if k not in checks.NAMES))
    return ok, table, time.perf_counter() - t0


def run(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float):
    """One run of the cell.  -> a namespace with ``values`` (metric name ->
    value), ``ctx`` (what the per-layer readers read; traced runs),
    ``attempted``, ``failed``, ``memory_peak_bytes``, ``correct``,
    ``checks``, and for traced runs ``busy_s``, ``window_s``,
    ``breakdown``."""
    stage = cell.traffic["stage"]
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    prep = prepare(cell, device)
    trainer, state, gen, epoch, first = start(cell, prep, seed, device)
    run_epochs(trainer, state, gen, stage, epoch, WARMUP_STEPS)
    epoch += WARMUP_STEPS
    sync(device)
    out = types.SimpleNamespace(values={}, ctx=None, breakdown=None)
    out.values["setup_s"] = time.perf_counter() - t_start
    log(f"set-up {out.values['setup_s']:.3f} s (oracle {prep.oracle_build_s:.3f} s), "
        f"window from epoch {epoch}")

    if not trace:
        steps, secs, failed = window(trainer, state, gen, cell, epoch, seconds, device)
        out.values[f"{stage}_steps_per_s"] = steps / secs
        out.attempted, out.failed = steps, failed
        log(f"window: {steps} epochs in {secs:.4f} s, {steps / secs:.4f} steps/s")
    else:
        sample_ms = time_sampler(prep.sampler, seeds(seed)[2], SAMPLE_CALLS, device)
        before, k = launch_counts(), TRACE_STEPS
        table, secs, events = tracing.profile(
            lambda: run_epochs(trainer, state, gen, stage, epoch, k))
        counts = {n: (v - before[n]) / k for n, v in launch_counts().items()}
        summary = tracing.summarize(events)
        epoch += k
        _, named_s, named_events = tracing.profile(
            lambda: run_epochs(trainer, state, gen, stage, epoch, NAMED_GAP_STEPS), host=True)
        named = tracing.summarize(named_events)
        failed = int((~np.isfinite(table).all(axis=1)).sum())
        t = cell.config["train"]
        split = reference.Split.of(t["batch_size"], t["sampling_percentiles"])
        out.ctx = types.SimpleNamespace(
            stage=stage, steps=k, window_s=secs, busy_s=summary["busy_s"],
            kernels=summary["kernels"], device=summary["device"], sample_ms=sample_ms,
            oracle_build_s=prep.oracle_build_s, hidden=list(prep.spec.hidden),
            n_on=split.on, n_off=split.far + split.near, launch_counts=counts,
            kernel_rows={"K1": split.on, "K2": split.on, "K3a": split.far + split.near,
                         "K3b": split.far + split.near})
        out.attempted, out.failed = k, failed
        out.busy_s, out.window_s = summary["busy_s"], secs
        out.breakdown = tracing.breakdown(summary, named)
        log(f"traced stretch (device activity): {k} epochs in {secs:.4f} s, "
            f"{k / secs:.4f} steps/s; device busy {summary['busy_s']:.4f} s; "
            f"sampler alone {sample_ms:.4f} ms; program launch counters a step {counts}")
        log(f"traced stretch (with the host's operators, for the idle gaps' names): "
            f"{NAMED_GAP_STEPS} epochs in {named_s:.4f} s, "
            f"{NAMED_GAP_STEPS / named_s:.4f} steps/s, device idle {100 * (1 - named['busy_s'] / named_s):.2f}%")

    sync(device)
    out.memory_peak_bytes = (torch.cuda.max_memory_allocated(device)
                             if torch.device(device).type == "cuda" else 0)
    log(f"memory peak {out.memory_peak_bytes} bytes")
    del trainer, state, gen
    prep.sampler = None
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    out.correct, out.checks, ref_s = judge(cell, prep, first, device)
    log(f"reference and checks {ref_s:.3f} s")
    return out
