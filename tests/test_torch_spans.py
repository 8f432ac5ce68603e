"""The port's span recorder (``diffudf_tpu_torch/utils/timing.py``), the
spans in the training step and the two work counters, on the CPU."""

import json
import os
import threading

import numpy as np
import pytest
import torch

from diffudf_tpu_torch.config import TrainConfig
from diffudf_tpu_torch.data.sampling import TrainingSampler
from diffudf_tpu_torch.fields.siren import SirenSpec
from diffudf_tpu_torch.train import loop
from diffudf_tpu_torch.utils import timing
from diffudf_tpu_torch.utils.profiling import trace_to

PCT = (1.0 / 3.0, 2.0 / 3.0)


@pytest.fixture(autouse=True)
def recorder():
    """Each test starts and ends with the recorder off and empty."""
    timing.enable(False)
    timing.clear()
    timing.set_step(-1)
    yield
    timing.enable(False)
    timing.clear()
    timing.set_step(-1)


class _Clock:
    """A ``perf_counter_ns`` that advances 10 ns a read."""

    def __init__(self):
        self.t = 0

    def __call__(self):
        self.t += 10
        return self.t


def _raise(*args, **kwargs):
    raise AssertionError("called while the spans are off")


def test_off_reads_no_clock_and_calls_no_torch(monkeypatch):
    monkeypatch.setattr(timing.time, "perf_counter_ns", _raise)
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    assert not timing.enabled()
    with timing.span("a"):
        with timing.span("b"):
            pass
    assert timing.span("a") is timing.span("b")  # one shared null context
    assert timing.records() == [] and timing.summary() == {} and timing.dropped() == 0


def test_on_records_nesting_parents_thread_and_step(monkeypatch):
    monkeypatch.setattr(timing.time, "perf_counter_ns", _Clock())
    timing.enable(True)
    timing.set_step(7)
    with timing.span("outer"):
        with timing.span("a"):
            with timing.span("leaf"):
                pass
        timing.set_step(8)
        with timing.span("a"):
            pass
    timing.enable(False)
    with timing.span("ignored"):
        pass
    recs = timing.records()
    assert [r.name for r in recs] == ["outer", "a", "leaf", "a"]
    assert [r.parent for r in recs] == [-1, 0, 1, 0]
    assert [r.step for r in recs] == [7, 7, 7, 8]
    assert {r.thread for r in recs} == {threading.get_ident()}
    assert all(r.end_ns > r.start_ns for r in recs)
    # clock reads: outer 10..80, a 20..50, leaf 30..40, a 60..70
    assert [(r.start_ns, r.end_ns) for r in recs] == [(10, 80), (20, 50), (30, 40), (60, 70)]
    s = timing.summary()
    assert s["outer"] == {"calls": 1, "total_ns": 70, "self_ns": 70 - 30 - 10}
    assert s["a"] == {"calls": 2, "total_ns": 40, "self_ns": 40 - 10}
    assert s["leaf"] == {"calls": 1, "total_ns": 10, "self_ns": 10}


def test_spans_of_another_thread_have_their_own_parents():
    timing.enable(True)
    seen = []

    def work():
        with timing.span("worker"):
            with timing.span("worker.inner"):
                seen.append(threading.get_ident())

    with timing.span("main"):
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    recs = {r.name: (i, r) for i, r in enumerate(timing.records())}
    assert recs["worker"][1].parent == -1 and recs["main"][1].parent == -1
    assert recs["worker.inner"][1].parent == recs["worker"][0]
    assert recs["worker"][1].thread == seen[0] != recs["main"][1].thread


def test_cap_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(timing, "CAP", 3)
    timing.enable(True)
    with timing.span("kept"):
        for _ in range(4):
            with timing.span("child"):
                pass
    assert [r.name for r in timing.records()] == ["kept", "child", "child"]
    assert timing.dropped() == 2
    assert timing.summary()["kept"]["calls"] == 1
    timing.clear()
    assert timing.records() == [] and timing.dropped() == 0


def _annotations(path):
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    return [e["name"] for e in events if e.get("cat") == "user_annotation"]


def test_annotate_puts_spans_in_the_profilers_trace(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    timing.enable(True, annotate=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timing.span("train.step"):
            with timing.span("train.loss"):
                torch.ones(8, 8) @ torch.ones(8, 8)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    assert {"train.step", "train.loss"} <= set(_annotations(path))
    assert [r.name for r in timing.records()] == ["train.step", "train.loss"]


@pytest.mark.parametrize("on", [False, True])
def test_trace_to_annotates_only_spans_that_are_on(tmp_path, on):
    timing.enable(on)
    with trace_to(str(tmp_path)):
        assert timing.annotating() is on
        with timing.span("data.oracle"):
            torch.ones(4, 4) @ torch.ones(4, 4)
    assert timing.enabled() is on and not timing.annotating()
    (name,) = [f for f in os.listdir(tmp_path) if f.endswith(".pt.trace.json")]
    assert ("data.oracle" in _annotations(str(tmp_path / name))) is on


def _trainer(hidden=(32, 32)):
    rng = np.random.default_rng(0)
    cloud = rng.uniform(-0.5, 0.5, (64, 3)).astype(np.float32)
    normals = np.tile(np.float32([0.0, 0.0, 1.0]), (64, 1))
    sampler = TrainingSampler.from_point_cloud_bootstrap(cloud, normals, 30, PCT, device="cpu")
    cfg = TrainConfig(batch_size=30, sampling_percentiles=PCT, num_epochs=4, s1_epochs=2)
    trainer = loop.Trainer(SirenSpec(hidden=hidden), sampler, cfg)
    return trainer, trainer.init_state(), torch.Generator().manual_seed(3)


def _tree(recs, i=-1):
    """The records' tree below index ``i``: [(name, subtree)] in order."""
    return [(r.name, _tree(recs, j)) for j, r in enumerate(recs) if r.parent == i]


DRAW = ("train.draw", [("sample.draw", []), ("sample.oracle", [])])


@pytest.mark.parametrize("stage, loss", [
    ("s2", []),
    ("s1", [("loss.derivs", []), ("loss.eig", []), ("loss.terms", [])]),
    ("siren", []),
])
def test_epoch_spans(stage, loss):
    trainer, state, gen = _trainer()
    timing.enable(True)
    trainer.epoch(state, stage, 11, gen)
    recs = timing.records()
    assert _tree(recs) == [("train.epoch", [("train.step", [
        DRAW, ("train.loss", loss), ("train.backward", []), ("train.adam", [])])])]
    assert {r.step for r in recs} == {11}
    s = timing.summary()
    assert s["train.epoch"]["self_ns"] >= 0 and s["train.step"]["calls"] == 1
    assert s["train.epoch"]["total_ns"] >= sum(
        s[n]["total_ns"] for n in ("train.draw", "train.loss", "train.backward", "train.adam"))


def test_build_sampler_spans(tmp_path):
    from diffudf_tpu_torch.cli import preprocess as tpre
    from diffudf_tpu_torch.cli import train as tcli

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    name = tpre.preprocess_mesh(str(tmp_path), os.path.join(here, "data", "demo", "torus.obj"),
                                500, seed=1)
    cfg = TrainConfig(batch_size=30, sampling_percentiles=PCT,
                      dataset=str(tmp_path / name), only_pcloud=True)
    timing.enable(True)
    tcli.build_sampler(cfg, device="cpu")
    assert [(r.name, r.parent) for r in timing.records()] == [
        ("data.load_inputs", -1), ("data.oracle", -1)]
