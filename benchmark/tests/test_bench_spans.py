"""The span readings (``benchmark/span_metrics.py``): device work and idle
gaps put down to the program's spans on synthetic trace events, the
readers outside their stage, and the three stretches on a tiny CPU
trainer."""

import types

import pytest
import torch

from benchmark import cells, span_metrics

MAIN, AUTOGRAD = 101, 202  # the stepping thread and autograd's device thread
NAMES = {"train.epoch", "train.step", "train.draw", "sample.oracle", "train.loss",
         "train.backward", "train.adam"}


def _span(name, ts, dur, tid=MAIN):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid}


def _launch(corr, ts, tid=MAIN):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 1,
            "pid": 1, "tid": tid, "args": {"correlation": corr}}


def _kernel(corr, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": f"k{corr}", "ts": ts, "dur": dur, "pid": 0,
            "tid": 7, "args": {"correlation": corr}}


def _step_events():
    """One step, in µs: epoch 0-100 > step 0-90 > draw 0-20 (> oracle
    5-20), loss 20-40, backward 40-80, adam 80-90."""
    ev = [_span("train.epoch", 0, 100), _span("train.step", 0, 90),
          _span("train.draw", 0, 20), _span("sample.oracle", 5, 15),
          _span("train.loss", 20, 20), _span("train.backward", 40, 40),
          _span("train.adam", 80, 10), _span("some.other", 0, 200, tid=AUTOGRAD)]
    # launches: draw (1), oracle (2), loss (3), backward from autograd's
    # thread (4, 5), adam (6), the epoch's own (7), one before the step (8)
    for corr, ts, tid in ((1, 2, MAIN), (2, 10, MAIN), (3, 25, MAIN), (4, 45, AUTOGRAD),
                          (5, 60, AUTOGRAD), (6, 85, MAIN), (7, 95, MAIN), (8, -10, MAIN)):
        ev.append(_launch(corr, ts, tid))
    # the device runs each shortly after its launch; 9 has no launch event
    ev += [_kernel(8, 0, 4), _kernel(1, 5, 2), _kernel(2, 12, 6, "gpu_memcpy"),
           _kernel(3, 30, 5), _kernel(4, 50, 4), _kernel(5, 66, 10), _kernel(6, 88, 3),
           _kernel(7, 97, 2), _kernel(9, 99, 1)]
    return ev


def test_device_work_goes_to_the_spans_open_at_its_launch():
    att = span_metrics.attribute(_step_events(), NAMES)
    s = 1e-6
    assert att["self_device_s"] == pytest.approx({
        span_metrics.OUTSIDE: 4 * s, "train.draw": 2 * s, "sample.oracle": 6 * s,
        "train.loss": 5 * s, "train.backward": 14 * s, "train.adam": 3 * s,
        "train.epoch": 2 * s, "train.step": 0.0})
    assert att["device_s"]["train.draw"] == pytest.approx(8 * s)  # its oracle's copy too
    assert att["device_s"]["train.step"] == pytest.approx(30 * s)
    assert att["device_s"]["train.epoch"] == pytest.approx(32 * s)
    assert att["launches"] == {"train.epoch": 6, "train.step": 5, "train.draw": 1,
                               "sample.oracle": 0, "train.loss": 1, "train.backward": 2,
                               "train.adam": 1}
    assert att["total_device_s"] == pytest.approx(37 * s)
    assert att["unmatched_s"] == pytest.approx(1 * s)


def test_a_kernel_launched_from_another_thread_goes_to_the_open_span():
    """Autograd launches the backward's kernels from its own thread while
    the stepping thread sits in ``train.backward``: matched by time."""
    att = span_metrics.attribute(_step_events(), NAMES)
    assert att["launches"]["train.backward"] == 2
    assert att["device_s"]["train.backward"] == pytest.approx(14e-6)


def test_idle_gaps_take_the_innermost_open_span():
    att = span_metrics.attribute(_step_events(), NAMES)
    s = 1e-6
    # busy 0-4, 5-7, 12-18, 30-35, 50-54, 66-76, 88-91, 97-100; the gaps'
    # middles: 4.5 draw (its oracle opens at 5), 9.5 oracle, 24 loss, 42.5
    # and 60 backward, 82 adam, 94 the epoch's own
    assert att["idle_s"] == pytest.approx({
        span_metrics.OUTSIDE: 0.0, "train.draw": 1 * s, "sample.oracle": 5 * s,
        "train.loss": 12 * s, "train.backward": 27 * s, "train.adam": 12 * s,
        "train.epoch": 6 * s, "train.step": 0.0})


def test_gap_outside_every_span():
    ev = [_span("train.epoch", 0, 10), _launch(1, 1), _launch(2, 2),
          _kernel(1, 1, 1), _kernel(2, 30, 1)]
    att = span_metrics.attribute(ev, {"train.epoch"})
    assert att["idle_s"] == pytest.approx({span_metrics.OUTSIDE: 28e-6, "train.epoch": 0.0})


def test_open_spans_nest_when_two_start_together():
    spans = span_metrics.OpenSpans([(0, 10, "inner"), (0, 50, "outer"), (20, 30, "later")])
    assert spans.at(5) == ["inner", "outer"]
    assert spans.at(15) == ["outer"] and spans.at(25) == ["later", "outer"]
    assert spans.at(-1) == [] and spans.at(50) == []


def _spans_ctx(stage):
    return types.SimpleNamespace(stage=stage, oracle_load_s=0.5, spans={
        "stage": stage,
        "host_ms": {"train.epoch": 5.0, "train.draw": 1.0, "train.loss": 1.2,
                    "train.backward": 1.5, "train.adam": 0.4},
        "device_ms": {"train.epoch": 3.9, "train.draw": 0.5, "train.loss": 1.0,
                      "train.backward": 2.2, "train.adam": 0.1},
        "value_rows": 3000, "surface_rows": 999})


S2 = tuple(m for m in span_metrics.METRICS if m.endswith(".s2"))
S1 = tuple(m for m in span_metrics.METRICS if m.endswith(".s1"))


def test_readers_read_their_spans():
    read = {m: cells.metric_reader(m)(_spans_ctx("s2")) for m in S2 + ("oracle_load_s",)}
    assert read == pytest.approx({
        "step_host_ms.s2": 5.0, "draw_host_ms.s2": 1.0, "loss_host_ms.s2": 1.2,
        "backward_host_ms.s2": 1.5, "adam_host_ms.s2": 0.4, "draw_device_ms.s2": 0.5,
        "loss_device_ms.s2": 1.0, "backward_device_ms.s2": 2.2, "adam_device_ms.s2": 0.1,
        "value_rows_read_pct.s2": 33.3, "oracle_load_s": 0.5})
    s1 = {m: cells.metric_reader(m)(_spans_ctx("s1")) for m in S1}
    assert s1["step_host_ms.s1"] == 5.0 and s1["backward_device_ms.s1"] == 2.2


@pytest.mark.parametrize("stage, others", [("s2", S1), ("s1", S2)])
def test_readers_find_nothing_outside_their_stage(stage, others):
    for m in others:
        assert cells.metric_reader(m)(_spans_ctx(stage)) is None, m


def test_readers_find_nothing_without_the_stretches():
    """The training driver's traced context as it is: no ``spans`` and no
    ``oracle_load_s``, so every reader finds nothing."""
    ctx = types.SimpleNamespace(stage="s2", steps=2, window_s=0.05, busy_s=0.04, kernels=[],
                                device=[], sample_ms=0.5, oracle_build_s=1.5)
    for m in span_metrics.METRICS:
        assert cells.metric_reader(m)(ctx) is None, m
    ctx.spans = dict(_spans_ctx("s2").spans, host_ms={}, device_ms={}, value_rows=0)
    for m in S2:
        assert cells.metric_reader(m)(ctx) is None, m


def test_three_stretches_on_a_tiny_cpu_trainer(monkeypatch):
    """Stretches (a)-(c) run on the CPU (the profiler then sees no device
    work): every phase has host time, the counters give the batch's
    surface share, and the recorder is off and empty afterwards."""
    import numpy as np

    from diffudf_tpu_torch.config import TrainConfig
    from diffudf_tpu_torch.data.sampling import TrainingSampler
    from diffudf_tpu_torch.fields.siren import SirenSpec
    from diffudf_tpu_torch.train.loop import Trainer
    from diffudf_tpu_torch.utils import timing

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    rng = np.random.default_rng(0)
    cloud = rng.uniform(-0.5, 0.5, (64, 3)).astype(np.float32)
    pct = (1.0 / 3.0, 2.0 / 3.0)
    sampler = TrainingSampler.from_point_cloud_bootstrap(cloud, cloud, 30, pct, device="cpu")
    trainer = Trainer(SirenSpec(hidden=(16, 16)), sampler,
                      TrainConfig(batch_size=30, sampling_percentiles=pct))
    state, gen = trainer.init_state(), torch.Generator().manual_seed(1)

    def run(n):
        for e in range(n):
            trainer.epoch(state, "s2", 2000 + e, gen)

    sp = span_metrics.stretches(run, "s2", "cpu", steps=4, annotated=2)
    assert not timing.enabled() and timing.records() == []
    assert set(span_metrics.PHASES) | {"train.epoch", "sample.draw"} <= set(sp["host_ms"])
    assert sum(sp["host_ms"][n] for n in span_metrics.PHASES) <= sp["host_ms"]["train.epoch"]
    # (b)'s four blocks of one epoch each
    assert sp["steps"] == 4 and sp["value_rows"] == 4 * 30 and sp["surface_rows"] == 4 * 10
    ctx = types.SimpleNamespace(stage="s2", spans=sp)
    assert cells.metric_reader("value_rows_read_pct.s2")(ctx) == pytest.approx(100 / 3)
    assert cells.metric_reader("loss_device_ms.s2")(ctx) == 0.0  # no device on the CPU
    assert sp["device_total_ms"] == 0.0 and sp["dropped"] == 0
    assert len(span_metrics.table(sp)) > 8


def test_alone_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert span_metrics.main(["--workload", "train_s2.torus-pc", "--seed", "1"]) != 0
