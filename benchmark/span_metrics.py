"""The program's spans and work counters, read in three stretches of a
training stage, and the per-layer readings of them that the span metric
files (``metrics/<metric>.<stage>.py``, ``oracle_load_s``) read.

The stretches follow one another on the same trainer:

- (a) ``SPAN_STEPS`` epochs with the spans off and no profiler: the rate
  the spans are measured against;
- (b) ``SPAN_STEPS`` epochs with the spans on and no profiler: each span's
  inclusive host ms a step and its self ms, and the work counters'
  advance; the rate of (a) against that of (b) is the spans' on-cost.
  (a) and (b) alternate in blocks (``ORDER``), as a host's speed drifts
  over a run;
- (c) ``ANNOTATED_STEPS`` epochs with the spans on and annotating, under
  ``torch.profiler`` with CPU and CUDA activity: each kernel, copy and fill
  is put down to the program spans open when the host launched it (joined
  to its launch by ``args.correlation``, the launch's time matched against
  the stepping thread's span intervals by time, not by thread, since
  autograd launches the backward's kernels from its own thread), and each
  idle gap of the device to the innermost span open at its middle.

``ctx.spans`` holds what :func:`stretches` returns, and ``ctx.oracle_load_s``
the host seconds of the span ``data.oracle`` in set-up.  Each reading is
None where the run holds no such stretch, is of another stage, or never
recorded the span.

Run alone on a card, it sets up a cell as the training driver does (the
spans on around ``prepare``), warms up, runs the three stretches, prints
the per-span table on standard error and, as the last line of standard
output, one JSON object with the readings, the rates and ``correct``:

    python3 benchmark/span_metrics.py --workload train_s2.torus-pc --seed 2147483901
"""

from __future__ import annotations

import bisect
import collections
import os
import sys

if __name__ == "__main__":
    _HERE = os.path.dirname(os.path.abspath(__file__))
    if sys.path and os.path.abspath(sys.path[0]) == _HERE:
        sys.path[0] = os.path.dirname(_HERE)  # import the harness as ``benchmark``

SPAN_STEPS = 200  # epochs of stretches (a) and (b) each
# (a) and (b) alternate in blocks of SPAN_STEPS / 4 epochs (the spans on in
# (b)), so that the host's drift over the stretches falls on both alike
ORDER = (False, True, True, False, False, True, True, False)
ANNOTATED_STEPS = 10  # epochs of stretch (c)
PHASES = ("train.draw", "train.loss", "train.backward", "train.adam")
STEP = "train.epoch"
OUTSIDE = "outside the step"
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the reader files of this module: the stage metrics of s2 and s1, then the
# two that are no stage's
STAGE_METRICS = ("step_host_ms", "draw_host_ms", "loss_host_ms", "backward_host_ms",
                 "adam_host_ms", "draw_device_ms", "loss_device_ms", "backward_device_ms",
                 "adam_device_ms")
METRICS = (tuple(f"{m}.s2" for m in STAGE_METRICS) + ("value_rows_read_pct.s2",)
           + tuple(f"{m}.s1" for m in STAGE_METRICS) + ("oracle_load_s",))


# --- the program's recorder and counters --------------------------------------


def recorder():
    """The program's span recorder, or None where the program has none."""
    try:
        from diffudf_tpu_torch.utils import timing
    except ImportError:
        return None
    return timing if hasattr(timing, "span") and hasattr(timing, "enable") else None


def counters():
    """(``autodiff.ops.value_rows``, ``train.loop.surface_rows``), or None
    where the program has no such counters."""
    try:
        from diffudf_tpu_torch.autodiff import ops
        from diffudf_tpu_torch.train import loop
    except ImportError:
        return None
    if not (hasattr(ops, "value_rows") and hasattr(loop, "surface_rows")):
        return None
    return ops.value_rows, loop.surface_rows


# --- stretch (c): device work and idle gaps put down to the spans -------------


class OpenSpans:
    """Which of a thread's span intervals are open at a time."""

    def __init__(self, intervals):
        # by start, the enclosing span first where two start together
        self.iv = sorted(intervals, key=lambda s: (s[0], -s[1]))
        self.starts = [s[0] for s in self.iv]
        self.reach, end = [], float("-inf")
        for _, hi, _ in self.iv:
            end = max(end, hi)
            self.reach.append(end)  # the latest end of any span started so far

    def at(self, t: float) -> list:
        """Names of the spans open at ``t``, innermost first."""
        out = []
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.reach[i] > t:
            lo, hi, name = self.iv[i]
            if hi > t:
                out.append(name)
            i -= 1
        return out


def stepping_intervals(events, names) -> list:
    """(start, end, name) of the ``user_annotation`` events of the program's
    spans ``names`` on the thread that holds most of them."""
    ann = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
           and e.get("name") in names]
    if not ann:
        return []
    thread = collections.Counter((e.get("pid"), e.get("tid")) for e in ann).most_common(1)[0][0]
    return [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"])
            for e in ann if (e.get("pid"), e.get("tid")) == thread]


def attribute(events, names) -> dict:
    """The device activity of a Chrome trace put down to the program's
    spans.  -> {"device_s": {span: s, inclusive}, "self_device_s": {span or
    OUTSIDE: s, to the innermost span}, "launches": {span: kernels,
    inclusive}, "idle_s": {span or OUTSIDE: s of idle gaps, by the innermost
    span open at the gap's middle}, "total_device_s", "unmatched_s" (device
    time whose launch is not in the trace)}.  Times in seconds."""
    spans = OpenSpans(stepping_intervals(events, names))
    launch_ts = {}
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if e.get("ph") == "X" and e.get("cat") in _LAUNCH_CATS and corr is not None:
            launch_ts[corr] = float(e["ts"])
    dev = sorted((e for e in events if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS),
                 key=lambda e: float(e["ts"]))
    incl = dict.fromkeys(names, 0.0)
    launches = dict.fromkeys(names, 0)
    own = {OUTSIDE: 0.0, **incl}
    total = unmatched = 0.0
    for e in dev:
        dur = float(e.get("dur", 0.0)) * 1e-6
        total += dur
        t = launch_ts.get((e.get("args") or {}).get("correlation"))
        if t is None:
            unmatched += dur
            continue
        stack = spans.at(t)
        own[stack[0] if stack else OUTSIDE] += dur
        for name in set(stack):
            incl[name] += dur
            launches[name] += e.get("cat") == "kernel"
    idle = {OUTSIDE: 0.0, **dict.fromkeys(names, 0.0)}
    end = None
    for e in dev:
        lo = float(e["ts"])
        hi = lo + float(e.get("dur", 0.0))
        if end is not None and lo > end:
            stack = spans.at(0.5 * (lo + end))
            idle[stack[0] if stack else OUTSIDE] += (lo - end) * 1e-6
        end = hi if end is None else max(end, hi)
    return {"device_s": incl, "self_device_s": own, "launches": launches, "idle_s": idle,
            "total_device_s": total, "unmatched_s": unmatched}


# --- the three stretches -------------------------------------------------------


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def stretches(run, stage: str, device, steps: int = SPAN_STEPS,
              annotated: int = ANNOTATED_STEPS):
    """Stretches (a), (b) and (c) on ``run(n)``, which runs the next ``n``
    epochs of the trainer.  -> the readings (``ctx.spans``), or None where
    the program has no span recorder."""
    import time

    from benchmark import tracing

    timing = recorder()
    if timing is None:
        return None
    timing.enable(False)
    timing.clear()

    secs = {False: 0.0, True: 0.0}
    rows = [0, 0]
    block = 2 * steps // len(ORDER)
    try:
        for on in ORDER:
            c0 = counters()
            timing.enable(on)
            _sync(device)
            t0 = time.perf_counter()
            run(block)
            _sync(device)
            secs[on] += time.perf_counter() - t0
            timing.enable(False)
            if on and c0 is not None:
                rows = [r + c - b for r, c, b in zip(rows, counters(), c0)]
    finally:
        timing.enable(False)
    steps = block * len(ORDER) // 2
    off_s, on_s = secs[False], secs[True]
    summary, dropped = timing.summary(), timing.dropped()
    timing.clear()
    timing.enable(True, annotate=True)
    try:
        _, traced_s, events = tracing.profile(lambda: run(annotated), host=True)
    finally:
        timing.enable(False)
    names = {r.name for r in timing.records()}
    timing.clear()
    att = attribute(events, names)
    per = 1e3 / annotated
    return {
        "stage": stage, "steps": steps, "annotated_steps": annotated,
        "off_steps_per_s": steps / off_s, "on_steps_per_s": steps / on_s,
        "traced_steps_per_s": annotated / traced_s, "dropped": dropped,
        "host_ms": {n: s["total_ns"] * 1e-6 / steps for n, s in summary.items()},
        "host_self_ms": {n: s["self_ns"] * 1e-6 / steps for n, s in summary.items()},
        "value_rows": rows[0], "surface_rows": rows[1],
        "device_ms": {n: v * per for n, v in att["device_s"].items()},
        "self_device_ms": {n: v * per for n, v in att["self_device_s"].items()},
        "launches": {n: v / annotated for n, v in att["launches"].items()},
        "idle_ms": {n: v * per for n, v in att["idle_s"].items()},
        "device_total_ms": att["total_device_s"] * per,
        "unmatched_ms": att["unmatched_s"] * per,
    }


def table(sp: dict) -> list:
    """The readings as lines: per span, host ms (b), device ms, kernels and
    idle ms (c), a step."""
    names = sorted(set(sp["host_ms"]) | set(sp["device_ms"]),
                   key=lambda n: -sp["host_ms"].get(n, 0.0))
    lines = [f"{'span':<18} {'host ms':>9} {'self':>8} {'device ms':>10} {'self':>8} "
             f"{'kernels':>8} {'idle ms':>8}"]
    for n in names + [OUTSIDE]:
        lines.append(f"{n:<18} {sp['host_ms'].get(n, float('nan')):9.4f} "
                     f"{sp['host_self_ms'].get(n, float('nan')):8.4f} "
                     f"{sp['device_ms'].get(n, float('nan')):10.4f} "
                     f"{sp['self_device_ms'].get(n, float('nan')):8.4f} "
                     f"{sp['launches'].get(n, float('nan')):8.2f} "
                     f"{sp['idle_ms'].get(n, float('nan')):8.4f}")
    phases = sum(sp["device_ms"].get(n, 0.0) for n in PHASES)
    own = sp["self_device_ms"].get(STEP, 0.0) + sp["self_device_ms"].get("train.step", 0.0)
    total = sp["device_total_ms"]
    lines.append(f"device ms a step: {total:.4f}; the four phases {phases:.4f} + the epoch's "
                 f"and step's own {own:.4f} = {phases + own:.4f} "
                 f"({100 * (phases + own) / total if total else float('nan'):.2f}%); outside "
                 f"any span {sp['self_device_ms'][OUTSIDE]:.4f}; launch not found "
                 f"{sp['unmatched_ms']:.4f}")
    lines.append(f"steps/s: (a) spans off {sp['off_steps_per_s']:.4f}, (b) spans on "
                 f"{sp['on_steps_per_s']:.4f} ({100 * (sp['off_steps_per_s'] / sp['on_steps_per_s'] - 1):+.2f}% "
                 f"a step), (c) annotated under the profiler {sp['traced_steps_per_s']:.4f}; "
                 f"spans dropped {sp['dropped']}")
    return lines


# --- the readings ---------------------------------------------------------------


def _spans(ctx, stage: str):
    sp = getattr(ctx, "spans", None)
    return sp if sp and sp.get("stage") == stage else None


def host_ms(ctx, stage: str, name: str):
    """Inclusive host ms a step of the span ``name`` in stretch (b)."""
    sp = _spans(ctx, stage)
    return None if sp is None else sp["host_ms"].get(name)


def device_ms(ctx, stage: str, name: str):
    """Device ms a step launched inside the span ``name`` in stretch (c)."""
    sp = _spans(ctx, stage)
    return None if sp is None else sp["device_ms"].get(name)


def value_rows_read_pct(ctx, stage: str):
    """100 × on-surface rows drawn over rows the value path evaluated, over
    stretch (b)."""
    sp = _spans(ctx, stage)
    if sp is None or not sp.get("value_rows"):
        return None
    return 100.0 * sp["surface_rows"] / sp["value_rows"]


def oracle_load_s(ctx):
    """Host seconds of the span ``data.oracle`` in set-up."""
    return getattr(ctx, "oracle_load_s", None)


# --- alone on a card -------------------------------------------------------------


def main(argv=None) -> int:
    import argparse
    import gc
    import json
    import types

    p = argparse.ArgumentParser(description="The spans' stretches of one cell, on a card.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    args = p.parse_args(argv)
    import torch

    from benchmark import cells, run

    cell = cells.load(args.workload)
    if not torch.cuda.is_available():
        print("span_metrics: needs a CUDA device", file=sys.stderr)
        return 3
    timing = recorder()
    if timing is None:
        print("span_metrics: the program has no span recorder", file=sys.stderr)
        return 2
    from benchmark.drivers import train

    device = "cuda"
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    timing.clear()
    timing.enable(True)
    try:
        prep = train.prepare(cell, device)
    finally:
        timing.enable(False)
    oracle = timing.summary().get("data.oracle")
    timing.clear()
    stage = cell.traffic["stage"]
    trainer, state, gen, epoch, first = train.start(cell, prep, args.seed, device)
    train.run_epochs(trainer, state, gen, stage, epoch, train.WARMUP_STEPS)
    epoch += train.WARMUP_STEPS
    lo, hi = train.stage_epochs(cell)
    at = [epoch]

    def epochs(n):  # past the stage's end the index starts again, as in the window
        rows = [trainer.epoch(state, stage, lo + (at[0] + k - lo) % (hi - lo), gen)
                for k in range(n)]
        at[0] += n
        return torch.stack(rows).cpu()

    sp = stretches(epochs, stage, device)
    ctx = types.SimpleNamespace(stage=stage, spans=sp,
                                oracle_load_s=None if oracle is None else oracle["total_ns"] * 1e-9)
    metrics = {}
    for name in METRICS:
        v = cells.metric_reader(name)(ctx)
        if v is not None:
            metrics[name] = v
    for line in table(sp):
        print(line, file=sys.stderr)
    del trainer, state, gen
    prep.sampler = None
    gc.collect()
    torch.cuda.empty_cache()
    correct, checks, _ = train.judge(cell, prep, first, device)
    print(json.dumps({"correct": bool(correct), "metrics": metrics,
                      "device": torch.cuda.get_device_name(0), "card": run.power_limit(),
                      "spans": sp, "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
