"""A device trace of a stretch of work, from ``torch.profiler``, reduced to
what the per-layer metrics read: the device's kernels in stream order, its
busy time, its idle gaps named by what the host was doing, and the
contract's ``breakdown``."""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time

import torch

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10
NAMED_GAPS = 500  # the longest idle gaps, each named by the host's activity
SCAN = 4000  # host events looked back over for the one open at a gap


def profile(work, host: bool = False):
    """Run ``work()`` under the profiler and synchronise: the device's
    activity, and with ``host`` the host's operators too, which slows the
    host several fold.  -> (its result, host seconds, list of trace
    events)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as _profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host else [ProfilerActivity.CUDA]
    with _profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = work()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        os.remove(path)
    return out, secs, events


def _union_seconds(spans):
    total, end = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        if hi <= end:
            continue
        total += hi - max(lo, end)
        end = hi
    return total


def summarize(events) -> dict:
    """-> {"kernels": [{"name", "ts", "dur_s"}] in stream order, "device":
    every device activity the same way, "busy_s", "gaps": [(host op,
    seconds)], "device_ops": [(name, seconds)]} by time, largest first."""
    dev = sorted(({"name": e.get("name", ""), "cat": e.get("cat"), "ts": float(e["ts"]),
                   "dur_s": float(e.get("dur", 0.0)) * 1e-6}
                  for e in events if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS),
                 key=lambda e: e["ts"])
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
                    e.get("name", ""))
                   for e in events if e.get("ph") == "X"
                   and e.get("cat") in ("cpu_op", "cuda_runtime", "cuda_driver",
                                        "python_function", "user_annotation")),
                  key=lambda t: t[0])
    spans = [(e["ts"], e["ts"] + e["dur_s"] * 1e6) for e in dev]
    busy = _union_seconds(spans) * 1e-6 if spans else 0.0

    idle, end = [], None
    for lo, hi in sorted(spans):
        if end is not None and lo > end:
            idle.append((lo - end, 0.5 * (lo + end)))
        end = hi if end is None else max(end, hi)
    starts = [h[0] for h in host]
    gaps = {}
    for length, mid in sorted(idle, reverse=True)[:NAMED_GAPS]:
        # the innermost host event open at the gap's middle: the one that
        # started last among those that have not ended
        i = bisect.bisect_right(starts, mid) - 1
        what = "host idle"
        for j in range(i, max(i - SCAN, -1), -1):
            if host[j][1] >= mid:
                what = host[j][2]
                break
        gaps[what] = gaps.get(what, 0.0) + length * 1e-6
    by_name = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur_s"]
    return {
        "kernels": [e for e in dev if e["cat"] == "kernel"],
        "device": dev,
        "busy_s": busy,
        "gaps": sorted(gaps.items(), key=lambda kv: -kv[1]),
        "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1]),
    }


def breakdown(summary: dict, named: dict) -> dict:
    """The contract's ``breakdown``: the ten device operations of ``summary``
    that took most time, and the ten longest idle gaps of ``named`` (a
    stretch traced with the host's operators) by host activity, in
    seconds."""
    return {"device_ops": [[n[:160], s] for n, s in summary["device_ops"][:TOP]],
            "idle_gaps": [[n[:160], s] for n, s in named["gaps"][:TOP]]}
