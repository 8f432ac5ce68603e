"""Spans: where the host's time goes, phase by phase, and under a running
``torch.profiler`` which phase launched each kernel.

One process-wide recorder.  ``span(name)`` is a context manager placed
where the work happens (``train.epoch``, ``train.draw``, ``sample.oracle``,
...).  The recorder is off by default: ``span`` then returns one shared,
pre-built null context and reads no clock, allocates nothing and calls no
``torch`` function.  ``enable(True)`` turns it on; each span then keeps
one record (:class:`SpanRecord`) in a bounded in-memory list: its name,
``time.perf_counter_ns()`` at enter and at exit, the index of the
enclosing span on the same thread, the thread and the step id the caller
last set with :func:`set_step` (the trainer's epoch index).  ``summary()``
gives per name the calls, total and self ns (the total less what its
direct children cover), the reference's manual ``time.time()``
bookkeeping (``train.py:171-172, 277-281``) generalised.

``enable(True, annotate=True)`` also enters
``torch.profiler.record_function(name)`` in each span, so that under a
running profiler the span is a ``user_annotation`` event of the same
Chrome trace as the kernels, on the profiler's clock.  Leave it off when no
profiler runs: it inflates the host times.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import NamedTuple

import torch

CAP = 1_000_000  # records kept; spans past it are counted in ``dropped()``

_on = False  # the one guard of ``span``
_annotate = False
_step = -1
_records: list = []  # [name, start_ns, end_ns, parent, thread, step] a span
_dropped = 0
_lock = threading.Lock()
_open = threading.local()  # ``.stack``: indexes of this thread's open spans
_NULL = contextlib.nullcontext()


class SpanRecord(NamedTuple):
    name: str
    start_ns: int
    end_ns: int  # 0 while the span is open
    parent: int  # index of the enclosing span on the same thread, or -1
    thread: int
    step: int


def force_sync(x) -> float:
    """Wait for the device work behind ``x`` (a tensor, or the first leaf
    of a list, tuple or dict of them): synchronise its CUDA device, then
    read one element to the host.  Returns the element, so callers can
    also check that it is finite."""
    leaf = x
    while isinstance(leaf, (list, tuple, dict)):
        leaf = next(iter(leaf.values())) if isinstance(leaf, dict) else leaf[0]
    if leaf.device.type == "cuda":
        torch.cuda.synchronize(leaf.device)
    return float(leaf.detach().reshape(-1)[0])


class _Span:
    __slots__ = ("name", "rec", "rf")

    def __init__(self, name: str):
        self.name = name
        self.rec = None
        self.rf = None

    def __enter__(self):
        global _dropped
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        parent = stack[-1] if stack else -1
        with _lock:
            if len(_records) < CAP:
                self.rec = [self.name, 0, 0, parent, threading.get_ident(), _step]
                stack.append(len(_records))
                _records.append(self.rec)
            else:
                _dropped += 1
                stack.append(-1)
        if _annotate:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        if self.rec is not None:
            self.rec[1] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.rec is not None:
            self.rec[2] = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _open.stack.pop()
        return False


def span(name: str):
    """A context manager that records the block as the span ``name`` while
    the recorder is on, and does nothing while it is off."""
    if not _on:
        return _NULL
    return _Span(name)


def enable(on: bool, annotate: bool = False):
    """Turn the recorder on or off; with ``annotate``, each span is also a
    ``torch.profiler.record_function`` range."""
    global _on, _annotate
    _on, _annotate = bool(on), bool(on and annotate)


def enabled() -> bool:
    return _on


def annotating() -> bool:
    return _annotate


def set_step(step: int):
    """The step id of the spans that open from now on."""
    global _step
    _step = step


def records() -> list:
    """Every kept span, in the order they opened: [SpanRecord]."""
    with _lock:
        return [SpanRecord(*r) for r in _records]


def dropped() -> int:
    """Spans not kept since the last ``clear()``, the list being full."""
    return _dropped


def clear():
    """Forget every record and the drop count.  Call it between spans, not
    inside one: the open spans' parent indexes refer to the old list."""
    global _dropped
    with _lock:
        _records.clear()
        _dropped = 0


def summary() -> dict:
    """-> {name: {"calls", "total_ns", "self_ns"}} over the closed spans;
    self is the total less the time its direct children cover."""
    recs = records()
    out = {}
    for r in recs:
        if r.end_ns == 0:
            continue
        s = out.setdefault(r.name, {"calls": 0, "total_ns": 0, "self_ns": 0})
        d = r.end_ns - r.start_ns
        s["calls"] += 1
        s["total_ns"] += d
        s["self_ns"] += d
        if r.parent >= 0 and recs[r.parent].end_ns != 0:
            out.setdefault(recs[r.parent].name,
                           {"calls": 0, "total_ns": 0, "self_ns": 0})["self_ns"] -= d
    return out
