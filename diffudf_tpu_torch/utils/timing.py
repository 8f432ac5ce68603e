"""Phase wall-clock accounting: the torch copy of
``diffudf_tpu/utils/timing.py``.

Generalises the reference's manual ``time.time()`` bookkeeping that
subtracts reconstruction time from training time (``train.py:171-172,
277-281``): named phases, re-entrant, reported as a dict.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

import torch


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


class PhaseTimer:
    def __init__(self):
        self.totals: dict = {}
        self.counts: dict = {}

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> dict:
        return {
            name: {"seconds": self.totals[name], "calls": self.counts[name]}
            for name in self.totals
        }

    def __str__(self):
        return " | ".join(
            f"{k}: {v:.2f}s/{self.counts[k]}" for k, v in self.totals.items()
        )
