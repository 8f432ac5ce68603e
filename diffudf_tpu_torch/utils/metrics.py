"""Scalar metrics logging: CSV always, TensorBoard when available.  A copy
of ``diffudf_tpu/utils/metrics.py``; ``losses.csv`` has the same format.

First-class replacement for the reference's ad-hoc SummaryWriter calls +
pandas dump (``train.py:33-36,224,233,394-395``).  The training loop
produces whole *chunks* of per-epoch scalars at once (the trainer reads its
per-epoch scalars once per chunk), so the logger ingests arrays, not single points.
"""

from __future__ import annotations

import csv
import os


class ScalarLogger:
    """Collects named per-step scalar series; flushes CSV and TensorBoard."""

    def __init__(self, log_dir: str, tensorboard: bool = True):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._series: dict = {}
        self._writer = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                summary_path = os.path.join(log_dir, "summaries")
                os.makedirs(summary_path, exist_ok=True)
                self._writer = SummaryWriter(summary_path)
            except ImportError:
                # TensorBoard needs the tensorboard package; CSV logging
                # keeps working
                import warnings

                warnings.warn(
                    "TensorBoard logging requested but unavailable; "
                    "falling back to CSV only.",
                    RuntimeWarning,
                    stacklevel=2,
                )
                self._writer = None

    def log_array(self, name: str, start_step: int, values):
        """Record values for steps [start_step, start_step + len(values))."""
        import numpy as np

        values = np.asarray(values, dtype=float)
        store = self._series.setdefault(name, {})
        for i, v in enumerate(values):
            store[start_step + i] = float(v)
        if self._writer is not None:
            for i, v in enumerate(values):
                self._writer.add_scalar(name, float(v), start_step + i)

    def log(self, name: str, step: int, value: float):
        self.log_array(name, step, [value])

    def flush_csv(self, filename: str = "losses.csv", sep: str = ";",
                  exclude=()):
        """Reference-compatible losses.csv (one column per series)."""
        names = [n for n in sorted(self._series) if n not in exclude]
        if not names:
            return
        steps = sorted({s for n in names for s in self._series[n]})
        path = os.path.join(self.log_dir, filename)
        with open(path, "w", newline="") as fh:
            w = csv.writer(fh, delimiter=sep)
            w.writerow(names)
            for s in steps:
                w.writerow([self._series[n].get(s, "") for n in names])
        return path

    def close(self):
        if self._writer is not None:
            self._writer.flush()
            self._writer.close()
