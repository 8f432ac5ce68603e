"""Device profiling: the torch counterpart of
``diffudf_tpu/utils/profiling.py``.  Usage:

    with trace_to("/tmp/dudf-trace"):
        state, losses, _ = trainer.run(state)

then open the ``*.pt.trace.json`` file it writes in Perfetto
(ui.perfetto.dev) or TensorBoard's profiler plugin.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch


@contextmanager
def trace_to(log_dir: str):
    """Trace the CPU and, where CUDA is available, the CUDA activity of the
    block with ``torch.profiler``; the Chrome-trace JSON goes to
    ``log_dir`` when the block ends."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
