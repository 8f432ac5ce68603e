"""Device profiling: the torch counterpart of
``diffudf_tpu/utils/profiling.py``.  Usage:

    with trace_to("/tmp/dudf-trace"):
        state, losses, _ = trainer.run(state)

then open the ``*.pt.trace.json`` file it writes in Perfetto
(ui.perfetto.dev) or TensorBoard's profiler plugin.  With the spans on
(``utils.timing.enable(True)``) the trace also holds each span as a
``user_annotation`` range over the kernels it launched.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

from . import timing


@contextmanager
def trace_to(log_dir: str):
    """Trace the CPU and, where CUDA is available, the CUDA activity of the
    block with ``torch.profiler``; the Chrome-trace JSON goes to
    ``log_dir`` when the block ends.  Spans that are on annotate the trace
    for the block."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    on, annotate = timing.enabled(), timing.annotating()
    try:
        timing.enable(on, annotate=on)
        with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
            yield
    finally:
        timing.enable(on, annotate=annotate)
