"""Device ms a stage-2 step of the kernels, copies and fills the host
launched inside the program's span ``train.backward`` (autograd's backward),
from the profiled stretch (c) of ``benchmark/span_metrics.py``."""

from benchmark import span_metrics


def read(ctx):
    return span_metrics.device_ms(ctx, "s2", "train.backward")
