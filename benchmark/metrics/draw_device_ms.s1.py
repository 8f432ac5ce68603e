"""Device ms a stage-1 step of the kernels, copies and fills the host
launched inside the program's span ``train.draw`` (the batch draw and its oracle),
from the profiled stretch (c) of ``benchmark/span_metrics.py``."""

from benchmark import span_metrics


def read(ctx):
    return span_metrics.device_ms(ctx, "s1", "train.draw")
