"""Host ms a stage-2 step spends inside the program's span ``train.loss``
(the loss terms and their row), inclusive, with the spans on and no
profiler (stretch (b) of ``benchmark/span_metrics.py``)."""

from benchmark import span_metrics


def read(ctx):
    return span_metrics.host_ms(ctx, "s2", "train.loss")
