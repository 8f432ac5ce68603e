"""Host ms a stage-1 step spends inside the program's span ``train.adam``
(``adam_update``), inclusive, with the spans on and no profiler
(stretch (b) of ``benchmark/span_metrics.py``)."""

from benchmark import span_metrics


def read(ctx):
    return span_metrics.host_ms(ctx, "s1", "train.adam")
