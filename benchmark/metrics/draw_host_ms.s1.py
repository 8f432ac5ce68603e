"""Host ms a stage-1 step spends inside the program's span ``train.draw``
(``Trainer.draw``: the sampler's draws and its oracle), inclusive, with
the spans on and no profiler (stretch (b) of
``benchmark/span_metrics.py``)."""

from benchmark import span_metrics


def read(ctx):
    return span_metrics.host_ms(ctx, "s1", "train.draw")
