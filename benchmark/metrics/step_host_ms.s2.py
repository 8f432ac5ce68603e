"""Host ms a stage-2 epoch spends inside the program's span ``train.epoch``
(the whole epoch: draw, loss, backward, Adam and the loss sums),
inclusive, with the spans on and no profiler (stretch (b) of
``benchmark/span_metrics.py``)."""

from benchmark import span_metrics


def read(ctx):
    return span_metrics.host_ms(ctx, "s2", "train.epoch")
