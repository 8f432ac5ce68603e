"""The stage-2 value path's useful share: 100 times the on-surface rows the
trainer drew (``train.loop.surface_rows``) over the rows
``autodiff.ops.value`` evaluated (``value_rows``), over stretch (b) of
``benchmark/span_metrics.py``."""

from benchmark import span_metrics


def read(ctx):
    return span_metrics.value_rows_read_pct(ctx, "s2")
