"""Host seconds of the program's span ``data.oracle`` in set-up: the
sampler's construction in ``cli.train.build_sampler``, the oracle's cache
read or build and its upload, recorded with the spans on around
``prepare``."""

from benchmark import span_metrics


def read(ctx):
    return span_metrics.oracle_load_s(ctx)
