"""The share of the traced stage-2 stretch (host clock, to the device's
synchronisation) in which no kernel, copy or fill ran on the device."""

from benchmark import stage_metrics


def read(ctx):
    return stage_metrics.idle_pct(ctx, "s2")
