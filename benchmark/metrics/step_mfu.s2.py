"""The whole stage-2 step's share of the card's peak: the frozen model FLOPs
of a step (``workcount.step_flops``) times the traced stretch's steps a
second, over 165 TFLOP/s."""

from benchmark import stage_metrics


def read(ctx):
    return stage_metrics.step_mfu(ctx, "s2")
