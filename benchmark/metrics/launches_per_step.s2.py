"""CUDA kernels launched a stage-2 step: the kernels of the traced stretch
over its steps, a count."""

from benchmark import stage_metrics


def read(ctx):
    return stage_metrics.launches_per_step(ctx, "s2")
