"""Mean ms of the program's ``TrainingSampler.sample`` called alone on the
cell's sampler, many calls between two CUDA events, in a stage-2 traced run:
the batch draw and its oracle."""

from benchmark import stage_metrics


def read(ctx):
    return stage_metrics.sample_ms(ctx, "s2")
