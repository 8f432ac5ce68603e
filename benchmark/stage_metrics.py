"""The per-layer readings of a training stage's traced run, which each
stage's metric files (``metrics/<metric>.<stage>.py``) read for their own
stage.  Each returns None where the run is of another stage or holds
nothing to read."""

from __future__ import annotations

from benchmark import kernels, workcount


def _of(ctx, stage: str) -> bool:
    return ctx.stage == stage and ctx.steps > 0


def sample_ms(ctx, stage: str):
    """Mean ms of the program's ``TrainingSampler.sample`` called alone."""
    return ctx.sample_ms if _of(ctx, stage) else None


def nonkernel_ms(ctx, stage: str):
    """Device ms a step outside K1-K3b: every kernel, copy and fill of the
    traced stretch that ``kernels.py`` does not attribute to a SIREN
    kernel."""
    if not _of(ctx, stage) or not ctx.device:
        return None
    ours, _ = kernels.per_kernel(ctx.kernels)
    other = sum(e["dur_s"] for e in ctx.device) - sum(r["seconds"] for r in ours.values())
    return 1e3 * other / ctx.steps


def launches_per_step(ctx, stage: str):
    """CUDA kernels of the traced stretch over its steps."""
    return len(ctx.kernels) / ctx.steps if _of(ctx, stage) and ctx.kernels else None


def idle_pct(ctx, stage: str):
    """The share of the traced stretch (host clock, to the device's
    synchronisation) in which no kernel, copy or fill ran."""
    if not _of(ctx, stage) or ctx.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)


def step_mfu(ctx, stage: str):
    """The frozen model FLOPs of a step (``workcount.step_flops``) times the
    traced stretch's steps a second, over 165 TFLOP/s."""
    if not _of(ctx, stage) or ctx.window_s <= 0:
        return None
    flops = workcount.step_flops(stage, ctx.n_on, ctx.n_off, ctx.hidden)
    return 100.0 * flops * ctx.steps / ctx.window_s / workcount.PEAK_FLOPS
