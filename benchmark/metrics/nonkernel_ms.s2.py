"""Device ms a stage-2 step spends outside K1-K3b: every kernel, copy and
fill of the traced stretch that ``benchmark/kernels.py`` does not attribute
to a SIREN kernel (sampler and oracle, the value path, loss glue, autograd,
Adam)."""

from benchmark import stage_metrics


def read(ctx):
    return stage_metrics.nonkernel_ms(ctx, "s2")
