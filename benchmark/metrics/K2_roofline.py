"""K2's share of its roofline: the frozen bound of its work at the rows it
ran on (``benchmark/workcount.py``) over its device time a launch, every
CUDA kernel attributed to it by ``benchmark/kernels.py`` counted, from
the traced stretch.  Nothing to read where K2 did not run."""

from benchmark import kernels


def read(ctx):
    return kernels.roofline_pct(ctx, "K2")
