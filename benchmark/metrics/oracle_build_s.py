"""Host seconds of ``cli.train.build_sampler`` in set-up, to the device's
synchronisation: the oracle's cache read or build, and its upload."""


def read(ctx):
    return ctx.oracle_build_s
