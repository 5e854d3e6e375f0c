"""Device ms per job of the window kernel's launches (both paths:
``window_stream_kernel``, ``window_sweep_kernel``)."""

from portbench import kernels


def read(ctx):
    if ctx.trace is None or not ctx.jobs:
        return None
    s = ctx.trace.seconds_where(kernels.matches(kernels.WINDOW))
    return None if s is None else s * 1e3 / len(ctx.jobs)
