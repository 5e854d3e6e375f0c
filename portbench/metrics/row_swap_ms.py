"""Device ms per job of the row-swap kernel's launches
(``row_swap_kernel``)."""

from portbench import kernels


def read(ctx):
    if ctx.trace is None or not ctx.jobs:
        return None
    s = ctx.trace.seconds_where(kernels.matches(kernels.ROW_SWAP))
    return None if s is None else s * 1e3 / len(ctx.jobs)
