"""Device ms per job of every operation in the window that no other
device metric claims (``kernels.CLAIMED``: the window kernel and the row
swap): PyTorch's kernels, copies and sets, so the phase product, the
cross pairs of a swap, the one-hot fill, the probability reduction, the
collapse and the readback, and any kernel the port adds until a metric of
its own claims it."""

from portbench import kernels


def read(ctx):
    if ctx.trace is None or not ctx.jobs:
        return None
    claimed = kernels.matches(kernels.CLAIMED)
    s = ctx.trace.seconds_where(lambda name: not claimed(name))
    return None if s is None else s * 1e3 / len(ctx.jobs)
