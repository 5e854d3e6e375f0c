"""``plain_ms`` in the cells that run the monomial pass: device ms per job
of every operation in the window that no other device metric claims,
the monomial pass's launches (``monomial_ms``) left out beside the window
kernel and the row swap. In Shor's order finding that is the 5-qubit dense
passes (the H layer and the inverse QFT's head), the probability pass,
the one-hot fill and the readback."""

from portbench import kernels
from portbench.metrics import monomial_ms


def read(ctx):
    if ctx.trace is None or not ctx.jobs:
        return None
    claimed = kernels.matches(kernels.CLAIMED + (monomial_ms.KERNEL,))
    s = ctx.trace.seconds_where(lambda name: not claimed(name))
    return None if s is None else s * 1e3 / len(ctx.jobs)
