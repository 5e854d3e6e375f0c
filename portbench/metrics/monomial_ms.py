"""Device ms per job of the monomial pass's launches (a name that holds
``monomial_pass_kernel``); None where the trace holds none, as in a
program without the pass."""

KERNEL = "monomial_pass_kernel"


def read(ctx):
    if ctx.trace is None or not ctx.jobs:
        return None
    s = ctx.trace.seconds_where(lambda name: KERNEL in name)
    return None if s is None else s * 1e3 / len(ctx.jobs)
