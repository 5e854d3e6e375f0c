"""Share of its bound at which the window kernel runs: the sum of the
launches' bounds over the sum of their device time, in %. A launch's
bound is one read and one write of both float32 planes of the whole state
at the HBM rate (``roofline.pass_bound_s``): every window of these
circuits reads and writes every strip of the state, and that bound never
exceeds the larger of a window's bytes and operations bounds, so the
share cannot pass 100 %."""

from portbench import kernels, roofline


def read(ctx):
    if ctx.trace is None:
        return None
    launches = [b - a for name, a, b in ctx.trace.device
                if kernels.matches(kernels.WINDOW)(name)]
    if not launches:
        return None
    return 100.0 * len(launches) * roofline.pass_bound_s(ctx.n) / sum(launches)
