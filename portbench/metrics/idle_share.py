"""Share of the window in which no operation ran on the device, in %:
1 - (union of device intervals / window), the window from the first timed
job's start to the last one's end."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
