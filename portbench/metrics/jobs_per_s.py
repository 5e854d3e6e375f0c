"""Jobs answered in the window per second of the window (host clock)."""


def read(ctx):
    return len(ctx.jobs) / ctx.window_s if ctx.jobs and ctx.window_s > 0 else None
