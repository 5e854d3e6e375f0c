"""Host ms per job of the interpreter's garbage collections in the window
(every generation, timed by a ``gc.callbacks`` entry), summed over the
window and divided by the window's jobs. A circuit compiled per job and
kept in the program's compile cache grows the heap that each full
collection walks."""


def read(ctx):
    clock = getattr(ctx, "gc", None)
    if clock is None or not ctx.jobs:
        return None
    return sum(clock.seconds) * 1e3 / len(ctx.jobs)
