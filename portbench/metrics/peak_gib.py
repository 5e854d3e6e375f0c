"""``torch.cuda.max_memory_allocated()`` over the window, after
``reset_peak_memory_stats()`` at its start, in GiB."""


def read(ctx):
    return None if ctx.peak_bytes is None else ctx.peak_bytes / float(1 << 30)
