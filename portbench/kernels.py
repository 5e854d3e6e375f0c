"""Kernel names of the port's hand-written CUDA kernels that have a
per-layer metric of their own, as the profiler names their launches (a
name contains the ``__global__`` function's). Device time that none of
them claims is ``plain_ms``'s."""

WINDOW = ("window_stream_kernel", "window_sweep_kernel")
ROW_SWAP = ("row_swap_kernel",)
#: Every name above: what ``plain_ms`` leaves to the other metrics.
CLAIMED = WINDOW + ROW_SWAP


def matches(names):
    return lambda kernel: any(n in kernel for n in names)
