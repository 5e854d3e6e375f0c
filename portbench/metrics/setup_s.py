"""Seconds from the process's start to the first timed job: import, CUDA
start, the kernels' libraries, compiling a resident circuit, warm-up."""


def read(ctx):
    return ctx.setup_s
