"""Seconds from the process's start to the window's: imports, the inputs, the CUDA context, the kernels (built on a checkout's first run) and the cold sample."""


def read(ctx):
    return ctx["setup_s"]
