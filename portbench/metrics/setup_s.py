"""setup_s: process start until the measured window opens: imports, the
kernels from the build cache (or their build), the data, the program's set-up
and the first calls."""


def read(ctx):
    return ctx.setup_s
