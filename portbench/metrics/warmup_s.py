"""warmup_s: the host clock around the entry's first call (the eager
warm-up and the graph capture; serving: the first request)."""


def read(ctx):
    return ctx.warmup_s
