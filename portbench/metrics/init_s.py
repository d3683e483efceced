"""init_s: the host clock around the program's set-up of the data (the
engine's ``init``; serving: the seen set), ending in a device sync."""


def read(ctx):
    return ctx.init_s
