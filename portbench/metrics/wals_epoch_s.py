"""wals_epoch_s: the window's seconds over the WALS epochs it completed;
the window ends at the end of the last completed call."""


def read(ctx):
    return ctx.window_s / ctx.units
