"""bpr_updates_per_s: the real triplet updates (positives times negatives)
of the window's completed epochs over its seconds."""


def read(ctx):
    return ctx.units / ctx.window_s
