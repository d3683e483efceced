"""serve_users_per_s: the users whose top-n list came back in the window,
over its seconds."""


def read(ctx):
    return ctx.units / ctx.window_s
