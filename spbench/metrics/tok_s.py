"""tok_s: the tokens a served batch generated in the window (the batch times
its decode steps) over the window's wall time (host clock)."""


def read(ctx):
    w = ctx.window
    if not w.ops or w.wall_s <= 0:
        return None
    return ctx.batch * w.ops / w.wall_s
