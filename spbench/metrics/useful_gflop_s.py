"""useful_gflop_s: 2 nnz k for every product completed in the window,
over the window's wall time (host clock). nnz is the generated CSR's
count, never the container's."""


def read(ctx):
    w = ctx.window
    if not w.ops or w.wall_s <= 0:
        return None
    flops = 2.0 * ctx.work["nnz"] * ctx.work["k"]
    return w.ops * flops / w.wall_s / 1e9
