"""plan_build_s: the benchmark's host-clock span around
``plan(op, A, selector=service)``: the selector's pick (fingerprint,
content key, tree), ``SparseTensor.from_csr``'s host prep, the prepared
store and the upload."""


def read(ctx):
    return ctx.plan_build_s
