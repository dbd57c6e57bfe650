"""setup_s: process start to the first timed op (host clock): the
selector's fit, input generation, ``plan`` (pick, host prep, store, upload)
and the warm-up, which builds the CUDA kernels in a checkout's first run."""


def read(ctx):
    return ctx.setup_s
