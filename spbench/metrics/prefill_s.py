"""prefill_s: set-up's prefill of every prompt through ``Model.prefill``,
its caches joined into the batch's (host clock, ended by a synchronise)."""


def read(ctx):
    return getattr(ctx, "prefill_s", None)
