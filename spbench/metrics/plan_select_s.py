"""plan_select_s: the selector's share of ``plan_build_s``: the seconds of
``SelectorService``'s decision (``select_ms``: content key, fingerprint,
cost tree), observed by the program on every decision."""
from spbench import counters


def read(ctx):
    return counters.sum_s(ctx, "select_ms")
