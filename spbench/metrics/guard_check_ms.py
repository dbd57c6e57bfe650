"""guard_check_ms: device time per op of what ``Plan.execute`` launches
besides the product's ``bsr_*`` kernels and the staging of its input
(copies and fills): the guard's finiteness check and its verdict's read."""
from spbench.timeline import STAGING_OPS


def read(ctx):
    tl = ctx.timeline
    if tl is None or not tl.n_execute:
        return None
    us = sum(e.dur for e in tl.execute_events()
             if "bsr_" not in e.name and e.launcher not in STAGING_OPS)
    return us * 1e-3 / tl.n_execute
