"""device_idle_pct: the share of the window in which no kernel, copy or
fill runs on the card, in percent: one less the device's busy time per op
in the traced part (profiler timeline) over the wall time per op after
it. The profiler adds host time to each op it records, and none to the
card's, so the wall time is read where it is off."""


def read(ctx):
    tl, w = ctx.timeline, ctx.window
    rest = w.ops - w.traced_ops
    if tl is None or not tl.n_execute or rest <= 0 or w.untraced_s <= 0:
        return None
    busy_per_op = tl.busy_s() / tl.n_execute
    return 100.0 * (1.0 - busy_per_op * rest / w.untraced_s)
