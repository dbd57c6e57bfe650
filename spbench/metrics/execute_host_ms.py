"""execute_host_ms: the time an op spends off the card. The host-clock
time around ``Plan.execute`` (with the loop's synchronise), averaged over
the ops after the traced part of the window, less the device time per op
of the operations that execute launched in the traced part (profiler).
The profiler adds host time to each op it records, and none to a kernel's,
so host time is read where it is off."""


def read(ctx):
    tl, w = ctx.timeline, ctx.window
    rest = w.execute_s[w.traced_ops:]
    if tl is None or not tl.n_execute or not rest:
        return None
    device_s = sum(e.dur for e in tl.execute_events()) * 1e-6 / tl.n_execute
    return (sum(rest) / len(rest) - device_s) * 1e3
