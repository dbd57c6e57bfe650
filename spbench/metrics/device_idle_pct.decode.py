"""device_idle_pct.decode: the share of the traced window in which no
kernel, copy or fill runs on the card, in percent: one less the trace's
busy time over the trace's window, both from the profiler's timeline.

``device_idle_pct.py`` divides the traced ops' busy time by the untraced
ops' wall time, which suits a host-paced op. A decode step keeps the card
busy from end to end, and the profiler lengthens the device time of each
of its launches a little, so that ratio reads above one (an idle
share below zero); here both times come from the same traced steps, and
the profiler's own host time between them counts as idle."""


def read(ctx):
    tl = ctx.timeline
    if tl is None or not tl.n_execute or tl.window_s <= 0:
        return None
    return 100.0 * (1.0 - tl.busy_s() / tl.window_s)
