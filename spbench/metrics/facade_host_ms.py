"""facade_host_ms: the host's time in ``Plan.execute`` while it is not
blocked on the card, per op: the median of the program's
``launch_host_ms.<op>`` over the window's untraced ops (the last ``ops -
traced_ops`` observations; the profiler adds host time to the ops it
records). It leaves out the guard's ``wait`` for its verdict and the
stream ``sync``; where the wait is above 0, the guard's check was enqueued
while the product ran."""
import statistics

from spbench import counters

PREFIX, COUNT = "launch_host_ms.", ".count"


def read(ctx):
    reg = counters.registry(ctx)
    w = ctx.window
    rest = w.ops - w.traced_ops
    if reg is None or rest <= 0:
        return None
    names = [k[:-len(COUNT)] for k in reg.snapshot()
             if k.startswith(PREFIX) and k.endswith(COUNT)]
    if len(names) != 1:        # a cell executes one op
        return None
    recent = getattr(reg.histogram(names[0]), "recent", None)
    samples = recent(rest) if recent is not None else []
    return statistics.median(samples) if samples else None
