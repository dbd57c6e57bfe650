"""op_p95_ms: the 95th percentile, over every op of the window, of the
time from when the op was due to when its result was synchronised (host
clock)."""
import numpy as np


def read(ctx):
    lat = ctx.window.latencies_s
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat) * 1e3, 95))
