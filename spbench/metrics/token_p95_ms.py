"""token_p95_ms: the 95th percentile, over every decode step of the window,
of the time from when the step was due (the previous step's tokens on the
host) to when its own tokens are on the host: the gap between a session's
tokens (host clock)."""
import numpy as np


def read(ctx):
    lat = ctx.window.latencies_s
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat) * 1e3, 95))
