"""product_roofline: the least time of the work the product needs
(``spbench.work``: the CSR's bytes and operations, whatever container
holds it) over the device time per op of everything ``Plan.execute``
launched, in percent."""
from spbench import work


def read(ctx):
    tl = ctx.timeline
    if tl is None or not tl.n_execute:
        return None
    device_s = sum(e.dur for e in tl.execute_events()) * 1e-6 / tl.n_execute
    if device_s <= 0:
        return None
    w = ctx.work
    return 100.0 * work.least_seconds(w["n_rows"], w["n_cols"], w["nnz"],
                                      w["k"]) / device_s
