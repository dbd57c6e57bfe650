"""plan_container_s: the seconds of the host container's build in
``plan_build_s`` (``prep_ms.container``: the BSR index and the ELL/SELL
fill, ``SparseTensor.build_container``)."""
from spbench import counters


def read(ctx):
    return counters.sum_s(ctx, "prep_ms.container")
