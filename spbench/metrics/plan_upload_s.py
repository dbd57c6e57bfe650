"""plan_upload_s: the seconds of the container's copy onto the card in
``plan_build_s`` (``prep_ms.upload``, ``SparseTensor.from_layout``)."""
from spbench import counters


def read(ctx):
    return counters.sum_s(ctx, "prep_ms.upload")
