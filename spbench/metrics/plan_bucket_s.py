"""plan_bucket_s: the seconds of the container's pad to bucket edges in
``plan_build_s`` (``prep_ms.bucket``, ``pad_container_to_bucket``)."""
from spbench import counters


def read(ctx):
    return counters.sum_s(ctx, "prep_ms.bucket")
