"""prepared_gib: the bytes the prepared store holds once the plan is
built (``PreparedStore.telemetry()["bytes_in_use"]``)."""


def read(ctx):
    held = ctx.store.get("bytes_in_use")
    return None if held is None else held / 2 ** 30
