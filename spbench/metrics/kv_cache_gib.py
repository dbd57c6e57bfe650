"""kv_cache_gib: the bytes of the cache tensors the program holds for the
served batch (every layer's keys and values, all slots), read from the
cache the program returns."""


def read(ctx):
    held = getattr(ctx, "kv_cache_bytes", None)
    return None if held is None else held / 2 ** 30
