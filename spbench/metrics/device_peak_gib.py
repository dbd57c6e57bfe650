"""device_peak_gib: ``torch.cuda.max_memory_allocated()`` over set-up and
the window, read before the reference runs."""


def read(ctx):
    if ctx.memory_peak_bytes is None:
        return None
    return ctx.memory_peak_bytes / 2 ** 30
