"""The program's own counters, read from its process registry
(``repro_torch.obs.default_registry()``) after the window, where the work
happened: the plan build's phases and ``Plan.execute``'s host time.

They are read from a run on the card only (one that read
``memory_peak_bytes``): on the CPU the upload is no copy and the product
runs inside the host's time, so there is nothing of the deployment to
read. A program that has no such counter reads as nothing."""


def registry(ctx):
    """The program's registry, or None off the card."""
    if ctx.memory_peak_bytes is None:
        return None
    from repro_torch.obs import default_registry
    return default_registry()


def sum_s(ctx, name: str):
    """Seconds observed in the histogram ``name`` (ms), or None."""
    reg = registry(ctx)
    h = None if reg is None else reg.histogram(name)
    if h is None or not h.count:
        return None
    return h.sum / 1e3
