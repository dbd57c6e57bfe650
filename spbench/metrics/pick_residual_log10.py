"""pick_residual_log10: the median over the traced window's ``launch``
spans of log10(measured_ms / modeled_ms), the selector's modeled time of
its pick against the execute's measured one."""
import math
import statistics


def read(ctx):
    ratios = [math.log10(a["measured_ms"] / a["modeled_ms"])
              for e in ctx.spans or () if e["type"] == "launch"
              for a in (e["args"],)
              if a.get("modeled_ms") and a.get("measured_ms")]
    return statistics.median(ratios) if ratios else None
