"""Three-term roofline of one step (port of ``repro.roofline.analysis``).

    compute term    = FLOPs / peak FLOP/s
    memory term     = bytes / HBM bandwidth
    collective term = collective_bytes / (link bandwidth x links)

all per chip. The reference reads the FLOPs and bytes of the compiled HLO
(its own parse, cross-checked against XLA's ``cost_analysis()``, which
counts a while loop's body once); the port counts the eager step's aten
operators with ``op_analysis.OpCounter``, which sees every layer, so there
is no second source to reconcile and the report has no
``cost_analysis_*`` fields. The fields keep the reference's names
(``hlo_flops``, ``hlo_bytes``) so that a reader of either report finds the
same numbers under the same keys; here they hold the counted operators'
totals. The platform is the port's ``ROOFLINE_PLATFORM``, the card it runs
on: ``H100_SXM`` (989 TFLOP/s dense bf16, 3.35 TB/s HBM3, NVLink 4 at 18
links x 50 GB/s, taken for every mesh axis as the reference takes one ICI
figure).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from ..core.platforms import ROOFLINE_PLATFORM, Platform
from .op_analysis import OpStats, measure_step

__all__ = ["RooflineReport", "roofline_terms", "measure_step"]


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    n_chips: int
    # per-chip quantities
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float
    collective_breakdown: Dict[str, float]
    # terms (seconds)
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    # usefulness
    model_flops_global: float
    useful_ratio: float           # MODEL_FLOPS / (FLOPs x chips)
    roofline_fraction: float      # t_ideal / t_bound
    memory_per_device_bytes: float

    def row(self) -> str:
        return (f"{self.arch:18s} {self.shape:12s} {self.mesh:9s} "
                f"C={self.t_compute:.3e}s M={self.t_memory:.3e}s "
                f"X={self.t_collective:.3e}s -> {self.bottleneck:10s} "
                f"useful={self.useful_ratio:.2f} "
                f"roofline={self.roofline_fraction:.2f}")


def roofline_terms(*, arch: str, shape: str, mesh_name: str, n_chips: int,
                   stats: OpStats, memory_per_device: float,
                   model_flops_global: float,
                   model_bytes_global: float = 0.0,
                   platform: Platform = ROOFLINE_PLATFORM
                   ) -> RooflineReport:
    flops = stats.flops
    hbm = stats.hbm_bytes
    peak = platform.peak_flops_bf16
    t_c = flops / peak
    t_m = hbm / platform.hbm_bw
    # a chip's egress is spread over its links; standard ring estimate
    t_x = stats.total_collective_bytes / (platform.ici_bw_per_link
                                          * platform.ici_links)
    bottleneck = ("compute" if t_c >= max(t_m, t_x) else
                  "memory" if t_m >= t_x else "collective")
    useful = model_flops_global / max(flops * n_chips, 1.0)
    # The ideal step time is bounded by BOTH the compute floor (useful
    # flops at peak) and the memory floor (minimum necessary bytes at full
    # HBM bandwidth) -- decode steps are legitimately memory-floor-bound.
    t_ideal = max(model_flops_global / (n_chips * peak),
                  model_bytes_global / (n_chips * platform.hbm_bw))
    frac = t_ideal / max(t_c, t_m, t_x, 1e-30)
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, n_chips=n_chips,
        hlo_flops=flops, hlo_bytes=hbm,
        collective_bytes=stats.total_collective_bytes,
        collective_breakdown=dict(stats.collective_bytes),
        t_compute=t_c, t_memory=t_m, t_collective=t_x,
        bottleneck=bottleneck, model_flops_global=model_flops_global,
        useful_ratio=useful, roofline_fraction=frac,
        memory_per_device_bytes=memory_per_device)
