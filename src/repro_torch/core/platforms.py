"""Platform model of the port (the ``Platform`` record of
``repro.core.platforms``, with an H100 in place of the TPU generations).

Peak and bandwidth figures are public (NVIDIA H100 SXM5 datasheet: 989
TFLOP/s dense bf16, 3.35 TB/s HBM3, NVLink 4 with 18 links at 50 GB/s
each). Latency, on-chip memory, queue depth and the matrix-unit edge are
*model parameters* (approximate, documented), as in the JAX file. The
MoE tile rule reads only ``name``, which keys the routing fingerprint; the
selector reads the rest.
"""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class Platform:
    name: str
    peak_flops_bf16: float   # FLOP/s per chip
    hbm_bw: float            # bytes/s per chip
    hbm_latency_s: float     # seconds, uncontended access latency (model param)
    vmem_bytes: int          # on-chip memory (model param, approx)
    dma_queue_depth: int     # in-flight HBM copies ("MSHR" analogue)
    ici_bw_per_link: float   # bytes/s per chip-to-chip link
    ici_links: int           # links per chip
    mxu_dim: int = 128       # matrix-unit edge: matmul tiles want multiples

    def features(self) -> Dict[str, float]:
        """Hardware features fed to the decision trees (the 'head' axis)."""
        return {
            "hw_peak_tflops": self.peak_flops_bf16 / 1e12,
            "hw_hbm_gbps": self.hbm_bw / 1e9,
            "hw_hbm_latency_ns": self.hbm_latency_s * 1e9,
            "hw_vmem_mb": self.vmem_bytes / 2**20,
            "hw_dma_queue_depth": float(self.dma_queue_depth),
            "hw_ici_gbps": self.ici_bw_per_link * self.ici_links / 1e9,
        }


# vmem_bytes is the 50 MB L2 (the on-chip level every SM shares);
# latency, queue depth and mxu_dim (the 64-row wgmma tile) are model
# parameters.
H100_SXM = Platform(
    name="h100_sxm",
    peak_flops_bf16=989e12,
    hbm_bw=3.35e12,
    hbm_latency_s=600e-9,
    vmem_bytes=50 * 2**20,
    dma_queue_depth=32,
    ici_bw_per_link=50e9,
    ici_links=18,
    mxu_dim=64,
)

# The platforms the port's selector can be fit for, by name (the serve
# CLI's ``--platform``). The JAX package's TPU records are not the port's.
PLATFORMS: Dict[str, Platform] = {p.name: p for p in (H100_SXM,)}
