"""Platform model of the port: the ``Platform`` record of
``repro.core.platforms`` with three NVIDIA generations in place of the
TPU ones.

The reference contrasts three machines that differ in memory technology,
cache size and memory-level parallelism (the paper's Table 1 design), so
that the decision trees can tell features every machine ranks
(algorithm-intrinsic) from features only some rank (architecture-induced).
The port keeps that design:

  A100 SXM4  HBM2e, the smallest L2: high bandwidth, little locality capture
  H100 SXM5  HBM3: the most bandwidth and compute (the card the port runs on)
  L40S       GDDR6, the largest L2, no NVLink: the low-latency,
             small-bandwidth part

Peak, bandwidth, cache and link figures are public (sources beside each
record). Latency, queue depth and the matrix-unit edge are *model
parameters* (approximate, documented), as in the JAX file. No record holds
a figure taken on or for a TPU. The MoE tile rule reads only ``name``,
which keys the routing fingerprint; the selector reads the rest.
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


# In every record vmem_bytes is the L2, the on-chip level every SM shares.
# The queue depth scales the H100's 32 by each card's bandwidth x latency
# product (Little's law: the bytes that must be in flight), rounded to a
# multiple of 8.

# NVIDIA A100 datasheet (SXM4 80GB): 312 TFLOP/s dense bf16, 2,039 GB/s
# HBM2e, NVLink 3 at 600 GB/s (12 links x 50 GB/s); the 40 MB L2 is the
# A100 architecture whitepaper's. Model parameters: latency 650 ns (HBM2e,
# a generation before the H100's HBM3), queue depth 24 (2.04 TB/s x 650 ns
# is 0.66 of the H100's product), mxu_dim 16 (Ampere issues mma.sync on
# 16-row tiles).
A100_SXM = Platform(
    name="a100_sxm",
    peak_flops_bf16=312e12,
    hbm_bw=2.039e12,
    hbm_latency_s=650e-9,
    vmem_bytes=40 * 2**20,
    dma_queue_depth=24,
    ici_bw_per_link=50e9,
    ici_links=12,
    mxu_dim=16,
)

# NVIDIA H100 SXM5 datasheet: 989 TFLOP/s dense bf16, 3.35 TB/s HBM3,
# NVLink 4 with 18 links at 50 GB/s each; the 50 MB L2 is the H100
# architecture whitepaper's. Model parameters: latency 600 ns, queue depth
# 32, mxu_dim 64 (Hopper's wgmma wants 64-row tiles).
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

# NVIDIA L40S datasheet: 362.05 TFLOP/s dense bf16 (733 with sparsity),
# 864 GB/s GDDR6, no NVLink: one PCIe Gen4 x16 link at 64 GB/s
# (bidirectional, as the NVLink figures are); the 96 MB L2 is the Ada
# Lovelace architecture whitepaper's (AD102). Model parameters: latency
# 500 ns (GDDR6 on a point-to-point bus, no HBM stack: the paper's
# low-latency DDR role), queue depth 8 (864 GB/s x 500 ns is 0.21 of the
# H100's product), mxu_dim 16 (Ada issues mma.sync on 16-row tiles).
L40S = Platform(
    name="l40s",
    peak_flops_bf16=362.05e12,
    hbm_bw=864e9,
    hbm_latency_s=500e-9,
    vmem_bytes=96 * 2**20,
    dma_queue_depth=8,
    ici_bw_per_link=64e9,
    ici_links=1,
    mxu_dim=16,
)

# The platforms the characterization loop compares and the port's
# selector can be fit for, by name (the CLIs' ``--platform``). The JAX
# package's TPU records are not the port's.
PLATFORMS: Dict[str, Platform] = {p.name: p for p in (A100_SXM, H100_SXM,
                                                      L40S)}

# The card the port runs on: the roofline's rates and every CLI's default.
ROOFLINE_PLATFORM = H100_SXM
