"""Roofline execution-time model: schedule counters x platform -> targets.

The port's own copy of ``repro.core.perfmodel`` (numpy only): the
same model, so a tree fit in either package on the same platform record
picks the same schedules.

Plays the role of the paper's measured GFLOPS / bandwidth / throughput
(§4.1's three prediction targets). Time is the max of three overlappable
streams plus a serial irregularity term:

  t_compute  = executed_flops / peak            (MXU, includes padding waste)
  t_memory   = hbm_bytes / hbm_bw               (streaming traffic)
  t_latency  = vmem_misses * hbm_latency / Q    (gather misses; Q = DMA queue
                                                 depth, the MSHR analogue --
                                                 deeper queue hides latency)
  t_irregular = grid-step launch overhead inflated by work imbalance
                (the pipeline-flush analogue: ragged rows serialize grid
                 cells that regular rows would overlap perfectly)

  time = max(t_compute, t_memory, t_latency) + t_irregular

The model is deliberately mechanistic: every term is driven by counters
simulated from the real matrix (counters.py), never by the summary metrics
the decision trees consume — so tree MAPE (Fig. 5) is a genuine
generalization measurement, not an identity fit.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from .csr import CSR
from .counters import (sell_spmv_counters, spadd_counters, spgemm_counters,
                       spmv_counters)
from .platforms import Platform

GRID_STEP_OVERHEAD_S = 1.5e-6   # per-grid-cell issue overhead (model param)
F32_PEAK_FRACTION = 0.5         # fp32 MXU throughput relative to bf16 peak


def _mxu_efficiency(block_size: int, mxu_dim: int) -> float:
    """Tiles smaller than the systolic array waste lanes quadratically."""
    r = min(block_size / mxu_dim, 1.0)
    return r * r


def execution_time(counters: Dict[str, float], platform: Platform,
                   block_size: int = 128, matvec: bool = False,
                   n_rhs: int = 1) -> Dict[str, float]:
    peak = platform.peak_flops_bf16 * F32_PEAK_FRACTION * _mxu_efficiency(
        block_size, platform.mxu_dim)
    if matvec:
        # SpMV tiles are (bs x bs) @ (bs, n_rhs) -> narrow-RHS MXU occupancy
        # penalty; a multi-RHS tile (SpMM) amortizes it away by n_rhs=8.
        peak = peak / (8.0 / min(max(int(n_rhs), 1), 8))
    t_compute = counters["executed_flops"] / max(peak, 1.0)
    t_memory = counters["hbm_bytes"] / platform.hbm_bw
    t_latency = (counters["vmem_misses"] * platform.hbm_latency_s
                 / platform.dma_queue_depth)
    n_cells = counters["executed_blocks"]
    t_irregular = (GRID_STEP_OVERHEAD_S * np.sqrt(max(n_cells, 1.0))
                   * (1.0 + counters["grid_imbalance"]))
    total = max(t_compute, t_memory, t_latency) + t_irregular
    return {
        "t_compute": t_compute,
        "t_memory": t_memory,
        "t_latency": t_latency,
        "t_irregular": t_irregular,
        "t_total": total,
        "bound": ("compute" if t_compute >= max(t_memory, t_latency) else
                  "memory" if t_memory >= t_latency else "latency"),
    }


def targets(counters: Dict[str, float], times: Dict[str, float]) -> Dict[str, float]:
    """The paper's three prediction targets (§4.1)."""
    t = times["t_total"]
    return {
        "gflops": counters["useful_flops"] / t / 1e9,
        "bandwidth_gbps": counters["hbm_bytes"] / t / 1e9,
        "throughput_miters": counters["useful_flops"] / 2.0 / t / 1e6,  # inner-loop iters/s
    }


def stall_breakdown(times: Dict[str, float]) -> Dict[str, float]:
    """Frontend/backend stall analogue (Fig. 7/8/11/14/16).

    'Frontend' (issue-side) stalls on a TPU schedule are the irregularity /
    launch bubbles; 'backend' stalls are memory/latency wait. Expressed as
    fractions of total time, mirroring the paper's %-of-cycles plots.
    """
    t = times["t_total"]
    backend = max(times["t_memory"], times["t_latency"])
    useful = times["t_compute"]
    frontend = times["t_irregular"]
    denom = max(t, 1e-30)
    return {
        "frontend_stall_frac": min(frontend / denom, 1.0),
        "backend_stall_frac": min(max(backend - useful, 0.0) / denom, 1.0),
    }


# ---------------------------------------------------------------------------
# Per-kernel entry points
# ---------------------------------------------------------------------------

def run_spmv_model(csr: CSR, platform: Platform, block_size: int = 128,
                   ell_quantile: float = 1.0, n_rhs: int = 1
                   ) -> Tuple[Dict, Dict, Dict]:
    c = spmv_counters(csr, platform, block_size, ell_quantile, n_rhs=n_rhs)
    t = execution_time(c, platform, block_size, matvec=True, n_rhs=n_rhs)
    return c, t, targets(c, t)


def run_spmv_sell_model(csr: CSR, platform: Platform, block_size: int = 128,
                        slice_height: int = 8, sigma: int = 64,
                        n_rhs: int = 1) -> Tuple[Dict, Dict, Dict]:
    """SELL-C-sigma bucketed SpMV, or SpMM when ``n_rhs > 1``."""
    c = sell_spmv_counters(csr, platform, block_size, slice_height, sigma,
                           n_rhs)
    t = execution_time(c, platform, block_size, matvec=True, n_rhs=n_rhs)
    return c, t, targets(c, t)


def run_spgemm_model(a: CSR, b: CSR, platform: Platform, block_size: int = 128
                     ) -> Tuple[Dict, Dict, Dict]:
    c = spgemm_counters(a, b, platform, block_size)
    t = execution_time(c, platform, block_size, matvec=False)
    return c, t, targets(c, t)


def run_spadd_model(a: CSR, b: CSR, platform: Platform, block_size: int = 128
                    ) -> Tuple[Dict, Dict, Dict]:
    c = spadd_counters(a, b, platform, block_size)
    t = execution_time(c, platform, block_size, matvec=False)
    # SpADD is elementwise (VPU): no MXU, compute at vector-unit rate.
    t["t_compute"] = c["executed_flops"] / (platform.peak_flops_bf16 / 16.0)
    t["t_total"] = max(t["t_compute"], t["t_memory"], t["t_latency"]) + t["t_irregular"]
    return c, t, targets(c, t)


KERNELS = ("spmv", "spgemm", "spadd")
