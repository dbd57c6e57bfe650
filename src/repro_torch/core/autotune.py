"""The schedule record of the plan path (copy of ``repro.core.autotune``
lines 29-56) and the MoE tile rule ``select_moe_block_size``. The
tree-driven ``ScheduleTuner`` that picks a ``Schedule`` is ported with the
selector, in a later slice; until then a plan names its schedule
explicitly or takes the planner's default."""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from .metrics import partition_imbalance
from .platforms import Platform

BLOCK_SIZES = (32, 64, 128, 256)
SELL_SIGMA = 64                 # sorting window (block-rows); fixed, not swept


@dataclasses.dataclass(frozen=True)
class Schedule:
    backend: str          # "dense" | "bsr"
    block_size: int
    ell_quantile: float
    layout: str = "ell"   # "ell" (global padding) | "sell" (sliced)
    slice_height: int = 0  # SELL C; 0 = n/a for the global-ELL layout
    n_rhs: int = 1        # RHS tile width (1 = SpMV, >1 = the SpMM path)

    def as_features(self) -> List[float]:
        return [float(self.block_size), float(self.ell_quantile),
                float(self.slice_height), float(self.n_rhs)]


def select_moe_block_size(tokens_per_expert: np.ndarray, d_model: int,
                          platform: Platform) -> int:
    """MoE grouped-GEMM tile choice from the imbalance metric (Eq. 5 reuse;
    copy of ``repro.core.autotune.select_moe_block_size``).

    High expert imbalance -> smaller tiles waste less on ragged group tails;
    balanced routing -> full tiles. This mirrors the paper's finding that
    imbalance is the limiting factor for partitioned sparse work.
    """
    imb = partition_imbalance(tokens_per_expert.astype(np.float64),
                              max(len(tokens_per_expert), 1))
    if imb > 1.0:
        return 64
    if imb > 0.5:
        return 128
    return 256
