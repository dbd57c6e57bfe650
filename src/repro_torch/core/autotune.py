"""The schedule record of the plan path (copy of ``repro.core.autotune``
lines 29-56). The tree-driven ``ScheduleTuner`` that picks a ``Schedule``
is ported with the selector, in a later slice; until then a plan names its
schedule explicitly or takes the planner's default."""
from __future__ import annotations

import dataclasses
from typing import List

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
