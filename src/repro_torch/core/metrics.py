"""The Eq. 5 partition-imbalance metric (copy of
``repro.core.metrics.partition_imbalance``). The rest of the SpChar metric
suite comes with the selector."""
from __future__ import annotations

import numpy as np


def partition_imbalance(item_weights: np.ndarray, n_parts: int) -> float:
    """Eq. (5) generalized to any weighted-item contiguous partition."""
    item_weights = np.asarray(item_weights, dtype=np.float64)
    total = item_weights.sum()
    if total == 0 or n_parts <= 0:
        return 0.0
    ideal = total / n_parts
    bounds = np.linspace(0, item_weights.size, n_parts + 1).astype(np.int64)
    csum = np.concatenate([[0.0], np.cumsum(item_weights)])
    assigned = csum[bounds[1:]] - csum[bounds[:-1]]
    return float(np.mean(np.abs(assigned - ideal) / ideal))
