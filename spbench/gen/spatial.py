"""SpChar's "spatial" synthetic category (arXiv 2304.06944, Table 2): every
row holds ``cluster`` contiguous nonzeros at a random start, which gives
optimal spatial locality.

Frozen copy of ``repro_torch.core.synthetic.gen_spatial`` (with its
``_from_row_lengths``) as it stood when this benchmark was written: the
same draws in the same order, so a seed gives the matrix that function
gives. ``params``: ``n_rows`` (square), ``cluster``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def generate(params: Dict, seed: int) -> Dict:
    n = int(params["n_rows"])
    cluster = int(params["cluster"])
    lengths = np.minimum(np.full(n, cluster, dtype=np.int64), n)
    row_ptrs = np.concatenate([[0], np.cumsum(lengths)])
    rng = np.random.default_rng(seed)
    cols = np.empty(int(row_ptrs[-1]), dtype=np.uint32)
    hi = max(n - cluster, 1)
    for i, ln in enumerate(lengths):
        if ln:
            start = int(rng.integers(0, hi))
            cols[row_ptrs[i]:row_ptrs[i + 1]] = np.sort(
                start + np.arange(ln)) % n
    vals = np.random.default_rng(seed + 1).standard_normal(
        cols.size).astype(np.float32)
    return {"row_ptrs": row_ptrs.astype(np.int64), "col_idxs": cols,
            "vals": vals, "shape": (n, n)}
