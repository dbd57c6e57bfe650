"""Power-law graphs: the corpus's ``social_networks`` domain, a SNAP-like
social graph (SpChar §IV takes its social graphs from SuiteSparse's SNAP
group).

Frozen copy of ``repro_torch.core.dataset._power_law(clustered=False)``
with its ``_coo_to_csr`` and ``CSR.from_coo`` (duplicates summed) as they
stood when this benchmark was written: Pareto degrees of shape
``alpha - 1``, scaled to ``mean_deg / 2`` and clipped at ``n // 2``,
sorted hubs first; uniform columns; standard normal values.

One change of seeding: the degrees are drawn from ``structure_seed``, the
configuration's, and the columns and values from the run's seed. Every
seed then has the same rows of the same lengths (a Pareto sum of this
shape swings by far more between seeds than two runs of one seed do),
and only where the nonzeros fall and their values change. With
``structure_seed`` 500200 the degrees are those of the serving engine's
tenant ``t2:social_networks_0``
(``tenant_population(8, 16384, 65536, seed=500)``).
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def generate(params: Dict, seed: int) -> Dict:
    n = int(params["n_rows"])
    alpha = float(params["alpha"])
    mean_deg = int(params["mean_deg"])
    deg_rng = np.random.default_rng(int(params["structure_seed"]))
    deg = np.minimum((deg_rng.pareto(alpha - 1, n) + 1) * mean_deg / 2,
                     n // 2).astype(np.int64)
    deg = np.sort(deg)[::-1]
    rows = np.repeat(np.arange(n), deg)
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, n, rows.size)
    vals = rng.standard_normal(rows.size).astype(np.float32)
    # CSR.from_coo: sort by (row, col), sum duplicates
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    if rows.size:
        dup = (rows[1:] == rows[:-1]) & (cols[1:] == cols[:-1])
        if dup.any():
            group = np.concatenate([[0], np.cumsum(~dup)])
            vals = np.bincount(group, weights=vals).astype(np.float32)
            keep = np.concatenate([[True], ~dup])
            rows, cols = rows[keep], cols[keep]
    row_ptrs = np.zeros(n + 1, dtype=np.int64)
    np.add.at(row_ptrs, rows + 1, 1)
    row_ptrs = np.cumsum(row_ptrs)
    return {"row_ptrs": row_ptrs, "col_idxs": cols.astype(np.uint32),
            "vals": vals, "shape": (n, n)}
