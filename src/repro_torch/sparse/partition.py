"""nnz-balanced row partitioning: the work-splitting rule of the sharded
path (port of ``repro.sparse.partition``; numpy only, a copy).

SpChar's Eq. 5 imbalance counters already predict when a contiguous
equal-row split starves some shards and drowns others — power-law matrices
concentrate nnz in a hub core, so splitting by *row count* hands shard 0
nearly all the work. The partitioner here splits by *cumulative nnz*
instead (Gale et al.'s balanced 1D row decomposition at shard granularity):
interior boundaries land on the rows whose cumulative nnz is nearest the
ideal per-shard share, then a best-of guard keeps the result never worse
than the equal-row split under the Eq. 5 metric, so the property test
``imbalance(nnz) <= imbalance(rows)`` holds by construction.

Everything host-side numpy: partitioning is prep, and warm sharded plans
skip it through the PreparedStore (``plan_sharded`` caches the
``RowPartition`` plus the sliced shard CSRs under the matrix's content
key).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from ..core.csr import CSR

STRATEGIES = ("nnz", "rows")


def slice_rows(csr: CSR, lo: int, hi: int) -> CSR:
    """Rows ``[lo, hi)`` of ``csr`` as a standalone CSR (columns untouched:
    a row shard multiplies the full replicated RHS)."""
    lo, hi = int(lo), int(hi)
    p0, p1 = int(csr.row_ptrs[lo]), int(csr.row_ptrs[hi])
    return CSR(csr.row_ptrs[lo: hi + 1] - p0, csr.col_idxs[p0:p1],
               csr.nnz_vals[p0:p1], (hi - lo, csr.shape[1]))


def equal_row_bounds(n_rows: int, n_parts: int) -> np.ndarray:
    """Naive contiguous split: equal row counts per shard (the Fig. 1
    thread partitioning the Eq. 5 counters score)."""
    n_parts = min(max(int(n_parts), 1), max(int(n_rows), 1))
    return np.linspace(0, n_rows, n_parts + 1).astype(np.int64)


def bounds_imbalance(row_weights: np.ndarray,
                     bounds: np.ndarray) -> Dict[str, float]:
    """Eq. 5 evaluated on an explicit bound set: per-shard assigned work vs
    the ideal share. ``mean`` is the paper's metric (mean relative
    deviation); ``max`` is the straggler bound — the shard the wall-clock
    waits for."""
    w = np.asarray(row_weights, np.float64)
    bounds = np.asarray(bounds, np.int64)
    n_parts = bounds.size - 1
    total = float(w.sum())
    if total <= 0 or n_parts <= 0:
        return {"mean": 0.0, "max": 0.0}
    ideal = total / n_parts
    csum = np.concatenate([[0.0], np.cumsum(w)])
    assigned = csum[bounds[1:]] - csum[bounds[:-1]]
    dev = np.abs(assigned - ideal) / ideal
    return {"mean": float(dev.mean()), "max": float(dev.max())}


def nnz_balanced_bounds(row_weights: np.ndarray, n_parts: int) -> np.ndarray:
    """Contiguous bounds minimizing nnz imbalance: each interior boundary is
    placed on the row whose cumulative nnz is nearest the ideal k/n_parts
    share (both searchsorted neighbors considered), monotonicity enforced so
    every shard keeps at least one row, and the equal-row split kept instead
    whenever it scores no worse (the never-worse guard the property tests
    pin)."""
    w = np.asarray(row_weights, np.float64)
    n = w.size
    k = min(max(int(n_parts), 1), max(n, 1))
    equal = equal_row_bounds(n, k)
    if k <= 1 or n == 0:
        return equal
    csum = np.concatenate([[0.0], np.cumsum(w)])
    total = csum[-1]
    if total <= 0:
        return equal
    targets = total * np.arange(1, k) / k
    cut = np.searchsorted(csum[1:], targets, side="left") + 1
    lo = np.maximum(cut - 1, 1)
    cut = np.where(np.abs(csum[lo] - targets) < np.abs(csum[cut] - targets),
                   lo, cut)
    bounds = np.concatenate([[0], cut, [n]]).astype(np.int64)
    for i in range(1, k):  # strict monotonicity: >= 1 row per shard
        bounds[i] = min(max(bounds[i], bounds[i - 1] + 1), n - (k - i))
    if bounds_imbalance(w, bounds)["mean"] \
            > bounds_imbalance(w, equal)["mean"]:
        return equal
    return bounds


@dataclasses.dataclass(frozen=True)
class RowPartition:
    """A contiguous row split: ``bounds`` has ``n_parts + 1`` entries,
    shard ``i`` owns rows ``[bounds[i], bounds[i+1])`` — every row in
    exactly one shard by construction."""

    bounds: Tuple[int, ...]
    strategy: str
    shard_nnz: Tuple[int, ...]

    @property
    def n_parts(self) -> int:
        return len(self.bounds) - 1

    @property
    def n_rows(self) -> int:
        return int(self.bounds[-1])

    def shard_rows(self) -> Tuple[int, ...]:
        b = np.asarray(self.bounds)
        return tuple(int(v) for v in (b[1:] - b[:-1]))

    def imbalance(self) -> Dict[str, float]:
        """Eq. 5 over the realized per-shard nnz assignment."""
        nnz = np.asarray(self.shard_nnz, np.float64)
        total = float(nnz.sum())
        if total <= 0:
            return {"mean": 0.0, "max": 0.0}
        ideal = total / self.n_parts
        dev = np.abs(nnz - ideal) / ideal
        return {"mean": float(dev.mean()), "max": float(dev.max())}

    def slice(self, csr: CSR) -> List[CSR]:
        return [slice_rows(csr, self.bounds[i], self.bounds[i + 1])
                for i in range(self.n_parts)]


def partition_rows(csr: CSR, n_parts: int,
                   strategy: str = "nnz") -> RowPartition:
    """Split ``csr``'s rows into ``n_parts`` contiguous shards.

    ``strategy="nnz"`` balances work (cumulative-nnz cuts, never worse than
    equal rows under Eq. 5); ``strategy="rows"`` is the naive equal-row
    split — kept as the measurable before-point of the sharded benchmarks.
    """
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown partition strategy {strategy!r}; "
                         f"one of {STRATEGIES}")
    lengths = csr.row_lengths()
    if strategy == "nnz":
        bounds = nnz_balanced_bounds(lengths, n_parts)
    else:
        bounds = equal_row_bounds(csr.n_rows, n_parts)
    csum = np.concatenate([[0], np.cumsum(lengths)])
    shard_nnz = tuple(int(v) for v in (csum[bounds[1:]] - csum[bounds[:-1]]))
    return RowPartition(tuple(int(b) for b in bounds), strategy, shard_nnz)
