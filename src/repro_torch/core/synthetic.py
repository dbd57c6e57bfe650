"""Synthetic matrix generators (paper §3.3, Table 2).

Nine categories, each stressing one architectural feature. The paper fixes
rows = cols = 16M to defeat LLC caching; generators here take ``n`` as a
parameter (benchmarks pick sizes appropriate for this container) while
preserving each category's *structure*, which is what the metrics see.

Row-length distributions for Uniform/Exponential/Normal follow the paper:
uniform sampling of the inverse CDF (evenly spaced quantiles), which yields
sorted lengths — exactly why those categories show HIGH thread imbalance
under contiguous row partitioning (Fig. 4).
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np

from .csr import CSR

CACHE_LINE_ELEMS = 16  # cache_line_size / 4B, paper §3.3 stride pattern


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def _from_row_lengths(
    lengths: np.ndarray, n_cols: int, col_fn: Callable[[int, int, np.random.Generator], np.ndarray],
    seed: int,
) -> CSR:
    rng = _rng(seed)
    lengths = np.minimum(np.asarray(lengths, dtype=np.int64), n_cols)
    row_ptrs = np.concatenate([[0], np.cumsum(lengths)])
    cols = np.empty(int(row_ptrs[-1]), dtype=np.uint32)
    for i, ln in enumerate(lengths):
        if ln:
            cols[row_ptrs[i] : row_ptrs[i + 1]] = np.sort(col_fn(i, int(ln), rng)) % n_cols
    vals = _rng(seed + 1).standard_normal(cols.size).astype(np.float32)
    return CSR(row_ptrs, cols, vals, (lengths.size, n_cols))


def _random_cols(_: int, ln: int, rng: np.random.Generator, n_cols: int) -> np.ndarray:
    return rng.choice(n_cols, size=ln, replace=False) if ln <= n_cols // 2 else (
        np.sort(rng.permutation(n_cols)[:ln])
    )


# --------------------------------------------------------------------------
# The 9 categories (Table 2)
# --------------------------------------------------------------------------

def gen_row(n: int, seed: int = 0, **_) -> CSR:
    """Single dense row: optimal spatial locality, maximal imbalance."""
    lengths = np.zeros(n, dtype=np.int64)
    lengths[n // 2] = n
    return _from_row_lengths(lengths, n, lambda i, ln, r: np.arange(ln), seed)


def gen_column(n: int, seed: int = 0, **_) -> CSR:
    """Single dense column: optimal temporal locality, trivial branches."""
    lengths = np.ones(n, dtype=np.int64)
    c = n // 2
    return _from_row_lengths(lengths, n, lambda i, ln, r: np.full(ln, c), seed)


def gen_cyclic(n: int, seed: int = 0, nnz_per_row: int = 10, **_) -> CSR:
    """Cyclic nonzeros-per-row pattern: controlled branch-entropy stress."""
    pattern = np.array([1, 1, nnz_per_row, 1, 1, 2 * nnz_per_row, 1, 2], dtype=np.int64)
    lengths = np.tile(pattern, -(-n // pattern.size))[:n]
    return _from_row_lengths(
        lengths, n, lambda i, ln, r: _random_cols(i, ln, r, n), seed
    )


def gen_stride(n: int, seed: int = 0, nnz_per_row: int = 10, **_) -> CSR:
    """Elements at cache_line/4B intervals: prefetcher stress."""
    lengths = np.full(n, nnz_per_row, dtype=np.int64)

    def cols(i: int, ln: int, r: np.random.Generator) -> np.ndarray:
        start = (i * 7) % max(n - ln * CACHE_LINE_ELEMS, 1)
        return start + np.arange(ln) * CACHE_LINE_ELEMS

    return _from_row_lengths(lengths, n, cols, seed)


def gen_temporal(n: int, seed: int = 0, nnz_per_row: int = 10, **_) -> CSR:
    """Nonzeros always in the same columns: optimal temporal locality."""
    rng = _rng(seed + 7)
    fixed = np.sort(rng.choice(n, size=nnz_per_row, replace=False))
    lengths = np.full(n, nnz_per_row, dtype=np.int64)
    return _from_row_lengths(lengths, n, lambda i, ln, r: fixed[:ln], seed)


def gen_spatial(n: int, seed: int = 0, cluster: int = 10, **_) -> CSR:
    """Clusters of ``cluster`` contiguous elements: optimal spatial locality."""
    lengths = np.full(n, cluster, dtype=np.int64)

    def cols(i: int, ln: int, r: np.random.Generator) -> np.ndarray:
        start = int(r.integers(0, max(n - ln, 1)))
        return start + np.arange(ln)

    return _from_row_lengths(lengths, n, cols, seed)


def _inverse_cdf_lengths(n: int, icdf: Callable[[np.ndarray], np.ndarray]) -> np.ndarray:
    """Paper §3.3: nnz-per-row via uniform sampling of the inverse CDF.

    Evenly spaced quantiles → deterministic, *sorted* lengths, which is what
    makes Exponential/Normal exhibit HIGH contiguous-partition imbalance.
    """
    q = (np.arange(n) + 0.5) / n
    return np.maximum(np.round(icdf(q)), 0).astype(np.int64)


def gen_uniform(n: int, seed: int = 0, nnz_per_row: int = 10, **_) -> CSR:
    lengths = _inverse_cdf_lengths(n, lambda q: q * 2 * nnz_per_row)
    return _from_row_lengths(lengths, n, lambda i, ln, r: _random_cols(i, ln, r, n), seed)


def gen_exponential(n: int, seed: int = 0, nnz_per_row: int = 10, **_) -> CSR:
    lengths = _inverse_cdf_lengths(n, lambda q: -nnz_per_row * np.log1p(-q * (1 - 1e-9)))
    return _from_row_lengths(lengths, n, lambda i, ln, r: _random_cols(i, ln, r, n), seed)


def gen_normal(n: int, seed: int = 0, nnz_per_row: int = 10, **_) -> CSR:
    from math import sqrt

    def icdf(q: np.ndarray) -> np.ndarray:
        # Acklam-style rational approximation of the normal quantile.
        return nnz_per_row + 0.8 * nnz_per_row * _norm_ppf(q)

    lengths = _inverse_cdf_lengths(n, icdf)
    return _from_row_lengths(lengths, n, lambda i, ln, r: _random_cols(i, ln, r, n), seed)


def _norm_ppf(q: np.ndarray) -> np.ndarray:
    """Rational approximation to the standard normal inverse CDF."""
    q = np.clip(q, 1e-12, 1 - 1e-12)
    # Beasley-Springer-Moro
    a = [-3.969683028665376e01, 2.209460984245205e02, -2.759285104469687e02,
         1.383577518672690e02, -3.066479806614716e01, 2.506628277459239e00]
    b = [-5.447609879822406e01, 1.615858368580409e02, -1.556989798598866e02,
         6.680131188771972e01, -1.328068155288572e01]
    c = [-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e00,
         -2.549732539343734e00, 4.374664141464968e00, 2.938163982698783e00]
    d = [7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e00,
         3.754408661907416e00]
    plow, phigh = 0.02425, 1 - 0.02425
    out = np.empty_like(q)
    lo = q < plow
    hi = q > phigh
    mid = ~(lo | hi)
    if lo.any():
        u = np.sqrt(-2 * np.log(q[lo]))
        out[lo] = (((((c[0] * u + c[1]) * u + c[2]) * u + c[3]) * u + c[4]) * u + c[5]) / (
            (((d[0] * u + d[1]) * u + d[2]) * u + d[3]) * u + 1
        )
    if hi.any():
        u = np.sqrt(-2 * np.log(1 - q[hi]))
        out[hi] = -(((((c[0] * u + c[1]) * u + c[2]) * u + c[3]) * u + c[4]) * u + c[5]) / (
            (((d[0] * u + d[1]) * u + d[2]) * u + d[3]) * u + 1
        )
    if mid.any():
        u = q[mid] - 0.5
        t = u * u
        out[mid] = (((((a[0] * t + a[1]) * t + a[2]) * t + a[3]) * t + a[4]) * t + a[5]) * u / (
            ((((b[0] * t + b[1]) * t + b[2]) * t + b[3]) * t + b[4]) * t + 1
        )
    return out


def gen_zipf(n: int, seed: int = 0, a: float = 1.09, core_frac: float = 0.44,
             **_) -> CSR:
    """Zipf/power-law row lengths (degree-sorted adjacency, e.g. a web graph
    reordered by descending degree with compacted neighbor IDs).

    Row ``i`` (descending rank) follows a saturated Zipf law
    ``L_i = min(n, c * (i + 1) ** (-1 / (a - 1)))`` with the scale ``c``
    chosen so a ``core_frac`` fraction of rows saturates at full width (the
    dense hub core) before the Pareto tail (exponent ``1/(a-1)``) takes
    over; columns are the compacted prefix ``0..L_i-1``. This is the
    category that breaks global ELL: the hub core sets ``max_blocks`` for
    every block-row while the tail block-rows hold ~1 block each, which is
    exactly the padding SELL-C-sigma slicing removes (DESIGN.md §2.3). The
    profile is scale-free: the same relative core/tail shape at any ``n``.

    Not part of ``GENERATORS``/Table 2 — the paper's nine categories stay
    as-is; this is the stress input for the sliced layout.
    """
    s = 1.0 / max(a - 1.0, 1e-6)
    rank = np.arange(n, dtype=np.float64) + 1.0
    lengths = n * (max(core_frac * n, 1.0) / rank) ** s
    lengths = np.clip(lengths, 1, n).astype(np.int64)
    return _from_row_lengths(lengths, n, lambda i, ln, r: np.arange(ln), seed)


GENERATORS: Dict[str, Callable[..., CSR]] = {
    "row": gen_row,
    "column": gen_column,
    "cyclic": gen_cyclic,
    "stride": gen_stride,
    "temporal": gen_temporal,
    "spatial": gen_spatial,
    "uniform": gen_uniform,
    "exponential": gen_exponential,
    "normal": gen_normal,
}

# Table 2 ground truth (LOW < Q1, AVERAGE in [Q1, Q3], HIGH > Q3, relative
# across the 9 categories). Used by tests/benchmarks to validate generators.
TABLE2 = {
    #            temporal  spatial  imbalance  entropy
    "row":         ("LOW",  "HIGH",  "HIGH",   "LOW"),
    "column":      ("HIGH", "HIGH",  "LOW",    "LOW"),
    "cyclic":      ("LOW",  "LOW",   "LOW",    "AVERAGE"),
    "stride":      ("LOW",  "HIGH",  "LOW",    "LOW"),
    "temporal":    ("HIGH", "LOW",   "LOW",    "LOW"),
    "spatial":     ("LOW",  "HIGH",  "LOW",    "LOW"),
    "uniform":     ("LOW",  "LOW",   "LOW",    "AVERAGE"),
    "exponential": ("AVERAGE", "LOW", "HIGH",  "LOW"),
    "normal":      ("LOW",  "LOW",   "HIGH",   "AVERAGE"),
}
