"""Static input metrics from SpChar §3.4 (Eq. 1-6), computed without running
the kernels.

The port's own copy of ``repro.core.metrics`` (numpy only).

All metrics operate on host numpy (characterization is a preprocessing step,
exactly as in the paper) and return floats in [0, 1] except thread imbalance
which is >= 0.
"""
from __future__ import annotations

from typing import Dict, Iterable, Sequence

import numpy as np

from .csr import CSR, sell_layout

# Paper §3.4: thread imbalance is evaluated for this T sweep.
THREAD_SWEEP = (2, 4, 16, 32, 48, 64, 128)


def branch_entropy(csr: CSR) -> float:
    """Eq. (1)-(2): normalized entropy of the row-length distribution.

    0 = all rows equal (perfectly predictable inner-loop trip count),
    1 = maximum-entropy row lengths. On TPU this predicts padded-tile waste
    of ELL-style schedules rather than branch-miss flushes (DESIGN.md §2).
    """
    lengths = csr.row_lengths()
    if lengths.size == 0:
        return 0.0
    values, counts = np.unique(lengths, return_counts=True)
    n_classes = values.size
    if n_classes <= 1:
        return 0.0
    p = counts / counts.sum()
    entropy = -np.sum(p * np.log(p))
    e_max = np.log(n_classes)
    return float(entropy / e_max)


def _lookup_stream(csr: CSR) -> np.ndarray:
    """The indirectly-accessed index stream (paper: RHS 'lookup' side).

    For SpMV/SpGEMM the scanned LHS has optimal locality by construction, so
    the paper characterizes only the col_idxs stream that indexes the dense
    vector / the rows of B.
    """
    return csr.col_idxs.astype(np.int64)


def prev_occurrence(stream: np.ndarray) -> np.ndarray:
    """prev[i] = position of the previous access to stream[i]'s key, or -1."""
    n = stream.size
    order = np.argsort(stream, kind="stable")
    s = stream[order]
    prev = np.full(n, -1, dtype=np.int64)
    same = s[1:] == s[:-1]
    prev[order[1:][same]] = order[:-1][same]
    return prev


def count_dominated_before(prev: np.ndarray, q_idx: np.ndarray,
                           chunk: int = 512) -> np.ndarray:
    """For each query position i in ``q_idx`` (sorted ascending):
    #{j < i : prev[j] <= prev[i]}, without a per-access Python loop.

    This is the primitive behind both stack/reuse distances (here) and the
    LRU residency counters (counters.py): with prev the previous-occurrence
    array, every j <= prev[i] trivially satisfies prev[j] <= prev[i]
    (prev[j] < j), so the count minus (prev[i] + 1) is exactly the number of
    first-in-window accesses in (prev[i], i) — the distinct keys touched
    since position i's key was last accessed.

    Chunked two-level count: queries inside a chunk compare against that
    chunk with one broadcasted matrix; earlier chunks are kept sorted in
    O(log n) Bentley-Saxe merged blocks and queried with searchsorted, so
    Python-level iterations are O(n/chunk * log(n/chunk)).
    """
    n = prev.size
    out = np.zeros(q_idx.size, dtype=np.int64)
    blocks: list = []  # sorted arrays of earlier prev values, sizes decreasing
    for start in range(0, n, chunk):
        end = min(start + chunk, n)
        lo, hi = np.searchsorted(q_idx, (start, end))
        qi = q_idx[lo:hi]
        if qi.size:
            qv = prev[qi]
            for blk in blocks:
                out[lo:hi] += np.searchsorted(blk, qv, side="right")
            c = prev[start:end]
            in_chunk = ((c[None, :] <= qv[:, None])
                        & (np.arange(start, end)[None, :] < qi[:, None]))
            out[lo:hi] += in_chunk.sum(axis=1)
        blocks.append(np.sort(prev[start:end]))
        while len(blocks) > 1 and blocks[-2].size <= blocks[-1].size:
            merged = np.concatenate([blocks.pop(), blocks.pop()])
            merged.sort()
            blocks.append(merged)
    return out


def stack_distances(stream: np.ndarray) -> np.ndarray:
    """Exact stack distance per reuse (distinct keys since the previous
    access of the same key), for the reuse positions in stream order."""
    prev = prev_occurrence(stream)
    reuse_idx = np.nonzero(prev >= 0)[0]
    if reuse_idx.size == 0:
        return np.zeros(0, dtype=np.int64)
    return count_dominated_before(prev, reuse_idx) - (prev[reuse_idx] + 1)


def mean_reuse_distance(stream: np.ndarray, max_samples: int = 200_000) -> float:
    """Mean reuse distance (#distinct addresses between reuses) of a stream.

    The "distinct elements since last access" stack distance, computed
    vectorized (no per-access Python loop — fingerprinting is on the
    selector's serving path). Streams longer than ``max_samples`` are
    uniformly subsampled as in the paper's tooling (metrics must stay cheap
    relative to kernel runs).
    """
    stream = np.asarray(stream, dtype=np.int64)
    if stream.size == 0:
        return 0.0
    if stream.size > max_samples:
        step = stream.size // max_samples
        stream = stream[::step]
    d = stack_distances(stream)
    if d.size == 0:
        return float(stream.size)  # never reused: effectively infinite; clamp
    return float(d.sum() / d.size)


def mean_index_distance(stream: np.ndarray, max_samples: int = 1_000_000) -> float:
    """Mean |idx[i+1] - idx[i]| of consecutively accessed indices (spatial)."""
    stream = np.asarray(stream, dtype=np.int64)
    if stream.size < 2:
        return 0.0
    if stream.size > max_samples:
        step = stream.size // max_samples
        stream = stream[::step]
    return float(np.mean(np.abs(np.diff(stream))))


def reuse_affinity(csr: CSR) -> float:
    """Eq. (3): 1 / log10(10 + reuse_distance) in (0, 1]."""
    rd = mean_reuse_distance(_lookup_stream(csr))
    return float(1.0 / np.log10(10.0 + rd))


def index_affinity(csr: CSR) -> float:
    """Eq. (4): 1 / log10(10 + index_distance) in (0, 1]."""
    idist = mean_index_distance(_lookup_stream(csr))
    return float(1.0 / np.log10(10.0 + idist))


def thread_imbalance(csr: CSR, n_threads: int) -> float:
    """Eq. (5)-(6): row-wise partition imbalance for ``n_threads`` shards.

    Rows are split into T contiguous chunks (Fig. 1 partitioning); the metric
    is mean |nnz_assigned - nnz_ideal| / nnz_ideal. Identically reusable for
    MoE tokens-per-expert imbalance (DESIGN.md §4).
    """
    lengths = csr.row_lengths()
    return partition_imbalance(lengths, n_threads)


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


def imbalance_sweep(csr: CSR, threads: Sequence[int] = THREAD_SWEEP) -> Dict[int, float]:
    return {t: thread_imbalance(csr, t) for t in threads}


# ---------------------------------------------------------------------------
# SELL-C-sigma layout math (DESIGN.md §2.3) — static, distribution-only forms
# of the counters counters.py reports for the sliced schedule. They operate
# on any per-row work vector (blocks-per-row for the kernels, tokens-per-
# expert for MoE) so the padding cost of slicing is predictable without
# building the container.
# ---------------------------------------------------------------------------

def sell_slice_widths(work_per_row: np.ndarray, slice_height: int,
                      sigma: int) -> np.ndarray:
    """Per-slice padded width after window-sorting rows by work.

    Rows are sorted descending inside windows of ``sigma``, grouped into
    slices of ``slice_height``; each slice pads to its own max (min 1, the
    SELLBSR invariant that keeps every output row scheduled). Delegates to
    ``csr.sell_layout`` — the same math the container is built from.
    """
    _, widths = sell_layout(work_per_row, slice_height, sigma)
    return widths


def sell_padding_fraction(work_per_row: np.ndarray, slice_height: int,
                          sigma: int) -> float:
    """Fraction of SELL schedule cells that are padding: the sliced
    counterpart of ``ELLBSR.ell_padding_fraction`` (global padding)."""
    work = np.asarray(work_per_row, dtype=np.int64)
    if work.size == 0:
        return 0.0
    C = max(int(slice_height), 1)
    widths = sell_slice_widths(work, C, sigma)
    cells = int(np.repeat(widths, C)[: work.size].sum())
    return 1.0 - float(work.sum()) / max(cells, 1)


def slice_imbalance(work_per_row: np.ndarray, slice_height: int,
                    sigma: int) -> float:
    """Eq. (5) applied at slice granularity: mean relative deviation of
    per-slice padded width. 0 = slices perfectly even (uniform rows or
    sigma large enough to sort the skew away); grows with unsorted skew."""
    widths = sell_slice_widths(work_per_row, slice_height, sigma).astype(np.float64)
    mean = widths.mean() if widths.size else 0.0
    if mean <= 0:
        return 0.0
    return float(np.mean(np.abs(widths - mean)) / mean)


def characterize(csr: CSR, threads: Sequence[int] = THREAD_SWEEP) -> Dict[str, float]:
    """Full static-metric vector for one matrix (the paper's 'tail' features)."""
    feats: Dict[str, float] = {
        "branch_entropy": branch_entropy(csr),
        "reuse_affinity": reuse_affinity(csr),
        "index_affinity": index_affinity(csr),
        "log_nnz": float(np.log10(max(csr.nnz, 1))),
        "log_rows": float(np.log10(max(csr.n_rows, 1))),
        "density": csr.density(),
        "mean_row_length": float(csr.row_lengths().mean()) if csr.n_rows else 0.0,
        "cv_row_length": _cv(csr.row_lengths()),
    }
    for t, v in imbalance_sweep(csr, threads).items():
        feats[f"thread_imbalance_t{t}"] = v
    return feats


def _cv(x: np.ndarray) -> float:
    x = np.asarray(x, dtype=np.float64)
    m = x.mean() if x.size else 0.0
    return float(x.std() / m) if m > 0 else 0.0


FEATURE_NAMES = tuple(
    ["branch_entropy", "reuse_affinity", "index_affinity", "log_nnz", "log_rows",
     "density", "mean_row_length", "cv_row_length"]
    + [f"thread_imbalance_t{t}" for t in THREAD_SWEEP]
)
