"""Schedule-level counters: the TPU analogue of the paper's PMCs (§3.2).

The port's own copy of ``repro.core.counters`` (numpy only): the
selector's cost model is the reference's, fed the port's ``Platform``.

On Arm the paper reads perf counters (stalls, cache misses, MPKI). A TPU
kernel's performance is fixed by its *schedule*: which HBM<->VMEM copies
happen, how many MXU tiles execute, how much of each tile is padding. We
therefore "profile" a kernel by simulating its block schedule over the real
matrix and counting:

  executed_blocks / useful_flops / executed_flops  (padding waste = the
      frontend-stall / branch-flush analogue: dead lanes from irregular rows)
  vmem_hits / vmem_misses over the gathered operand  (the backend-stall /
      cache-miss analogue: LRU residency of x-segments or B block-rows)
  hbm_bytes  (DRAM traffic)
  grid_imbalance  (Eq. 5 applied to per-grid-cell work)

These counters are (a) features for the decision trees alongside the static
metrics, and (b) inputs to the roofline execution-time model (perfmodel.py).
They depend on the matrix *and* the platform (VMEM size), exactly like PMCs
depend on input and machine.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict

import numpy as np

from .csr import CSR, BSR, ELLBSR, SELLBSR, ell_block_cap
from .metrics import count_dominated_before, partition_imbalance, prev_occurrence
from .platforms import Platform

BYTES_F32 = 4


class _LRU:
    """LRU residency model for VMEM-cached operand segments.

    Per-access reference implementation. The counters below run the
    vectorized ``lru_hit_mask`` instead (identical results, no Python loop
    over accesses); tests assert the two stay equivalent.
    """

    def __init__(self, capacity_segments: int) -> None:
        self.cap = max(int(capacity_segments), 1)
        self.store: "OrderedDict[int, None]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    def access(self, key: int) -> bool:
        if key in self.store:
            self.store.move_to_end(key)
            self.hits += 1
            return True
        self.misses += 1
        self.store[key] = None
        if len(self.store) > self.cap:
            self.store.popitem(last=False)
        return False


def lru_hit_mask(stream: np.ndarray, capacity: int) -> np.ndarray:
    """Exact per-access LRU hit/miss mask, vectorized.

    An access hits a capacity-``capacity`` LRU iff its stack distance — the
    number of distinct keys accessed since the previous access to the same
    key — is < capacity. With prev[i] the previous same-key position, every
    j <= prev[i] trivially satisfies prev[j] <= prev[i] (prev[j] < j), so

        d(i) = #{j < i : prev[j] <= prev[i]} - (prev[i] + 1)

    counts exactly the first-in-window accesses in (prev[i], i), i.e. the
    distinct keys of the window. Two exact shortcuts keep the common cases
    O(n log n) sort-bound: if the stream has <= capacity distinct keys every
    reuse hits, and any window shorter than ``capacity`` accesses cannot
    contain ``capacity`` distinct keys, so only long-window reuses need the
    full dominance count.
    """
    stream = np.asarray(stream)
    n = stream.size
    if n == 0:
        return np.zeros(0, dtype=bool)
    cap = max(int(capacity), 1)
    prev = prev_occurrence(stream)
    reused = prev >= 0
    if int(n - reused.sum()) <= cap:  # #first-accesses == #distinct keys
        return reused
    hits = reused & ((np.arange(n) - prev - 1) < cap)
    hard = np.nonzero(reused & ~hits)[0]
    if hard.size:
        d = count_dominated_before(prev, hard) - (prev[hard] + 1)
        hits[hard] = d < cap
    return hits


# The paper pins synthetic matrices at 16M rows so the SpMV dense vector
# (64 MB) exceeds every LLC (§3.3). Our corpus is scaled down for this
# container, so the machine model's VMEM must scale with it to preserve the
# paper's cache-to-working-set ratios (A64FX 32MB / x=64MB etc. -> here
# v4 0.5x, v5e 1x, v5p 2x of the dense vector).
PAPER_N_ROWS = 16_000_000


def vmem_scale_for(n_rows: int) -> float:
    return min(n_rows / PAPER_N_ROWS, 1.0)


def _vmem_budget_segments(platform: Platform, segment_bytes: int,
                          vmem_scale: float = 1.0, frac: float = 0.5) -> int:
    """Half of (scaled) VMEM is modeled as available for the gathered
    operand; the rest holds streamed tiles and double-buffers."""
    budget = platform.vmem_bytes * vmem_scale * frac
    return max(int(budget) // max(segment_bytes, 1), 1)


# ---------------------------------------------------------------------------
# SpMV: y = A @ x over an ELL-BSR schedule (kernels/bsr_spmv)
# ---------------------------------------------------------------------------

def spmv_counters(csr: CSR, platform: Platform, block_size: int = 128,
                  ell_quantile: float = 1.0,
                  vmem_scale: float | None = None,
                  n_rhs: int = 1) -> Dict[str, float]:
    if vmem_scale is None:
        vmem_scale = vmem_scale_for(csr.n_rows)
    n_rhs = max(int(n_rhs), 1)
    bsr = BSR.from_csr(csr, block_size)
    bpr = bsr.blocks_per_row()
    ell = ELLBSR.from_bsr(bsr, ell_block_cap(bpr, ell_quantile))
    bs = block_size
    executed_blocks = ell.block_indices.size
    useful_flops = 2.0 * csr.nnz * n_rhs
    executed_flops = 2.0 * executed_blocks * bs * bs * n_rhs
    dropped_nnz = max(csr.nnz - int(np.count_nonzero(
        ell.blocks[ell.block_indices[ell.block_indices < bsr.n_blocks]])), 0)

    # x-segment residency: one (bs, n_rhs) segment per block column, LRU
    # over VMEM.
    seg_bytes = bs * n_rhs * BYTES_F32
    hit = lru_hit_mask(bsr.block_cols,
                       _vmem_budget_segments(platform, seg_bytes, vmem_scale))
    lru_hits, lru_misses = int(hit.sum()), int(hit.size - hit.sum())

    a_bytes = executed_blocks * bs * bs * BYTES_F32
    x_bytes = lru_misses * seg_bytes
    y_bytes = bsr.n_block_rows * bs * n_rhs * BYTES_F32
    return {
        "executed_blocks": float(executed_blocks),
        "useful_flops": useful_flops,
        "executed_flops": executed_flops,
        "padding_fraction": 1.0 - useful_flops / max(executed_flops, 1.0),
        "vmem_hits": float(lru_hits),
        "vmem_misses": float(lru_misses),
        "vmem_miss_rate": lru_misses / max(lru_hits + lru_misses, 1),
        "hbm_bytes": float(a_bytes + x_bytes + y_bytes),
        "gather_bytes": float(x_bytes),
        "grid_imbalance": partition_imbalance(bpr, 16),
        "dropped_nnz_fraction": dropped_nnz / max(csr.nnz, 1),
        "ell_padding_fraction": ell.ell_padding_fraction(),
    }


# ---------------------------------------------------------------------------
# SELL SpMV/SpMM: the sliced schedule (kernels/bsr_spmv SELL path)
# ---------------------------------------------------------------------------

def sell_spmv_counters(csr: CSR, platform: Platform, block_size: int = 128,
                       slice_height: int = 8, sigma: int = 64, n_rhs: int = 1,
                       vmem_scale: float | None = None) -> Dict[str, float]:
    """Counters for the SELL-C-sigma bucketed schedule, optionally with a
    multi-RHS tile of ``n_rhs`` columns (the SpMM path).

    vs ``spmv_counters``: executed work is the true cell count (padding only
    up to each slice's own max), and every A/x/y byte is amortized over the
    RHS width — one A-block DMA feeds ``n_rhs`` columns of output.
    """
    if vmem_scale is None:
        vmem_scale = vmem_scale_for(csr.n_rows)
    n_rhs = max(int(n_rhs), 1)
    bsr = BSR.from_csr(csr, block_size)
    sell = SELLBSR.from_bsr(bsr, slice_height, sigma)
    bs = block_size
    n_cells = sell.n_cells
    useful_flops = 2.0 * csr.nnz * n_rhs
    executed_flops = 2.0 * n_cells * bs * bs * n_rhs

    # x-segment residency: one (bs, n_rhs) segment per block column, accessed
    # in cell (= sorted slice) order.
    seg_bytes = bs * n_rhs * BYTES_F32
    zero_idx = sell.blocks.shape[0] - 1
    hit = lru_hit_mask(sell.cell_col[sell.cell_block != zero_idx],
                       _vmem_budget_segments(platform, seg_bytes, vmem_scale))
    lru_hits, lru_misses = int(hit.sum()), int(hit.size - hit.sum())

    a_bytes = n_cells * bs * bs * BYTES_F32
    x_bytes = lru_misses * seg_bytes
    y_bytes = bsr.n_block_rows * bs * n_rhs * BYTES_F32
    per_row_cells = np.bincount(sell.cell_row,
                                minlength=max(bsr.n_block_rows, 1))
    return {
        "executed_blocks": float(n_cells),
        "useful_flops": useful_flops,
        "executed_flops": executed_flops,
        "padding_fraction": 1.0 - useful_flops / max(executed_flops, 1.0),
        "vmem_hits": float(lru_hits),
        "vmem_misses": float(lru_misses),
        "vmem_miss_rate": lru_misses / max(lru_hits + lru_misses, 1),
        "hbm_bytes": float(a_bytes + x_bytes + y_bytes),
        "gather_bytes": float(x_bytes),
        "grid_imbalance": partition_imbalance(per_row_cells, 16),
        "sell_padding_fraction": sell.sell_padding_fraction(),
        "ell_padding_fraction": _global_ell_padding(bsr),
        "slice_imbalance": sell.slice_imbalance(),
        "n_rhs": float(n_rhs),
    }


def _global_ell_padding(bsr: BSR) -> float:
    """Slot waste of the global-ELL schedule on the same matrix — the
    before-point the SELL counters are compared against."""
    bpr = bsr.blocks_per_row()
    if bpr.size == 0:
        return 0.0
    slots = bpr.size * max(int(bpr.max()), 1)
    return 1.0 - float(bpr.sum()) / max(slots, 1)


# ---------------------------------------------------------------------------
# SpGEMM numeric: C = A @ B, Gustavson over block rows (kernels/bsr_spgemm)
# ---------------------------------------------------------------------------

def spgemm_counters(a: CSR, b: CSR, platform: Platform, block_size: int = 128,
                    vmem_scale: float | None = None) -> Dict[str, float]:
    if vmem_scale is None:
        vmem_scale = vmem_scale_for(a.n_rows)
    bsr_a = BSR.from_csr(a, block_size)
    bsr_b = BSR.from_csr(b, block_size)
    bs = block_size
    b_bpr = bsr_b.blocks_per_row()
    b_row_bytes = b_bpr * bs * bs * BYTES_F32

    # Useful flops: 2 * sum over nnz a_ij of nnz(B row j).
    b_row_nnz = np.zeros(b.n_rows + 1, dtype=np.int64)
    b_row_nnz[: b.n_rows] = b.row_lengths()
    useful_flops = 2.0 * float(b_row_nnz[np.minimum(a.col_idxs, b.n_rows - 1)].sum())

    # Executed flops: each A block (i,k) multiplies B block-row k densely.
    a_block_cols = bsr_a.block_cols
    safe_cols = np.minimum(a_block_cols, bsr_b.n_block_rows - 1)
    executed_flops = float((2 * bs * bs * bs) * b_bpr[safe_cols].sum())

    # B block-row residency in VMEM (the paper's "poor reuse of the RHS").
    mean_row_bytes = float(b_row_bytes.mean()) if b_row_bytes.size else 1.0
    hit = lru_hit_mask(safe_cols, _vmem_budget_segments(
        platform, int(max(mean_row_bytes, 1)), vmem_scale))
    lru_hits, lru_misses = int(hit.sum()), int(hit.size - hit.sum())
    gather_bytes = float(b_row_bytes[safe_cols[~hit]].sum())

    a_bytes = bsr_a.n_blocks * bs * bs * BYTES_F32
    # C traffic: accumulate block rows (symbolic union size).
    c_blocks = _spgemm_symbolic_blocks(bsr_a, bsr_b)
    c_bytes = c_blocks * bs * bs * BYTES_F32
    return {
        "executed_blocks": float(bsr_a.n_blocks),
        "useful_flops": useful_flops,
        "executed_flops": max(executed_flops, useful_flops),
        "padding_fraction": 1.0 - useful_flops / max(executed_flops, 1.0),
        "vmem_hits": float(lru_hits),
        "vmem_misses": float(lru_misses),
        "vmem_miss_rate": lru_misses / max(lru_hits + lru_misses, 1),
        "hbm_bytes": float(a_bytes + gather_bytes + c_bytes),
        "gather_bytes": gather_bytes,
        "grid_imbalance": partition_imbalance(bsr_a.blocks_per_row(), 16),
        "c_blocks": float(c_blocks),
    }


def _spgemm_symbolic_blocks(bsr_a: BSR, bsr_b: BSR) -> int:
    """Symbolic phase at block granularity: |union of B block-rows per A row|."""
    total = 0
    b_rows: Dict[int, np.ndarray] = {}
    for br in range(bsr_b.n_block_rows):
        b_rows[br] = bsr_b.block_cols[bsr_b.block_ptrs[br]: bsr_b.block_ptrs[br + 1]]
    for br in range(bsr_a.n_block_rows):
        ks = bsr_a.block_cols[bsr_a.block_ptrs[br]: bsr_a.block_ptrs[br + 1]]
        if ks.size == 0:
            continue
        cols = np.concatenate([b_rows.get(int(k), np.empty(0, np.int32)) for k in ks])
        total += int(np.unique(cols).size)
    return total


# ---------------------------------------------------------------------------
# SpADD: C = A + B block-union schedule (kernels/bsr_spadd)
# ---------------------------------------------------------------------------

def spadd_counters(a: CSR, b: CSR, platform: Platform, block_size: int = 128,
                   vmem_scale: float | None = None) -> Dict[str, float]:
    bsr_a = BSR.from_csr(a, block_size)
    bsr_b = BSR.from_csr(b, block_size)
    bs = block_size
    union_blocks = 0
    inter_blocks = 0
    per_row_union = np.zeros(bsr_a.n_block_rows, dtype=np.int64)
    for br in range(bsr_a.n_block_rows):
        ca = set(bsr_a.block_cols[bsr_a.block_ptrs[br]: bsr_a.block_ptrs[br + 1]].tolist())
        cb = set(bsr_b.block_cols[bsr_b.block_ptrs[br]: bsr_b.block_ptrs[br + 1]].tolist()) \
            if br < bsr_b.n_block_rows else set()
        u = len(ca | cb)
        union_blocks += u
        inter_blocks += len(ca & cb)
        per_row_union[br] = u

    useful_flops = float(a.nnz + b.nnz)  # one add/copy per input nonzero
    executed_flops = float(union_blocks * bs * bs)  # one vector add per union block
    a_bytes = bsr_a.n_blocks * bs * bs * BYTES_F32
    b_bytes = bsr_b.n_blocks * bs * bs * BYTES_F32
    c_bytes = union_blocks * bs * bs * BYTES_F32
    # ELL regularization of the union structure: the irregularity cost.
    mx = int(per_row_union.max()) if per_row_union.size else 1
    ell_slots = bsr_a.n_block_rows * max(mx, 1)
    return {
        "executed_blocks": float(union_blocks),
        "useful_flops": useful_flops,
        "executed_flops": max(executed_flops, useful_flops),
        "padding_fraction": 1.0 - useful_flops / max(executed_flops, 1.0),
        "vmem_hits": 0.0,  # streaming kernel: no gathered operand (paper §2.1.4)
        "vmem_misses": 0.0,
        "vmem_miss_rate": 0.0,
        "hbm_bytes": float(a_bytes + b_bytes + c_bytes),
        "gather_bytes": 0.0,
        "grid_imbalance": partition_imbalance(per_row_union, 16),
        "ell_slot_waste": 1.0 - union_blocks / max(ell_slots, 1),
        "merge_overlap": inter_blocks / max(union_blocks, 1),
    }


COUNTER_NAMES = (
    "padding_fraction", "vmem_miss_rate", "grid_imbalance", "hbm_bytes",
    "gather_bytes", "executed_flops",
)


# ---------------------------------------------------------------------------
# Sharded execution: per-shard static features (DESIGN.md §10)
# ---------------------------------------------------------------------------

def shard_counters(csr: CSR, bounds) -> list:
    """Per-shard static features for a contiguous row split.

    ``bounds`` is the (n_shards + 1)-entry row boundary vector of a
    ``repro.sparse.partition.RowPartition``. Each shard gets the Eq. 5
    story at two scales: its own deviation from the ideal nnz share
    (``nnz_share_dev`` — the cross-shard imbalance the partitioner
    minimizes) and the within-shard ``grid_imbalance`` of its rows (the
    per-shard schedule problem the selector solves shard by shard — skewed
    matrices yield structurally different shards, hence different
    fingerprints, hence different layouts/block sizes per shard).
    """
    bounds = np.asarray(bounds, np.int64)
    lengths = csr.row_lengths()
    csum = np.concatenate([[0], np.cumsum(lengths)])
    n_parts = bounds.size - 1
    total = float(csum[-1])
    ideal = total / max(n_parts, 1)
    out = []
    for i in range(n_parts):
        lo, hi = int(bounds[i]), int(bounds[i + 1])
        seg = lengths[lo:hi]
        nnz = float(csum[hi] - csum[lo])
        mean = float(seg.mean()) if seg.size else 0.0
        std = float(seg.std()) if seg.size else 0.0
        out.append({
            "rows": float(hi - lo),
            "nnz": nnz,
            "nnz_share_dev": abs(nnz - ideal) / ideal if ideal > 0 else 0.0,
            "mean_row_length": mean,
            "cv_row_length": std / mean if mean > 0 else 0.0,
            "grid_imbalance": partition_imbalance(seg, 16),
        })
    return out
