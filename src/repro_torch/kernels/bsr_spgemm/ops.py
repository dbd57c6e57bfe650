"""SpGEMM symbolic phase (host, vectorized): a copy of
``repro.kernels.bsr_spgemm.ops``, plus the cell pointer the cells kernel
walks.

Two numeric schedules (the op's ``layout`` axis in the facade registry):
  ell    block-pairs padded per output block to ``max_pairs`` — one hub
         output block pads every other block's pair list.
  sell   the SELL cell-flattening trick applied to the ragged Gustavson
         block-rows: one cell per real (a, b) pair, ``cell_c``
         nondecreasing.

The symbolic phase is pure numpy bulk ops (np.repeat / argsort / unique) —
no per-row Python loops; host prep is on the serving path.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ...core.csr import BSR
from ..bsr_spmv.ops import sell_cell_ptr


def _gustavson_join(bsr_a: BSR, bsr_b: BSR
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """All (a_block, b_block) contribution pairs in A-row-major order
    (= Gustavson's scan order), as flat arrays (pair_a, pair_b, c_key)
    where c_key = c_block_row * n_bc_c + c_block_col."""
    n_bc_c = -(-bsr_b.shape[1] // bsr_b.block_size)
    if bsr_a.n_blocks == 0 or bsr_b.n_block_rows == 0:
        z = np.zeros(0, np.int64)
        return z, z, z
    a_rows = np.repeat(np.arange(bsr_a.n_block_rows, dtype=np.int64),
                       bsr_a.blocks_per_row())
    a_cols = bsr_a.block_cols.astype(np.int64)
    b_bpr = bsr_b.blocks_per_row()
    safe = np.minimum(a_cols, bsr_b.n_block_rows - 1)
    cnt = np.where(a_cols < bsr_b.n_block_rows, b_bpr[safe], 0)
    total = int(cnt.sum())
    pa = np.repeat(np.arange(bsr_a.n_blocks, dtype=np.int64), cnt)
    starts = np.concatenate([[0], np.cumsum(cnt)])
    pb = (np.arange(total, dtype=np.int64) - np.repeat(starts[:-1], cnt)
          + np.repeat(bsr_b.block_ptrs[safe], cnt))
    c_key = np.repeat(a_rows, cnt) * n_bc_c + bsr_b.block_cols[pb]
    return pa, pb, c_key


def _group_pairs(bsr_a: BSR, bsr_b: BSR):
    """Join + stable group-by output block. Returns (c_ptrs, c_cols, gid,
    pos, pa, pb, n_c) with pairs sorted by output block, Gustavson order
    preserved inside each group (stable sort)."""
    pa, pb, c_key = _gustavson_join(bsr_a, bsr_b)
    n_bc_c = -(-bsr_b.shape[1] // bsr_b.block_size)
    order = np.argsort(c_key, kind="stable")
    key_s, pa_s, pb_s = c_key[order], pa[order], pb[order]
    uk, first, counts = np.unique(key_s, return_index=True,
                                  return_counts=True)
    n_c = int(uk.size)
    gid = np.repeat(np.arange(n_c, dtype=np.int64), counts)
    pos = np.arange(key_s.size, dtype=np.int64) - np.repeat(first, counts)
    c_cols = (uk % n_bc_c).astype(np.int32)
    c_rows = uk // n_bc_c
    c_ptrs = np.zeros(bsr_a.n_block_rows + 1, dtype=np.int64)
    np.add.at(c_ptrs, c_rows + 1, 1)
    c_ptrs = np.cumsum(c_ptrs)
    return c_ptrs, c_cols, gid, pos, pa_s, pb_s, n_c


def spgemm_symbolic(bsr_a: BSR, bsr_b: BSR) -> Tuple[np.ndarray, np.ndarray,
                                                     np.ndarray, np.ndarray]:
    """Symbolic phase (paper §2.1.3): C's block structure + contribution pairs.

    Returns (c_block_ptrs, c_block_cols, pair_a, pair_b) where pair_a/pair_b
    are (n_c_blocks, max_pairs) int32 padded with the zero-block sentinel.
    Pairs are enumerated in A-row-major order = Gustavson's scan order.
    """
    c_ptrs, c_cols, gid, pos, pa, pb, n_c = _group_pairs(bsr_a, bsr_b)
    mp = int(pos.max()) + 1 if pos.size else 1
    pair_a = np.full((n_c, mp), bsr_a.n_blocks, dtype=np.int32)
    pair_b = np.full((n_c, mp), bsr_b.n_blocks, dtype=np.int32)
    pair_a[gid, pos] = pa
    pair_b[gid, pos] = pb
    return c_ptrs, c_cols, pair_a, pair_b


def spgemm_symbolic_cells(bsr_a: BSR, bsr_b: BSR
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                     np.ndarray, np.ndarray]:
    """Cell-flattened symbolic phase: the SELL trick on Gustavson block-rows.

    Returns (c_block_ptrs, c_block_cols, cell_a, cell_b, cell_c): one cell
    per REAL contribution pair — no pair padding at all. ``cell_c`` is
    nondecreasing (a C block's cells are consecutive), mirroring
    SELLBSR.cell_row.
    """
    c_ptrs, c_cols, gid, _, pa, pb, _ = _group_pairs(bsr_a, bsr_b)
    return (c_ptrs, c_cols, pa.astype(np.int32), pb.astype(np.int32),
            gid.astype(np.int32))


def spgemm_cell_ptr(cell_c: np.ndarray, n_c: int,
                    n_live: Optional[int] = None) -> np.ndarray:
    """Pointer (n_c+1,) int32 of the nondecreasing ``cell_c``: output block
    c owns cells ``ptr[c]:ptr[c+1]``; blocks that own no cells (bucket pad
    blocks, blocks of a padded member) get an empty range. Only the first
    ``n_live`` cells (default all) are assigned. Bucket padding appends
    zero-product cells with ``cell_c = n_c - 1``; passing the live count
    gives them to no block, so the cells kernel never walks that tail on
    one CTA. The twin of ``sell_cell_ptr``."""
    return sell_cell_ptr(cell_c, n_c, n_live)
