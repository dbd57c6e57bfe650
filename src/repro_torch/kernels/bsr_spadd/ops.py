"""SpADD symbolic phase (host, vectorized): a copy of
``repro.kernels.bsr_spadd.ops``.

The union block structure is computed with numpy bulk ops (repeat /
unique / scatter) — no per-row Python loops; host prep is on the serving
path. The numeric phase lives behind the facade
(``repro_torch.sparse.plan("spadd", ...)``).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from ...core.csr import BSR


def _block_keys(bsr: BSR, n_bc: int) -> np.ndarray:
    rows = np.repeat(np.arange(bsr.n_block_rows, dtype=np.int64),
                     bsr.blocks_per_row())
    return rows * n_bc + bsr.block_cols.astype(np.int64)


def spadd_symbolic(bsr_a: BSR, bsr_b: BSR) -> Tuple[np.ndarray, np.ndarray,
                                                    np.ndarray, np.ndarray]:
    """Symbolic phase: union block structure of C = A + B.

    Returns (c_block_ptrs, c_block_cols, ia, ib) where ia/ib index into the
    block arrays of A/B with the zeros-sentinel convention (n_blocks = the
    appended zero block).
    """
    n_br = max(bsr_a.n_block_rows, bsr_b.n_block_rows)
    n_bc = max(-(-bsr_a.shape[1] // bsr_a.block_size),
               -(-bsr_b.shape[1] // bsr_b.block_size))
    keys_a = _block_keys(bsr_a, n_bc)
    keys_b = _block_keys(bsr_b, n_bc)
    uk, inv = np.unique(np.concatenate([keys_a, keys_b]),
                        return_inverse=True)
    n_c = int(uk.size)
    ia = np.full(n_c, bsr_a.n_blocks, dtype=np.int32)
    ib = np.full(n_c, bsr_b.n_blocks, dtype=np.int32)
    ia[inv[: keys_a.size]] = np.arange(keys_a.size, dtype=np.int32)
    ib[inv[keys_a.size:]] = np.arange(keys_b.size, dtype=np.int32)
    c_cols = (uk % n_bc).astype(np.int32)
    c_ptrs = np.zeros(n_br + 1, dtype=np.int64)
    np.add.at(c_ptrs, uk // n_bc + 1, 1)
    c_ptrs = np.cumsum(c_ptrs)
    return c_ptrs, c_cols, ia, ib
