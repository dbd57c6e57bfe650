"""Host-to-device helpers of the SpMV/SpMM kernels (port of
``repro.kernels.bsr_spmv.ops``): container builds and device staging.

Execution goes through the facade (``repro_torch.sparse.plan``);
construction through ``SparseTensor.from_csr``. ``prepare`` /
``prepare_sell`` return the bare host container as the JAX helpers do.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ...core.autotune import SELL_SIGMA, Schedule
from ...core.csr import CSR, ELLBSR, SELLBSR


def sell_cell_ptr(cell_row: np.ndarray, n_block_rows: int,
                  n_cells: int | None = None) -> np.ndarray:
    """Row pointer (n_block_rows+1,) int32 of a nondecreasing ``cell_row``:
    sorted row r owns cells ``ptr[r]:ptr[r+1]``; rows that own no cells
    (bucket-padded rows) get an empty range. Only the first ``n_cells``
    cells (default: all) are assigned; cells past ``ptr[-1]`` belong to no
    row."""
    rows = np.asarray(cell_row)[:n_cells]
    return np.searchsorted(rows, np.arange(n_block_rows + 1),
                           side="left").astype(np.int32)


def sell_row_ptr(cell_row: np.ndarray, n_block_rows: int,
                 live_cells: int | None = None) -> np.ndarray:
    """The pointer the SELL kernels walk: the ``live_cells`` leading cells
    (default: all) and, when the stream has bucket-pad cells past them,
    exactly one of those. Pad cells carry the last sorted row's
    ``cell_row``, so that row gets it: the TPU kernel sums every pad cell
    into that row, and every pad cell is the same product (the zero block
    times ``x_blocks[0]``, NaN where that holds an Inf or a NaN), so one of
    them gives the all-cell sum up to the sign of an exact zero while the
    rest of the dead tail is never walked."""
    live = len(cell_row) if live_cells is None else live_cells
    return sell_cell_ptr(cell_row, n_block_rows, live + 1)


def sell_cell_valid(cell_block: np.ndarray, ptr: np.ndarray,
                    zero_idx: int) -> np.ndarray:
    """(n_br,) int32: the real cells (``cell_block != zero_idx``) of each
    sorted row under ``ptr``. They lead the row (``SELLBSR.from_bsr`` puts
    the slice-width pad cells after them), so the SELL SpMV kernel sums
    these and folds in one more cell when the row's range is longer."""
    counts = np.diff(np.asarray(ptr, np.int64))
    rows = np.repeat(np.arange(counts.size), counts)
    real = np.asarray(cell_block)[: int(ptr[-1])] != zero_idx
    return np.bincount(rows[real], minlength=counts.size).astype(np.int32)


def ell_device_arrays(ell: ELLBSR, device="cuda"
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 int]:
    """Move an ELLBSR container to device tensors for the kernel."""
    return (torch.as_tensor(ell.block_indices, dtype=torch.int32,
                            device=device),
            torch.as_tensor(ell.block_cols, dtype=torch.int32, device=device),
            torch.as_tensor(ell.blocks, dtype=torch.float32, device=device),
            ell.block_size)


def sell_device_arrays(sell: SELLBSR, device="cuda"
                       ) -> Tuple[torch.Tensor, ...]:
    """Move a SELLBSR cell schedule to device tensors: the SELL kernels'
    positional arguments (cell_block, cell_col, cell_ptr, row_perm, blocks)
    and then ``cell_valid``, the count the SpMV kernel takes as a keyword.
    Every cell is live; the zero block is the last."""
    ptr = sell_row_ptr(sell.cell_row, sell.n_block_rows)
    valid = sell_cell_valid(sell.cell_block, ptr, sell.blocks.shape[0] - 1)
    return tuple(torch.as_tensor(a, dtype=dt, device=device) for a, dt in (
        (sell.cell_block, torch.int32), (sell.cell_col, torch.int32),
        (ptr, torch.int32), (sell.row_perm, torch.int32),
        (sell.blocks, torch.float32), (valid, torch.int32)))


def prepare(csr: CSR, block_size: int = 128,
            max_blocks: int | None = None) -> ELLBSR:
    """The ELL host container (``SparseTensor.from_csr`` for the device
    operand)."""
    from ...sparse import SparseTensor
    return SparseTensor.build_container(
        csr, Schedule("bsr", block_size, 1.0), max_blocks=max_blocks)


def prepare_sell(csr: CSR, block_size: int = 128, slice_height: int = 8,
                 sigma: int = SELL_SIGMA) -> SELLBSR:
    """The SELL host container (``SparseTensor.from_csr(..., layout=
    "sell")`` for the device operand)."""
    from ...sparse import SparseTensor
    return SparseTensor.build_container(
        csr, Schedule("bsr", block_size, 1.0, layout="sell",
                      slice_height=slice_height), sigma=sigma)
