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
    cells (default: all) are assigned: bucket padding appends zero-block
    cells to the last row, and a container built before padding passes its
    own cell count so the kernels never walk that dead tail (cells past
    ``ptr[-1]`` belong to no row)."""
    rows = np.asarray(cell_row)[:n_cells]
    return np.searchsorted(rows, np.arange(n_block_rows + 1),
                           side="left").astype(np.int32)


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
    """Move a SELLBSR cell schedule to device tensors in the argument order
    of the SELL kernels: (cell_block, cell_col, cell_ptr, row_perm,
    blocks)."""
    ptr = sell_cell_ptr(sell.cell_row, sell.n_block_rows)
    return tuple(torch.as_tensor(a, dtype=dt, device=device) for a, dt in (
        (sell.cell_block, torch.int32), (sell.cell_col, torch.int32),
        (ptr, torch.int32), (sell.row_perm, torch.int32),
        (sell.blocks, torch.float32)))


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
