"""Sparse matrix containers: CSR (paper interchange format), BSR, ELL-BSR
and SELL-BSR — the port's own copy of ``repro.core.csr`` (the JAX package
stays the reference; the port imports nothing from it).

CSR is the paper's format (Fig. 1): ``row_ptrs`` / ``col_idxs`` / ``nnz_vals``.
BSR/ELL-BSR are the blocked layouts the BSR kernels consume (DESIGN.md §2);
the dense-tile block schedule is the paper's §4.4 "ELL / 2D-blocked format"
recommendation. SELL-BSR (DESIGN.md §2.3) is the sliced refinement:
block-rows are sorted by work inside windows of ``sigma`` and padded per
slice of ``slice_height`` rows instead of globally, so one power-law row no
longer pads everyone.

Containers are plain numpy on the host (construction/characterization
side); ``repro_torch.sparse.SparseTensor`` moves them to the device. All
``from_*`` constructors are vectorized — no per-row Python loops — because
host prep is on the serving path.

``spmv_oracle`` / ``spmm_oracle`` are float64 CSR products that never
densify the matrix, so they check outputs at sizes (10^5-10^6 rows) where a
dense copy cannot be built.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass
class CSR:
    """Compressed Sparse Row matrix (paper §2.1.1)."""

    row_ptrs: np.ndarray  # (n_rows + 1,) uint32/int64
    col_idxs: np.ndarray  # (nnz,) uint32
    nnz_vals: np.ndarray  # (nnz,) float32
    shape: Tuple[int, int]

    def __post_init__(self) -> None:
        self.row_ptrs = np.asarray(self.row_ptrs)
        self.col_idxs = np.asarray(self.col_idxs)
        self.nnz_vals = np.asarray(self.nnz_vals)
        if self.row_ptrs.ndim != 1 or self.row_ptrs.shape[0] != self.shape[0] + 1:
            raise ValueError("row_ptrs must have shape (n_rows + 1,)")
        if self.col_idxs.shape != self.nnz_vals.shape:
            raise ValueError("col_idxs and nnz_vals must align")

    # ---------------------------------------------------------------- basics
    @property
    def nnz(self) -> int:
        return int(self.col_idxs.shape[0])

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    def row_lengths(self) -> np.ndarray:
        return np.diff(self.row_ptrs).astype(np.int64)

    def density(self) -> float:
        return self.nnz / float(self.shape[0] * self.shape[1])

    # ------------------------------------------------------------ conversion
    @classmethod
    def from_dense(cls, dense: np.ndarray) -> "CSR":
        dense = np.asarray(dense)
        rows, cols = np.nonzero(dense)
        order = np.lexsort((cols, rows))
        rows, cols = rows[order], cols[order]
        vals = dense[rows, cols].astype(np.float32)
        row_ptrs = np.zeros(dense.shape[0] + 1, dtype=np.int64)
        np.add.at(row_ptrs, rows + 1, 1)
        row_ptrs = np.cumsum(row_ptrs)
        return cls(row_ptrs, cols.astype(np.uint32), vals, dense.shape)

    @classmethod
    def from_coo(
        cls, rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, shape: Tuple[int, int]
    ) -> "CSR":
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals, dtype=np.float32)
        # Deduplicate (last write wins like scipy's sum_duplicates but summed).
        order = np.lexsort((cols, rows))
        rows, cols, vals = rows[order], cols[order], vals[order]
        if rows.size:
            keep = np.ones(rows.size, dtype=bool)
            dup = (rows[1:] == rows[:-1]) & (cols[1:] == cols[:-1])
            if dup.any():
                # sum duplicate entries
                group = np.concatenate([[0], np.cumsum(~dup)])
                vals = np.bincount(group, weights=vals).astype(np.float32)
                keep = np.concatenate([[True], ~dup])
                rows, cols = rows[keep], cols[keep]
        row_ptrs = np.zeros(shape[0] + 1, dtype=np.int64)
        np.add.at(row_ptrs, rows + 1, 1)
        row_ptrs = np.cumsum(row_ptrs)
        return cls(row_ptrs, cols.astype(np.uint32), vals, shape)

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=np.float32)
        lens = self.row_lengths()
        rows = np.repeat(np.arange(self.n_rows), lens)
        np.add.at(out, (rows, self.col_idxs.astype(np.int64)), self.nnz_vals)
        return out

    def transpose(self) -> "CSR":
        lens = self.row_lengths()
        rows = np.repeat(np.arange(self.n_rows), lens)
        return CSR.from_coo(
            self.col_idxs.astype(np.int64), rows, self.nnz_vals, (self.n_cols, self.n_rows)
        )


@dataclasses.dataclass
class BSR:
    """Block-sparse row matrix: dense (bs x bs) blocks over a coarse CSR.

    ``block_ptrs/block_cols`` index the coarse (block-row, block-col) grid;
    ``blocks[k]`` is the dense tile for the k-th stored block.
    """

    block_ptrs: np.ndarray  # (n_block_rows + 1,)
    block_cols: np.ndarray  # (n_blocks,)
    blocks: np.ndarray  # (n_blocks, bs, bs) float32
    shape: Tuple[int, int]  # original (possibly unpadded) shape
    block_size: int

    @property
    def n_block_rows(self) -> int:
        return self.block_ptrs.shape[0] - 1

    @property
    def n_blocks(self) -> int:
        return int(self.block_cols.shape[0])

    def blocks_per_row(self) -> np.ndarray:
        return np.diff(self.block_ptrs).astype(np.int64)

    def padding_fraction(self) -> float:
        """Fraction of stored block entries that are structural zeros.

        TPU analogue of the paper's branch-misprediction waste (DESIGN.md §2):
        every stored zero is an MXU lane doing dead work.
        """
        stored = self.n_blocks * self.block_size * self.block_size
        if stored == 0:
            return 0.0
        nnz = int(np.count_nonzero(self.blocks))
        return 1.0 - nnz / stored

    @classmethod
    def from_csr(cls, csr: CSR, block_size: int) -> "BSR":
        bs = block_size
        n_br = -(-csr.n_rows // bs)
        n_bc = -(-csr.n_cols // bs)
        lens = csr.row_lengths()
        rows = np.repeat(np.arange(csr.n_rows), lens)
        cols = csr.col_idxs.astype(np.int64)
        brows, bcols = rows // bs, cols // bs
        # unique (brow, bcol) pairs, row-major order
        key = brows * n_bc + bcols
        uniq, inv = np.unique(key, return_inverse=True)
        blocks = np.zeros((uniq.size, bs, bs), dtype=np.float32)
        np.add.at(blocks, (inv, rows % bs, cols % bs), csr.nnz_vals)
        u_brows, u_bcols = uniq // n_bc, uniq % n_bc
        block_ptrs = np.zeros(n_br + 1, dtype=np.int64)
        np.add.at(block_ptrs, u_brows + 1, 1)
        block_ptrs = np.cumsum(block_ptrs)
        return cls(block_ptrs, u_bcols.astype(np.int32), blocks, csr.shape, bs)

    def to_dense(self) -> np.ndarray:
        bs = self.block_size
        n_br = self.n_block_rows
        n_bc = -(-self.shape[1] // bs)
        grid = np.zeros((n_br, n_bc, bs, bs), dtype=np.float32)
        brows = np.repeat(np.arange(n_br), self.blocks_per_row())
        np.add.at(grid, (brows, self.block_cols.astype(np.int64)), self.blocks)
        out = grid.transpose(0, 2, 1, 3).reshape(n_br * bs, n_bc * bs)
        return out[: self.shape[0], : self.shape[1]]


@dataclasses.dataclass
class ELLBSR:
    """ELL-padded BSR: fixed ``max_blocks`` per block-row (paper §4.4's ELL).

    Regular layout → static Pallas grid. Padding slots point at a shared
    all-zeros block (index ``n_blocks``), making the schedule branch-free:
    the paper's data-dependent merge/branch becomes dead-lane compute whose
    cost is exactly the ``ell_padding_fraction`` counter.
    """

    block_indices: np.ndarray  # (n_block_rows, max_blocks) int32, padded with n_blocks
    block_cols: np.ndarray  # (n_block_rows, max_blocks) int32, padded with 0
    blocks: np.ndarray  # (n_blocks + 1, bs, bs); last block is zeros
    shape: Tuple[int, int]
    block_size: int
    valid_counts: np.ndarray  # (n_block_rows,) int32

    @property
    def max_blocks(self) -> int:
        return int(self.block_indices.shape[1])

    def ell_padding_fraction(self) -> float:
        total = self.block_indices.size
        valid = int(self.valid_counts.sum())
        return 1.0 - valid / max(total, 1)

    @classmethod
    def from_bsr(cls, bsr: BSR, max_blocks: int | None = None) -> "ELLBSR":
        bpr = bsr.blocks_per_row()
        mb = int(bpr.max()) if max_blocks is None else int(max_blocks)
        mb = max(mb, 1)
        n_br = bsr.n_block_rows
        zero_idx = bsr.n_blocks
        # Slot grid: position of slot j in row br is block_ptrs[br] + j while
        # j < blocks_per_row; out-of-range slots point at the zero block.
        slot = np.arange(mb, dtype=np.int64)[None, :]
        valid = slot < np.minimum(bpr, mb)[:, None]
        pos = bsr.block_ptrs[:-1][:, None] + slot
        block_indices = np.where(valid, pos, zero_idx).astype(np.int32)
        if bsr.n_blocks:
            safe = np.minimum(pos, bsr.n_blocks - 1)
            block_cols = np.where(valid, bsr.block_cols[safe], 0).astype(np.int32)
        else:
            block_cols = np.zeros((n_br, mb), dtype=np.int32)
        blocks = np.concatenate(
            [bsr.blocks, np.zeros((1, bsr.block_size, bsr.block_size), np.float32)], axis=0
        )
        return cls(
            block_indices,
            block_cols,
            blocks,
            bsr.shape,
            bsr.block_size,
            np.minimum(bpr, mb).astype(np.int32),
        )


def ell_block_cap(blocks_per_row: np.ndarray, quantile: float) -> int:
    """Quantile block-cap rule of the q<1 ELL schedule: rows beyond the
    ``quantile`` of blocks-per-row are truncated. Shared by the counters
    simulation (counters.spmv_counters) and the container build
    (kernels.bsr_spmv.prepare_with_schedule) so the schedule that was
    modeled is exactly the one served."""
    bpr = np.asarray(blocks_per_row)
    if bpr.size == 0:
        return 1
    if quantile >= 1.0:
        return max(int(bpr.max()), 1)
    return max(int(np.quantile(bpr, quantile)), 1)


def sell_layout(work_per_row: np.ndarray, slice_height: int, sigma: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """The SELL-C-sigma schedule math, shared by ``SELLBSR.from_bsr`` and
    the static metric forms (metrics.sell_slice_widths etc.).

    Returns ``(row_perm, slice_widths)``: the window-sorted permutation
    (descending work, stable inside windows of ``sigma``; sorted position ->
    original row) and each slice's padded width (per-slice max, min 1 so
    every row stays scheduled).
    """
    work = np.asarray(work_per_row, dtype=np.int64)
    n = work.size
    C = max(int(slice_height), 1)
    sg = max(int(sigma), 1)
    # Padded tail rows (key -1) sort last inside the final window and drop.
    n_pad = -(-max(n, 1) // sg) * sg
    keys = np.full(n_pad, -1, dtype=np.int64)
    keys[:n] = work
    order = np.argsort(-keys.reshape(-1, sg), axis=1, kind="stable")
    perm = (order + np.arange(0, n_pad, sg)[:, None]).reshape(-1)
    row_perm = perm[perm < n].astype(np.int32)
    n_slices = -(-max(n, 1) // C)
    padded = np.zeros(n_slices * C, dtype=np.int64)
    padded[:n] = work[row_perm]
    slice_widths = np.maximum(padded.reshape(n_slices, C).max(axis=1), 1)
    return row_perm, slice_widths


@dataclasses.dataclass
class SELLBSR:
    """Sliced-ELL BSR (SELL-C-sigma at block-row granularity, DESIGN.md §2.3).

    Block-rows are sorted by blocks-per-row (descending, stable) inside
    windows of ``sigma`` rows, grouped into slices of ``slice_height`` rows,
    and each slice is padded only to its *own* widest row — a single
    power-law row pads its slice, not the whole matrix. The schedule is
    flattened to one cell per (block-row, slot) pair so the Pallas grid runs
    exactly ``n_cells`` steps: ``cell_block[t]`` / ``cell_col[t]`` select the
    A tile and x segment for grid step ``t`` and ``cell_row[t]`` is the
    *sorted* output block-row (nondecreasing, so the output tile stays
    resident across a row's cells). The op scatters results back through
    ``row_perm``.

    Empty slices keep width 1 (all-zero cells) so every output block-row is
    visited and initialized by the kernel.
    """

    cell_block: np.ndarray  # (n_cells,) int32 — index into blocks; pads -> zero block
    cell_col: np.ndarray    # (n_cells,) int32 — block-column per cell
    cell_row: np.ndarray    # (n_cells,) int32 — sorted output block-row, nondecreasing
    row_perm: np.ndarray    # (n_block_rows,) int32 — sorted position -> original row
    slice_widths: np.ndarray  # (n_slices,) int32 — per-slice padded width
    blocks: np.ndarray      # (n_blocks + 1, bs, bs); last block is zeros
    shape: Tuple[int, int]
    block_size: int
    slice_height: int
    sigma: int

    @property
    def n_block_rows(self) -> int:
        return int(self.row_perm.shape[0])

    @property
    def n_cells(self) -> int:
        return int(self.cell_block.shape[0])

    @property
    def n_slices(self) -> int:
        return int(self.slice_widths.shape[0])

    def sell_padding_fraction(self) -> float:
        """Fraction of schedule cells that are padding (the SELL analogue of
        ``ELLBSR.ell_padding_fraction``; same slot-waste semantics)."""
        zero_idx = self.blocks.shape[0] - 1
        valid = int(np.count_nonzero(self.cell_block != zero_idx))
        return 1.0 - valid / max(self.n_cells, 1)

    def slice_imbalance(self) -> float:
        """Mean relative deviation of per-slice padded width (Eq. 5 applied
        at slice granularity): 0 = every slice does identical work."""
        w = self.slice_widths.astype(np.float64)
        mean = w.mean() if w.size else 0.0
        if mean <= 0:
            return 0.0
        return float(np.mean(np.abs(w - mean)) / mean)

    @classmethod
    def from_bsr(cls, bsr: BSR, slice_height: int = 8, sigma: int = 64) -> "SELLBSR":
        C = max(int(slice_height), 1)
        sg = max(int(sigma), 1)
        n_br = bsr.n_block_rows
        bs = bsr.block_size
        bpr = bsr.blocks_per_row()
        row_perm, slice_widths = sell_layout(bpr, C, sg)

        # Flat cell schedule: sorted row p owns width(slice(p)) consecutive
        # cells; slot j beyond the row's real blocks points at the zero block.
        cells_per_row = np.repeat(slice_widths, C)[:n_br]
        starts = np.concatenate([[0], np.cumsum(cells_per_row)])
        n_cells = int(starts[-1])
        cell_row = np.repeat(np.arange(n_br, dtype=np.int64), cells_per_row)
        slot = np.arange(n_cells, dtype=np.int64) - np.repeat(starts[:-1],
                                                              cells_per_row)
        orig = row_perm[cell_row].astype(np.int64)
        valid = slot < bpr[orig]
        pos = bsr.block_ptrs[orig] + slot
        zero_idx = bsr.n_blocks
        cell_block = np.where(valid, pos, zero_idx).astype(np.int32)
        if bsr.n_blocks:
            cell_col = np.where(
                valid, bsr.block_cols[np.minimum(pos, bsr.n_blocks - 1)], 0
            ).astype(np.int32)
        else:
            cell_col = np.zeros(n_cells, dtype=np.int32)
        blocks = np.concatenate(
            [bsr.blocks, np.zeros((1, bs, bs), np.float32)], axis=0)
        return cls(cell_block, cell_col, cell_row.astype(np.int32), row_perm,
                   slice_widths.astype(np.int32), blocks, bsr.shape, bs, C, sg)


# ----------------------------------------------------------------- oracles

def _row_ids(csr: CSR) -> np.ndarray:
    return np.repeat(np.arange(csr.n_rows, dtype=np.int64), csr.row_lengths())


def spmv_oracle(csr: CSR, x: np.ndarray) -> np.ndarray:
    """float64 ``y = A @ x`` straight from the CSR arrays (no densify):
    per-nnz products summed per row with ``bincount``."""
    x = np.asarray(x, np.float64)
    prods = csr.nnz_vals.astype(np.float64) * x[csr.col_idxs.astype(np.int64)]
    return np.bincount(_row_ids(csr), weights=prods, minlength=csr.n_rows)


def spmm_oracle(csr: CSR, X: np.ndarray) -> np.ndarray:
    """float64 multi-RHS ``Y = A @ X`` (X is (n_cols, k)) without densifying
    A: per-nnz rows of X scaled and summed per row with ``np.add.reduceat``
    over the nonempty rows."""
    X = np.asarray(X, np.float64)
    out = np.zeros((csr.n_rows, X.shape[1]), np.float64)
    if csr.nnz == 0:
        return out
    prods = (csr.nnz_vals.astype(np.float64)[:, None]
             * X[csr.col_idxs.astype(np.int64)])
    lens = csr.row_lengths()
    nonempty = np.flatnonzero(lens)
    starts = np.asarray(csr.row_ptrs, np.int64)[nonempty]
    out[nonempty] = np.add.reduceat(prods, starts, axis=0)
    return out
