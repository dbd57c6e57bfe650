"""Plain PyTorch versions of the ELL/SELL-BSR SpMV and SpMM kernels (twins
of ``repro.kernels.bsr_spmv.ref``): gather + ``einsum``, and ``index_add_``
for the SELL segment sum. Each takes an optional leading member axis: with
``blocks`` of shape (B, nb, bs, bs) every other argument carries the same
leading B and member b is computed from its own arrays.

On the card these run only to check the kernels; set
``torch.backends.cuda.matmul.allow_tf32 = False`` there (the default) so
the einsum stays in full fp32 like the reference.
"""
from __future__ import annotations

import torch


def _member_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[b][idx[b]]`` for every member b (table (B, n, ...), idx
    (B, ...)) as one gather."""
    b = torch.arange(table.shape[0], device=table.device)
    b = b.view((-1,) + (1,) * (idx.dim() - 1))
    return table[b, idx.long()]


def ref_bsr_spmv(block_indices, block_cols, blocks, x_blocks):
    """y[i] = sum_j blocks[idx[i, j]] @ x_blocks[cols[i, j]]."""
    if blocks.dim() == 4:
        a = _member_gather(blocks, block_indices)
        xs = _member_gather(x_blocks, block_cols)
        return torch.einsum("brmij,brmj->bri", a, xs)
    a = blocks[block_indices.long()]
    xs = x_blocks[block_cols.long()]
    return torch.einsum("rmij,rmj->ri", a, xs)


def ref_bsr_spmm(block_indices, block_cols, blocks, x_blocks):
    """Y[i] = sum_j blocks[idx[i, j]] @ x_blocks[cols[i, j]] (multi-RHS)."""
    if blocks.dim() == 4:
        a = _member_gather(blocks, block_indices)
        xs = _member_gather(x_blocks, block_cols)
        return torch.einsum("brmij,brmjk->brik", a, xs)
    a = blocks[block_indices.long()]
    xs = x_blocks[block_cols.long()]
    return torch.einsum("rmij,rmjk->rik", a, xs)


def _segment_sum(prods, cell_row, n_block_rows):
    out = prods.new_zeros((n_block_rows,) + tuple(prods.shape[1:]))
    return out.index_add_(0, cell_row.long(), prods)


def _sell(eq, cell_block, cell_col, cell_row, blocks, x_blocks,
          n_block_rows):
    if blocks.dim() == 4:
        ins, out = eq.split("->")
        eq = ",".join("b" + s for s in ins.split(",")) + "->b" + out
        prods = torch.einsum(eq, _member_gather(blocks, cell_block),
                             _member_gather(x_blocks, cell_col))
        return torch.stack([_segment_sum(p, r, n_block_rows)
                            for p, r in zip(prods, cell_row)])
    prods = torch.einsum(eq, blocks[cell_block.long()],
                         x_blocks[cell_col.long()])
    return _segment_sum(prods, cell_row, n_block_rows)


def ref_bsr_spmv_sell(cell_block, cell_col, cell_row, blocks, x_blocks,
                      n_block_rows: int):
    """y_sorted[r] = sum over cells t with cell_row[t] == r of
    blocks[cell_block[t]] @ x_blocks[cell_col[t]]."""
    return _sell("tij,tj->ti", cell_block, cell_col, cell_row, blocks,
                 x_blocks, n_block_rows)


def ref_bsr_spmm_sell(cell_block, cell_col, cell_row, blocks, x_blocks,
                      n_block_rows: int):
    """Multi-RHS form of ``ref_bsr_spmv_sell``: x_blocks is (n_bc, bs, k)."""
    return _sell("tij,tjk->tik", cell_block, cell_col, cell_row, blocks,
                 x_blocks, n_block_rows)


def cell_rows(cell_ptr, n_cells: int):
    """The sorted row each cell belongs to under the SELL row pointer
    (row r owns cells ``cell_ptr[r]:cell_ptr[r+1]``); a cell past
    ``cell_ptr[-1]`` belongs to no row and gets id ``n_br``. (n_br+1,) ->
    (n_cells,), or member-stacked (B, n_br+1) -> (B, n_cells)."""
    t = torch.arange(n_cells, device=cell_ptr.device, dtype=cell_ptr.dtype)
    if cell_ptr.dim() == 2:
        t = t.expand(cell_ptr.shape[0], -1).contiguous()
    return torch.searchsorted(cell_ptr, t, right=True) - 1


def _unpermute(ys, row_perm):
    """y[row_perm[r]] = ys[r] (per member when stacked)."""
    y = torch.zeros_like(ys)
    if row_perm.dim() == 1:
        y[row_perm.long()] = ys
        return y
    for b in range(ys.shape[0]):
        y[b, row_perm[b].long()] = ys[b]
    return y


def ref_bsr_spmv_sell_perm(cell_block, cell_col, cell_ptr, row_perm, blocks,
                           x_blocks):
    """The SELL CUDA kernels' exact function: the sorted segment sum over
    the cells ``cell_ptr`` assigns to each row, scattered back to original
    row order through ``row_perm``."""
    n_br = row_perm.shape[-1]
    ys = ref_bsr_spmv_sell(cell_block, cell_col,
                           cell_rows(cell_ptr, cell_block.shape[-1]),
                           blocks, x_blocks, n_br + 1)
    return _unpermute(ys[..., :n_br, :], row_perm)


def ref_bsr_spmm_sell_perm(cell_block, cell_col, cell_ptr, row_perm, blocks,
                           x_blocks):
    """Multi-RHS form of ``ref_bsr_spmv_sell_perm``."""
    n_br = row_perm.shape[-1]
    ys = ref_bsr_spmm_sell(cell_block, cell_col,
                           cell_rows(cell_ptr, cell_block.shape[-1]),
                           blocks, x_blocks, n_br + 1)
    return _unpermute(ys[..., :n_br, :, :], row_perm)
