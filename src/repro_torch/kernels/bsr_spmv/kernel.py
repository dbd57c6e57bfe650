"""Wrappers of the ELL/SELL-BSR SpMV and SpMM CUDA kernels
(``csrc/bsr_spmv.cu``), the port of ``repro.kernels.bsr_spmv.kernel``.

Each wrapper takes one member (index arrays 2-D for ELL, 1-D for SELL) or a
stacked bucket (one more leading member axis on every argument; the member
runs on the kernel grid, so a whole bucket is one launch). On CUDA tensors
it checks device, dtype, shape, contiguity and alignment, raises on
anything the kernel does not take, launches on the current stream, adds one
to its launch count and raises if the launch failed. It never falls back:
on CPU tensors, and only there, it computes the plain PyTorch version
(``ref.py``), and counts nothing.

The ELL kernels also take ``valid_counts`` (the container's count of real
slots leading each row, (n_br,) or (B, n_br) int32), a required keyword:
they sum those slots and one pad slot per row that has one, which is the
all-slot sum the plain version and the TPU kernel compute. On CPU tensors
it is checked and the plain version sums every slot.

The SELL kernels take ``cell_ptr`` (the (n_br+1,) row pointer of the
nondecreasing ``cell_row``, which gives a member's last sorted row one of
its bucket-pad cells, see ``ops.sell_row_ptr``) and ``row_perm`` and return
rows in ORIGINAL order: the scatter through ``row_perm`` is fused into the
kernel. They also take ``cell_valid`` (the real cells that lead each
sorted row, (n_br,) or (B, n_br) int32), a required keyword: they sum
those cells and one more per row whose range is longer, which is the sum
over the row's whole range that the plain version computes.

A stacked ``x_blocks`` may be one x expanded over the members (member
stride 0, ``x.expand(B, ...)``): the kernel then reads that one x for every
member, with no copy per member.

Every kernel copies ``blocks`` and ``x_blocks`` 16 bytes at a time, so on
the card both must start on 16 bytes.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from .. import _build
from ..common import check_operands
from ..common import launch_stream as _stream
from ..common import raise_on_launch_error as _raise_on
from . import ref

# Launches per kernel: a plain int each, raised by one per launch.
LAUNCHES: Dict[str, int] = {"bsr_spmv_ell": 0, "bsr_spmm_ell": 0,
                            "bsr_spmv_sell": 0, "bsr_spmm_sell": 0}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "bsr_spmv_ell": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _L, _I, _L, _I,
                     _P],
    "bsr_spmm_ell": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _L, _I, _L, _I,
                     _I, _P],
    "bsr_spmv_sell": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _L, _L, _I,
                      _L, _I, _P],
    "bsr_spmm_sell": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _L, _L, _I,
                      _L, _I, _I, _P],
}
RHS_TILE = 8          # SpMM kernels take k in multiples of this
# One CTA per (block-row, RHS tile, member); below this many CTAs the tile
# rows are split over more CTAs (~8 resident 256-thread CTAs on each of an
# H100's 132 SMs).
TARGET_CTAS = 1024
MIN_ROWS_PER_CTA = 16


def rows_per_cta(bs: int, n_ctas: int) -> int:
    """Tile rows one CTA computes: all ``bs`` when ``n_ctas`` fills the card,
    else ``bs`` halved while that keeps the CTAs under ``TARGET_CTAS`` and
    at least ``MIN_ROWS_PER_CTA`` rows each."""
    split = 1
    while (n_ctas * split * 2 <= TARGET_CTAS and bs % (split * 2) == 0
           and bs // (split * 2) >= MIN_ROWS_PER_CTA):
        split *= 2
    return bs // split


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _fn(name: str):
    return _build.function("bsr_spmv", name, _ARGTYPES[name])


def _blocks_shape(name: str, blocks: torch.Tensor, stacked: bool):
    if blocks.dim() != (4 if stacked else 3) or \
            blocks.shape[-1] != blocks.shape[-2]:
        raise ValueError(f"{name}: blocks must be ({'B, ' if stacked else ''}"
                         f"nb, bs, bs), got {tuple(blocks.shape)}")
    bs = int(blocks.shape[-1])
    if bs % 4 or bs > 256:
        raise ValueError(f"{name}: block size {bs} is not a multiple of 4 "
                         "up to 256")
    return int(blocks.shape[-3]), bs


def _x_shape(name: str, x: torch.Tensor, stacked: bool, multi: bool,
             bs: int):
    lead = 1 if stacked else 0
    if x.dim() != lead + (3 if multi else 2) or x.shape[lead + 1] != bs:
        raise ValueError(f"{name}: x_blocks must be "
                         f"({'B, ' if stacked else ''}n_bc, {bs}"
                         f"{', k' if multi else ''}), got {tuple(x.shape)}")
    k = int(x.shape[-1]) if multi else 1
    if multi and k % RHS_TILE:
        raise ValueError(f"{name}: k={k} must be a multiple of {RHS_TILE} "
                         "(pad the RHS)")
    return int(x.shape[lead]), k


def _member_x(x_blocks: torch.Tensor, stacked: bool):
    """The x the kernel reads and the floats between two members' x. A
    stacked x whose member axis has stride 0 (one x expanded over the
    members, as the row shards of one matrix take it) is read once, with
    stride 0; it is not copied per member."""
    if stacked and x_blocks.stride(0) == 0 and x_blocks.shape[0] > 0:
        return x_blocks[0], 0
    return x_blocks, (x_blocks[0].numel() if stacked else 0)


def _check_counts(name: str, key: str, counts, shape) -> None:
    if counts.shape != shape or counts.dtype != torch.int32:
        raise ValueError(f"{name}: {key} must be int32 of shape "
                         f"{tuple(shape)}, got {counts.dtype} "
                         f"{tuple(counts.shape)}")


def _ell(name: str, multi: bool, block_indices, block_cols, blocks,
         x_blocks, valid_counts):
    _check_counts(name, "valid_counts", valid_counts,
                  block_indices.shape[:-1])
    if block_indices.device.type == "cpu":
        f = ref.ref_bsr_spmm if multi else ref.ref_bsr_spmv
        return f(block_indices, block_cols, blocks, x_blocks)
    stacked = block_indices.dim() == 3
    x_dev, x_stride = _member_x(x_blocks, stacked)
    check_operands(name, {"block_indices": block_indices,
                          "block_cols": block_cols,
                          "valid_counts": valid_counts, "blocks": blocks,
                          "x_blocks": x_dev},
                   ints=("block_indices", "block_cols", "valid_counts"),
                   aligned=("blocks", "x_blocks"))
    if block_indices.dim() != (3 if stacked else 2) or \
            block_cols.shape != block_indices.shape:
        raise ValueError(f"{name}: block_indices/block_cols must be "
                         "(n_br, mb) or (B, n_br, mb) and equal")
    nb, bs = _blocks_shape(name, blocks, stacked)
    _, k = _x_shape(name, x_blocks, stacked, multi, bs)
    n_mem = int(block_indices.shape[0]) if stacked else 1
    if stacked and (blocks.shape[0] != n_mem or x_blocks.shape[0] != n_mem):
        raise ValueError(f"{name}: member axes disagree")
    n_br, mb = (int(s) for s in block_indices.shape[-2:])
    lead = (n_mem,) if stacked else ()
    y = torch.empty(lead + (n_br, bs) + ((k,) if multi else ()),
                    dtype=torch.float32, device=blocks.device)
    if n_br == 0:
        return y
    rows = rows_per_cta(bs, n_br * (k // RHS_TILE if multi else 1) * n_mem)
    args = [block_indices.data_ptr(), block_cols.data_ptr(),
            valid_counts.data_ptr(), blocks.data_ptr(), x_dev.data_ptr(),
            y.data_ptr(), n_mem, n_br, mb, nb, bs, x_stride] + \
        ([k] if multi else []) + [rows, _stream(blocks.device)]
    LAUNCHES[name] += 1
    _raise_on(name, _fn(name)(*args))
    return y


def _sell(name: str, multi: bool, cell_block, cell_col, cell_ptr, row_perm,
          blocks, x_blocks, cell_valid):
    _check_counts(name, "cell_valid", cell_valid, row_perm.shape)
    if cell_block.device.type == "cpu":
        f = ref.ref_bsr_spmm_sell_perm if multi else ref.ref_bsr_spmv_sell_perm
        return f(cell_block, cell_col, cell_ptr, row_perm, blocks, x_blocks)
    stacked = cell_block.dim() == 2
    x_dev, x_stride = _member_x(x_blocks, stacked)
    check_operands(name, {"cell_block": cell_block, "cell_col": cell_col,
                          "cell_ptr": cell_ptr, "cell_valid": cell_valid,
                          "row_perm": row_perm, "blocks": blocks,
                          "x_blocks": x_dev},
                   ints=("cell_block", "cell_col", "cell_ptr", "row_perm",
                         "cell_valid"),
                   aligned=("blocks", "x_blocks"))
    lead = 1 if stacked else 0
    if cell_block.dim() != lead + 1 or cell_col.shape != cell_block.shape \
            or cell_ptr.dim() != lead + 1 or row_perm.dim() != lead + 1 \
            or cell_ptr.shape[-1] != row_perm.shape[-1] + 1:
        raise ValueError(f"{name}: expected cell_block/cell_col (n_cells,), "
                         "cell_ptr (n_br+1,), row_perm (n_br,), each with "
                         "the same optional member axis")
    nb, bs = _blocks_shape(name, blocks, stacked)
    _, k = _x_shape(name, x_blocks, stacked, multi, bs)
    n_mem = int(cell_block.shape[0]) if stacked else 1
    if stacked and any(t.shape[0] != n_mem for t in
                       (cell_ptr, row_perm, blocks, x_blocks)):
        raise ValueError(f"{name}: member axes disagree")
    n_br, n_cells = int(row_perm.shape[-1]), int(cell_block.shape[-1])
    shape = ((n_mem,) if stacked else ()) + (n_br, bs) + \
        ((k,) if multi else ())
    y = torch.empty(shape, dtype=torch.float32, device=blocks.device)
    if n_br == 0:
        return y
    args = [cell_block.data_ptr(), cell_col.data_ptr(), cell_ptr.data_ptr(),
            cell_valid.data_ptr(), row_perm.data_ptr(), blocks.data_ptr(),
            x_dev.data_ptr(), y.data_ptr(), n_mem, n_br, n_cells, nb, bs,
            x_stride] + ([k] if multi else []) + \
        [rows_per_cta(bs, n_br * (k // RHS_TILE if multi else 1) * n_mem),
         _stream(blocks.device)]
    LAUNCHES[name] += 1
    _raise_on(name, _fn(name)(*args))
    return y


def bsr_spmv_cuda(block_indices, block_cols, blocks, x_blocks, *,
                  valid_counts):
    """y = A @ x, A in ELL-BSR: (n_br, mb) indices, (nb, bs, bs) blocks,
    x_blocks (n_bc, bs), valid_counts (n_br,) int32, the real slots that
    lead each row -> (n_br, bs). Replaces ``bsr_spmv_pallas``."""
    return _ell("bsr_spmv_ell", False, block_indices, block_cols, blocks,
                x_blocks, valid_counts)


def bsr_spmm_cuda(block_indices, block_cols, blocks, x_blocks, *,
                  valid_counts):
    """Y = A @ X, A in ELL-BSR, x_blocks (n_bc, bs, k), k a multiple of 8,
    valid_counts as for ``bsr_spmv_cuda`` -> (n_br, bs, k). Replaces
    ``bsr_spmm_pallas``."""
    return _ell("bsr_spmm_ell", True, block_indices, block_cols, blocks,
                x_blocks, valid_counts)


def bsr_spmv_sell_cuda(cell_block, cell_col, cell_ptr, row_perm, blocks,
                       x_blocks, *, cell_valid):
    """y = A @ x, A in SELL-BSR, rows in original order -> (n_br, bs);
    ``cell_valid`` (n_br,) int32 is the real cells that lead each sorted
    row. Replaces ``bsr_spmv_sell_pallas`` and the ``row_perm`` scatter
    after it."""
    return _sell("bsr_spmv_sell", False, cell_block, cell_col, cell_ptr,
                 row_perm, blocks, x_blocks, cell_valid)


def bsr_spmm_sell_cuda(cell_block, cell_col, cell_ptr, row_perm, blocks,
                       x_blocks, *, cell_valid):
    """Multi-RHS form of ``bsr_spmv_sell_cuda``: x_blocks (n_bc, bs, k), k a
    multiple of 8 -> (n_br, bs, k). Replaces ``bsr_spmm_sell_pallas``."""
    return _sell("bsr_spmm_sell", True, cell_block, cell_col, cell_ptr,
                 row_perm, blocks, x_blocks, cell_valid)
