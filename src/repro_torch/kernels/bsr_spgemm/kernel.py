"""Wrappers of the block SpGEMM CUDA kernels (``csrc/bsr_spgemm.cu``), the
port of ``repro.kernels.bsr_spgemm.kernel``.

  pairs  C[k] = sum_p a_blocks[pair_a[k, p]] @ b_blocks[pair_b[k, p]]
         (pair lists padded to max_pairs with the zero-sentinel blocks;
         ``pair_counts``, a required keyword, says how many real pairs
         lead each row, and the kernel multiplies those only: a sentinel
         product is exactly 0)
  cells  C[c] = sum over the cells cell_ptr[c]:cell_ptr[c+1] of
         a_blocks[cell_a[t]] @ b_blocks[cell_b[t]]

``cell_ptr`` is the (n_c+1,) pointer of the nondecreasing ``cell_c``
(``ops.spgemm_cell_ptr``), built over the live cells only. Each wrapper
takes one member or a stacked bucket (one more leading member axis on
every argument; the member runs on the kernel grid, so a whole bucket is
one launch). On CUDA tensors it checks device, dtype, shape, contiguity and
alignment, launches on the current stream, adds one to its launch count
and raises if the launch failed. It never falls back: on CPU tensors, and
only there, it computes the plain PyTorch version (``ref.py``) and counts
nothing.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from .. import _build
from ..common import check_operands, launch_stream, raise_on_launch_error
from . import ref

# Launches per kernel: a plain int each, raised by one per launch.
LAUNCHES: Dict[str, int] = {"bsr_spgemm_pairs": 0, "bsr_spgemm_cells": 0}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# list_a, list_b, pair_counts | cell_ptr, a_blocks, b_blocks, c, n_members,
# n_c, n_list, n_a, n_b, bs, stream
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _I, _L, _L, _L, _L, _I, _P]


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _fn(name: str):
    return _build.function("bsr_spgemm", name, _ARGTYPES)


def _blocks(name: str, a_blocks: torch.Tensor, b_blocks: torch.Tensor,
            stacked: bool):
    lead = 1 if stacked else 0
    if (a_blocks.dim() != lead + 3 or b_blocks.dim() != lead + 3
            or a_blocks.shape[-2:] != b_blocks.shape[-2:]
            or a_blocks.shape[-1] != a_blocks.shape[-2]):
        raise ValueError(f"{name}: a_blocks/b_blocks must be "
                         f"({'B, ' if stacked else ''}n, bs, bs) with one "
                         f"bs, got {tuple(a_blocks.shape)} and "
                         f"{tuple(b_blocks.shape)}")
    bs = int(a_blocks.shape[-1])
    if bs % 4 or bs > 256:
        raise ValueError(f"{name}: block size {bs} is not a multiple of 4 "
                         "up to 256")
    return bs


def _launch(name: str, list_a, list_b, count_or_ptr, a_blocks, b_blocks,
            n_mem: int, n_c: int, n_list: int, bs: int,
            out_lead) -> torch.Tensor:
    c = torch.empty(tuple(out_lead) + (n_c, bs, bs), dtype=torch.float32,
                    device=a_blocks.device)
    if n_c == 0:
        return c
    LAUNCHES[name] += 1
    raise_on_launch_error(name, _fn(name)(
        list_a.data_ptr(), list_b.data_ptr(), count_or_ptr.data_ptr(),
        a_blocks.data_ptr(), b_blocks.data_ptr(), c.data_ptr(), n_mem, n_c,
        n_list, int(a_blocks.shape[-3]), int(b_blocks.shape[-3]), bs,
        launch_stream(a_blocks.device)))
    return c


def bsr_spgemm_pairs_cuda(pair_a: torch.Tensor, pair_b: torch.Tensor,
                          a_blocks: torch.Tensor, b_blocks: torch.Tensor, *,
                          pair_counts: torch.Tensor) -> torch.Tensor:
    """(n_c, max_pairs) int32 pairs into (n_a+1, bs, bs) / (n_b+1, bs, bs)
    float32 blocks, and (n_c,) int32 ``pair_counts`` (the real pairs that
    lead each row) -> (n_c, bs, bs), each with an optional leading member
    axis. Replaces ``bsr_spgemm_pallas``."""
    name = "bsr_spgemm_pairs"
    if (pair_counts.shape != pair_a.shape[:-1]
            or pair_counts.dtype != torch.int32):
        raise ValueError(f"{name}: pair_counts must be int32 of shape "
                         f"{tuple(pair_a.shape[:-1])}, got "
                         f"{pair_counts.dtype} {tuple(pair_counts.shape)}")
    if pair_a.device.type == "cpu":
        return ref.ref_pair_gemm(pair_a, pair_b, a_blocks, b_blocks)
    check_operands(name, {"pair_a": pair_a, "pair_b": pair_b,
                          "pair_counts": pair_counts, "a_blocks": a_blocks,
                          "b_blocks": b_blocks},
                   ints=("pair_a", "pair_b", "pair_counts"),
                   aligned=("a_blocks", "b_blocks"))
    stacked = pair_a.dim() == 3
    if pair_a.dim() not in (2, 3) or pair_b.shape != pair_a.shape:
        raise ValueError(f"{name}: pair_a/pair_b must be (n_c, max_pairs) "
                         "or (B, n_c, max_pairs) and equal")
    bs = _blocks(name, a_blocks, b_blocks, stacked)
    n_mem = int(pair_a.shape[0]) if stacked else 1
    if stacked and (a_blocks.shape[0] != n_mem or b_blocks.shape[0] != n_mem):
        raise ValueError(f"{name}: member axes disagree")
    n_c, mp = (int(s) for s in pair_a.shape[-2:])
    return _launch(name, pair_a, pair_b, pair_counts, a_blocks, b_blocks,
                   n_mem, n_c, mp, bs, pair_a.shape[:-2])


def bsr_spgemm_cells_cuda(cell_a: torch.Tensor, cell_b: torch.Tensor,
                          cell_ptr: torch.Tensor, a_blocks: torch.Tensor,
                          b_blocks: torch.Tensor) -> torch.Tensor:
    """(n_cells,) int32 cells and the (n_c+1,) int32 ``cell_ptr`` ->
    (n_c, bs, bs), each with an optional leading member axis. Replaces
    ``bsr_spgemm_cells_pallas``."""
    name = "bsr_spgemm_cells"
    if cell_a.device.type == "cpu":
        return ref.ref_cell_gemm_ptr(cell_a, cell_b, cell_ptr, a_blocks,
                                     b_blocks)
    check_operands(name, {"cell_a": cell_a, "cell_b": cell_b,
                          "cell_ptr": cell_ptr, "a_blocks": a_blocks,
                          "b_blocks": b_blocks},
                   ints=("cell_a", "cell_b", "cell_ptr"),
                   aligned=("a_blocks", "b_blocks"))
    stacked = cell_a.dim() == 2
    lead = 1 if stacked else 0
    if (cell_a.dim() != lead + 1 or cell_b.shape != cell_a.shape
            or cell_ptr.dim() != lead + 1 or cell_ptr.shape[-1] < 1):
        raise ValueError(f"{name}: expected cell_a/cell_b (n_cells,) and "
                         "cell_ptr (n_c+1,), each with the same optional "
                         "member axis")
    bs = _blocks(name, a_blocks, b_blocks, stacked)
    n_mem = int(cell_a.shape[0]) if stacked else 1
    if stacked and any(t.shape[0] != n_mem
                       for t in (cell_ptr, a_blocks, b_blocks)):
        raise ValueError(f"{name}: member axes disagree")
    return _launch(name, cell_a, cell_b, cell_ptr, a_blocks, b_blocks, n_mem,
                   int(cell_ptr.shape[-1]) - 1, int(cell_a.shape[-1]), bs,
                   cell_ptr.shape[:-1])
