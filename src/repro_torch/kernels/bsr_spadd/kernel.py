"""Wrapper of the block-union SpADD CUDA kernel (``csrc/bsr_spadd.cu``),
the port of ``repro.kernels.bsr_spadd.kernel``.

``C.blocks[k] = a_blocks[ia[k]] + b_blocks[ib[k]]``. ``sentinels``, a
required keyword, holds each member's ``(zero_a, zero_b)``: the index of
its zeros sentinel in ``a_blocks`` and ``b_blocks``, where every block at or
past it is +0.0. The kernel reads no such block: it adds +0.0 in its place.
One member, or a stacked bucket with one more leading member axis on every
argument (the member runs on the kernel grid, so a whole bucket is one
launch). On CUDA tensors the wrapper checks
device, dtype, shape, contiguity and alignment, launches on the current
stream, adds one to its launch count and raises if the launch failed. It
never falls back: on CPU tensors, and only there, it computes the plain
PyTorch version (``ref.py``) and counts nothing.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from .. import _build
from ..common import check_operands, launch_stream, raise_on_launch_error
from . import ref

# Launches of the kernel: a plain int, raised by one per launch.
LAUNCHES: Dict[str, int] = {"bsr_spadd": 0}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# ia, ib, sentinels, a_blocks, b_blocks, c, n_members, n_c, n_a, n_b, bs,
# stream
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _I, _L, _L, _L, _I, _P]


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _fn():
    return _build.function("bsr_spadd", "bsr_spadd", _ARGTYPES)


def bsr_spadd_cuda(ia: torch.Tensor, ib: torch.Tensor,
                   a_blocks: torch.Tensor, b_blocks: torch.Tensor, *,
                   sentinels: torch.Tensor) -> torch.Tensor:
    """(n_c,) int32 indices into (n_a+1, bs, bs) / (n_b+1, bs, bs) float32
    blocks, and the (2,) int32 ``sentinels`` ``(zero_a, zero_b)`` -> (n_c,
    bs, bs); each with an optional leading member axis. Replaces
    ``bsr_spadd_pallas``."""
    name = "bsr_spadd"
    want = tuple(ia.shape[:-1]) + (2,)
    if tuple(sentinels.shape) != want or sentinels.dtype != torch.int32:
        raise ValueError(f"{name}: sentinels must be int32 of shape {want}, "
                         f"got {sentinels.dtype} {tuple(sentinels.shape)}")
    if ia.device.type == "cpu":
        return ref.ref_block_union_add(ia, ib, a_blocks, b_blocks)
    check_operands(name, {"ia": ia, "ib": ib, "sentinels": sentinels,
                          "a_blocks": a_blocks, "b_blocks": b_blocks},
                   ints=("ia", "ib", "sentinels"),
                   aligned=("a_blocks", "b_blocks"))
    stacked = a_blocks.dim() == 4
    lead = 1 if stacked else 0
    if (a_blocks.dim() != lead + 3 or b_blocks.dim() != lead + 3
            or ia.dim() != lead + 1 or ib.shape != ia.shape
            or a_blocks.shape[-2:] != b_blocks.shape[-2:]
            or a_blocks.shape[-1] != a_blocks.shape[-2]):
        raise ValueError(f"{name}: expected ia/ib (n_c,), blocks "
                         "(n, bs, bs) with one bs, each with the same "
                         "optional member axis")
    bs = int(a_blocks.shape[-1])
    if bs % 4 or bs > 256:
        raise ValueError(f"{name}: block size {bs} is not a multiple of 4 "
                         "up to 256")
    n_mem = int(ia.shape[0]) if stacked else 1
    if stacked and (a_blocks.shape[0] != n_mem or b_blocks.shape[0] != n_mem):
        raise ValueError(f"{name}: member axes disagree")
    n_c = int(ia.shape[-1])
    c = torch.empty(tuple(ia.shape) + (bs, bs), dtype=torch.float32,
                    device=a_blocks.device)
    if n_c == 0:
        return c
    LAUNCHES[name] += 1
    raise_on_launch_error(name, _fn()(
        ia.data_ptr(), ib.data_ptr(), sentinels.data_ptr(),
        a_blocks.data_ptr(), b_blocks.data_ptr(), c.data_ptr(), n_mem, n_c,
        int(a_blocks.shape[-3]), int(b_blocks.shape[-3]), bs,
        launch_stream(a_blocks.device)))
    return c
