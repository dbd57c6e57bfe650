"""Wrapper of the online-softmax attention CUDA kernel
(``csrc/flash_attention.cu``), the port of
``repro.kernels.flash_attention.kernel``.

``softmax(q k^T / sqrt(D) [causal]) v`` over (BH, S, D) q, k, v in float32
or bfloat16 (one dtype for all three), out in float32; GQA expansion is
the caller's, as in the JAX package. On CUDA tensors the wrapper checks
device, dtype, shape, contiguity, alignment and the tiling contract,
launches on the current stream, adds one to its launch count and raises if
the launch failed. It never falls back: on CPU tensors, and only there, it
computes the plain PyTorch version (``ref.py``) and counts nothing.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from .. import _build
from ..common import launch_stream, raise_on_launch_error
from . import ref

# Launches of the kernel: a plain int, raised by one per launch.
LAUNCHES: Dict[str, int] = {"flash_attention": 0}

MAX_HEAD_DIM = 256      # the kernel's shared memory holds q, k, v tiles
MAX_GRID = 2**31 - 1    # CTAs in the kernel's flat grid over (q tile, bh)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _P]


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def cta_rows(d: int) -> int:
    """q rows per CTA at head dim ``d`` (``dispatch`` in the .cu): two
    warpgroups of 64 rows up to D = 128, one above."""
    return 128 if d <= 128 else 64


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 block_q: int, block_k: int) -> None:
    """(BH, S, D) operands of one shape, and the JAX kernel's contract
    that S divides by its (TPU) block sizes; the CUDA tiling is its own."""
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("flash_attention: q, k, v must be (BH, S, D) of "
                         f"one shape; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    s = q.shape[1]
    if s % block_q or s % block_k:
        raise ValueError(f"flash_attention: S={s} must divide by "
                         f"block_q={block_q} and block_k={block_k}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, block_q: int = 128,
                         block_k: int = 128) -> torch.Tensor:
    """(BH, S, D) -> (BH, S, D) float32. Replaces
    ``flash_attention_pallas``."""
    name = "flash_attention"
    check_shapes(q, k, v, block_q, block_k)
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return ref.ref_attention(q, k, v, causal=causal)
    for key, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.device.type != "cuda":
            raise ValueError(f"{name}: {key} is on {t.device}; every "
                             "operand must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if t.dtype not in DTYPES or t.dtype != q.dtype:
            raise TypeError(f"{name}: q, k, v must all be float32 or all "
                            f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
        # the kernel loads 4 elements at a time
        if t.data_ptr() % (4 * t.element_size()):
            raise ValueError(f"{name}: {key} must be aligned to 4 elements")
    bh, s, d = q.shape
    if d % 4 or not 4 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {d} is not a multiple of 4 up "
                         f"to {MAX_HEAD_DIM}")
    n_tiles = -(-s // cta_rows(d))
    if n_tiles * bh > MAX_GRID:
        raise ValueError(f"{name}: {bh} (batch x heads) x {n_tiles} q tiles "
                         f"exceed the grid's {MAX_GRID} CTAs")
    out = torch.empty((bh, s, d), dtype=torch.float32, device=q.device)
    if bh == 0 or s == 0:
        return out
    LAUNCHES[name] += 1
    raise_on_launch_error(name, _build.function(name, name, _ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, s, d,
        1.0 / (d ** 0.5), int(bool(causal)), DTYPES[q.dtype],
        launch_stream(q.device)))
    return out
