"""Wrapper of the grouped-GEMM CUDA kernel (``csrc/moe_gmm.cu``), the port
of ``repro.kernels.moe_gmm.kernel``.

``out[t*tm:(t+1)*tm] = x[t*tm:(t+1)*tm] @ w[tile_expert[t]]``, x and w in
float32 or bfloat16 (the same for both), out in float32, for every row,
whatever it holds. On the card one call is three launches on the current
stream: a scan of x for each tile's live rows (``ref.live_row_ends``), a
CUDA-core path for tiles of at most ``SKINNY_ROWS`` live rows (decode) and
a split-TF32 ``wgmma`` path for the others (prefill); the rows past a
tile's live rows get the zero-row product of its expert. The live rows
stay on the device: the wrapper never reads anything back and never
synchronizes. On CUDA tensors it checks device, dtype, shape, contiguity
and the tiling contract, launches, adds one to its launch count and raises
if a launch failed. It never falls back: on CPU tensors, and only there,
it computes the plain PyTorch version (``ref.py``) and counts nothing.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from .. import _build
from ..common import launch_stream, raise_on_launch_error
from . import ref

# Launches of the kernel: a plain int, raised by one per launch.
LAUNCHES: Dict[str, int] = {"moe_gmm": 0}

# The CUDA row sub-tile: it must divide tile_m.
ROW_SUBTILE = 32
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The kernel's dispatch (``csrc/moe_gmm.cu``): a tile of at most
# SKINNY_ROWS live rows runs on CUDA cores over the smallest of
# SKINNY_BUCKETS rows that holds them; a larger one as wgmma over whole
# 64-row warpgroups.
SKINNY_ROWS = 16
SKINNY_BUCKETS = (4, 8, 16)
WARPGROUP_ROWS = 64

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P, _P, _P, _P, _P, _L, _L, _L, _L, _I, _I, _P]


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def computed_rows(live_end, tile_m: int) -> int:
    """Rows the CUDA kernel runs as products for tiles with these live-row
    ends (the rest get the zero-row product): at most ``SKINNY_ROWS``
    live rows take their bucket, more take whole 64-row warpgroups."""
    total = 0
    for live in (int(v) for v in live_end):
        if live <= SKINNY_ROWS:
            total += next(b for b in SKINNY_BUCKETS if live <= b)
        else:
            total += min(tile_m, -(-live // WARPGROUP_ROWS) * WARPGROUP_ROWS)
    return total


def check_tiling(m: int, k: int, n: int, tile_m: int, tile_n: int,
                 tile_k: int) -> None:
    """The JAX kernel's contract on its (TPU VMEM) tile sizes, kept as a
    check on both paths; the CUDA tiling is its own."""
    if m % tile_m or k % tile_k or n % tile_n:
        raise ValueError(f"moe_gmm: M={m}, K={k}, N={n} must divide by "
                         f"tile_m={tile_m}, tile_k={tile_k}, "
                         f"tile_n={tile_n}")


def moe_gmm_cuda(tile_expert: torch.Tensor, x: torch.Tensor,
                 w: torch.Tensor, tile_m: int = 128, tile_n: int = 128,
                 tile_k: int = 128) -> torch.Tensor:
    """(M/tile_m,) int32 experts, x (M, K), w (E, K, N) -> (M, N) float32.
    Replaces ``moe_gmm_pallas``. The experts are not read back to the host
    here: a tile whose expert lies outside [0, E) comes out NaN on the card
    (and raises IndexError on the CPU); the planner checks them."""
    name = "moe_gmm"
    if x.dim() != 2 or w.dim() != 3 or tile_expert.dim() != 1 \
            or w.shape[1] != x.shape[1]:
        raise ValueError(f"{name}: expected tile_expert (M/tile_m,), x "
                         f"(M, K), w (E, K, N); got {tuple(tile_expert.shape)}"
                         f", {tuple(x.shape)}, {tuple(w.shape)}")
    m, k = x.shape
    n = w.shape[2]
    check_tiling(m, k, n, tile_m, tile_n, tile_k)
    if tile_expert.shape[0] != m // tile_m:
        raise ValueError(f"{name}: {tile_expert.shape[0]} tile experts for "
                         f"{m // tile_m} row tiles")
    if x.device.type == "cpu" and w.device.type == "cpu" \
            and tile_expert.device.type == "cpu":
        return ref.ref_gmm(tile_expert, x, w, tile_m=tile_m)
    for key, t in (("tile_expert", tile_expert), ("x", x), ("w", w)):
        if t.device != x.device or t.device.type != "cuda":
            raise ValueError(f"{name}: {key} is on {t.device}; every "
                             "operand must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    if tile_expert.dtype != torch.int32:
        raise TypeError(f"{name}: tile_expert must be int32, got "
                        f"{tile_expert.dtype}")
    if x.dtype not in DTYPES or w.dtype != x.dtype:
        raise TypeError(f"{name}: x and w must both be float32 or both "
                        f"bfloat16, got {x.dtype} and {w.dtype}")
    if tile_m % ROW_SUBTILE:
        raise ValueError(f"{name}: tile_m={tile_m} is not a multiple of the "
                         f"CUDA row sub-tile {ROW_SUBTILE}")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0:
        return out
    live_end = torch.empty(m // tile_m, dtype=torch.int32, device=x.device)
    LAUNCHES[name] += 1
    raise_on_launch_error(name, _build.function(name, name, _ARGTYPES)(
        tile_expert.data_ptr(), live_end.data_ptr(), x.data_ptr(),
        w.data_ptr(), out.data_ptr(), m, w.shape[0], k, n, tile_m,
        DTYPES[x.dtype], launch_stream(x.device)))
    return out
