"""Plain PyTorch version of the grouped GEMM (twin of
``repro.kernels.moe_gmm.ref.ref_gmm``):
``out[t*tm:(t+1)*tm] = x[t*tm:(t+1)*tm] @ w[tile_expert[t]]``.

The JAX reference gathers ``w[token_expert]``, an (M, K, N) array: about
400 GB at mixtral-8x22b width. Here each run of consecutive tiles with one
expert (x is sorted by expert, so each expert's rows are one run) is one
``torch.matmul`` of its rows with that expert's weight. Inputs in float32
or bfloat16 are multiplied in float32 and the result is float32, as the
kernel's. On the card this runs only to check the kernel; keep
``torch.backends.cuda.matmul.allow_tf32 = False`` there (the default).
"""
from __future__ import annotations

import numpy as np
import torch


def expert_runs(tile_expert: torch.Tensor):
    """(first tile, tile count, expert) of each run of equal consecutive
    entries of ``tile_expert``."""
    te = tile_expert.cpu().numpy().astype(np.int64)
    if te.size == 0:
        return []
    starts = np.flatnonzero(np.diff(te, prepend=te[0] - 1))
    ends = np.append(starts[1:], te.size)
    return [(int(s), int(e - s), int(te[s])) for s, e in zip(starts, ends)]


def live_row_ends(tile_expert: torch.Tensor, x: torch.Tensor,
                  tile_m: int = 128) -> torch.Tensor:
    """(M/tile_m,) int32: 1 + the last row of each tile that holds an
    element other than +-0 (NaN counts), 0 for an all-zero tile. The rows
    at or past it are zero rows, whose product with the tile's expert is
    the same row for all of them: what the CUDA kernel's scan finds."""
    n_tiles = x.shape[0] // tile_m
    if tile_expert.shape[0] != n_tiles:
        raise ValueError(f"{tile_expert.shape[0]} tile experts for "
                         f"{n_tiles} row tiles")
    live = (x != 0).any(dim=1).view(n_tiles, tile_m)
    rows = torch.arange(1, tile_m + 1, dtype=torch.int32, device=x.device)
    return (live * rows).amax(dim=1).to(torch.int32)


def ref_gmm(tile_expert: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
            tile_m: int = 128) -> torch.Tensor:
    """(M/tile_m,) experts, x (M, K), w (E, K, N) -> (M, N) float32."""
    out = torch.empty((x.shape[0], w.shape[2]), dtype=torch.float32,
                      device=x.device)
    for t0, n_t, e in expert_runs(tile_expert):
        rows = slice(t0 * tile_m, (t0 + n_t) * tile_m)
        out[rows] = x[rows].float() @ w[e].float()
    return out
