"""Host routing for the grouped GEMM (numpy copy of
``repro.kernels.moe_gmm.ops.route_and_pad``) and the ``moe_gmm`` shim."""
from __future__ import annotations

from typing import Tuple

import numpy as np


def route_and_pad(tokens: np.ndarray, expert_of_token: np.ndarray,
                  n_experts: int, tile_m: int = 128
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sort tokens by expert; pad each group to a tile_m multiple.

    Returns (x_sorted_padded (M, K), tile_expert (M/tile_m,),
    inverse_index (M,) with -1 on padding rows) so outputs can be
    scattered back: out_tokens[i] = out_padded[inverse_index == i].
    Every expert, an empty one too, gets at least one tile.
    """
    t, k = tokens.shape
    order = np.argsort(expert_of_token, kind="stable")
    counts = np.bincount(expert_of_token, minlength=n_experts)
    padded_counts = np.maximum(-(-counts // tile_m) * tile_m, tile_m)
    m_total = int(padded_counts.sum())
    x = np.zeros((m_total, k), tokens.dtype)
    inv = np.full(m_total, -1, dtype=np.int64)
    tile_expert = np.repeat(np.arange(n_experts), padded_counts // tile_m)
    offs = np.concatenate([[0], np.cumsum(padded_counts)])
    src = 0
    for e in range(n_experts):
        grp = order[src: src + counts[e]]
        x[offs[e]: offs[e] + counts[e]] = tokens[grp]
        inv[offs[e]: offs[e] + counts[e]] = grp
        src += counts[e]
    return x, tile_expert.astype(np.int32), inv


def moe_gmm(tile_expert, x, w, tile_m: int = 128, tile_n: int = 128,
            tile_k: int = 128, backend: str = "auto", device="cuda"):
    """``out[t*tm:(t+1)*tm] = x[t*tm:(t+1)*tm] @ w[tile_expert[t]]``;
    delegates to ``plan("moe_gmm", (tile_expert,), tile_m=...)``."""
    from ...sparse import plan
    return plan("moe_gmm", (tile_expert,), backend=backend, tile_m=tile_m,
                tile_n=tile_n, tile_k=tile_k,
                device=device).execute(x, w)
