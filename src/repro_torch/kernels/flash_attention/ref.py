"""Plain PyTorch version of attention (twin of
``repro.kernels.flash_attention.ref.ref_attention``): exact softmax over
the whole score matrix, ``softmax(q k^T / sqrt(D) [causal]) v``.

Inputs in float32 or bfloat16 are computed in float32 and the result is
float32, as the kernel's. The (BH, S, S) scores are formed a few heads at
a time, each group holding about ``CHUNK_BYTES`` of scores. On the card
this runs only to check the kernel; keep
``torch.backends.cuda.matmul.allow_tf32 = False`` there (the default).
"""
from __future__ import annotations

import torch

CHUNK_BYTES = 1 << 30


def ref_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True) -> torch.Tensor:
    """(BH, S, D) q, k, v -> (BH, S, D) float32."""
    bh, s, d = q.shape
    out = torch.empty((bh, s, d), dtype=torch.float32, device=q.device)
    mask = (torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
            if causal else None)
    step = max(1, CHUNK_BYTES // (s * s * 4))
    for b0 in range(0, bh, step):
        sl = slice(b0, b0 + step)
        scores = q[sl].float() @ k[sl].float().transpose(1, 2) / (d ** 0.5)
        if mask is not None:
            scores = scores.masked_fill(~mask, float("-inf"))
        out[sl] = torch.softmax(scores, dim=-1) @ v[sl].float()
    return out
