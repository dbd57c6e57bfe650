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

from typing import Tuple

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


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32's 10 mantissa bits, to nearest with
    ties away from zero, as ``cvt.rna.tf32.f32`` rounds it; non-finite
    values pass unchanged."""
    bits = x.float().contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    return torch.where(torch.isfinite(x), rounded, bits).view(torch.float32)


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x = hi + lo`` with both parts TF32 (``hi = to_tf32(x)``, ``lo =
    to_tf32(x - hi)``): the split the kernel applies to each float32
    operand, so that ``a.b ~ hi_a.hi_b + hi_a.lo_b + lo_a.hi_b`` keeps
    about fp32 accuracy on TF32 tensor cores. Only the tests call it."""
    hi = to_tf32(x)
    return hi, to_tf32(x.float() - hi)
