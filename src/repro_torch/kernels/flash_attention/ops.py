"""The ``flash_attention`` shim (port of
``repro.kernels.flash_attention.ops``)."""
from __future__ import annotations


def flash_attention(q, k, v, causal: bool = True, block_q: int = 128,
                    block_k: int = 128, backend: str = "auto",
                    device="cuda"):
    """(BH, S, D) attention; delegates to
    ``plan("flash_attention", (), causal=...)``."""
    from ...sparse import plan
    return plan("flash_attention", (), backend=backend, causal=causal,
                block_q=block_q, block_k=block_k,
                device=device).execute(q, k, v)
