"""Serving steps: batched prefill and single-token decode (port of
``repro.train.serve_step``).

``prefill_step(batch) -> (next_token_logits, cache)``
``decode_step(cache, token, pos) -> (logits, cache)``

The model holds its parameters (``repro_torch.models.Model``), so the
steps take none; the decode step updates the cache in place.
"""
from __future__ import annotations

from typing import Callable, Optional

from ..models.model import Model


def make_prefill_step(model: Model, *, attn_chunk: int = 1024,
                      cache_len: Optional[int] = None) -> Callable:
    def prefill_step(batch):
        return model.prefill(batch, attn_chunk=attn_chunk,
                             cache_len=cache_len)
    return prefill_step


def make_decode_step(model: Model) -> Callable:
    def decode_step(cache, token, pos):
        return model.decode(cache, token, pos)
    return decode_step
