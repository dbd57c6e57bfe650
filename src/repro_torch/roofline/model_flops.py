"""Analytic MODEL_FLOPS per step: 6·N·D (train) / 2·N_active·D (inference),
plus the attention term (port of ``repro.roofline.model_flops``). N from the
model's parameters (``models.count_params``; a ``Model`` on the ``meta``
device gives it at full size without memory), D = tokens processed by the
step.
"""
from __future__ import annotations

from typing import Any

from ..configs.base import ArchConfig, ShapeConfig
from ..models.model import count_params, count_active_params


def _attention_flops(cfg: ArchConfig, seq: int, batch: int, *,
                     backward: bool) -> float:
    """Score+context matmul FLOPs (2 * 2 * B * H * S^2 * Dh, windowed for
    local layers; causal halves it)."""
    total = 0.0
    per_pattern = {}
    for kind in cfg.layer_pattern:
        if kind == "attn":
            kv_span = seq / 2  # causal average
        elif kind in ("local_attn", "swa_attn"):
            kv_span = min(cfg.window, seq / 2)
        else:
            continue
        f = 4.0 * batch * cfg.n_heads * seq * kv_span * cfg.d_head
        per_pattern[kind] = per_pattern.get(kind, 0.0) + f
    total = sum(per_pattern.values()) * cfg.n_groups
    if cfg.is_encdec:
        enc = 4.0 * batch * cfg.n_heads * cfg.encoder_len ** 2 * cfg.d_head
        cross = 4.0 * batch * cfg.n_heads * seq * cfg.encoder_len * cfg.d_head
        total += enc * cfg.encoder_layers + cross * cfg.n_layers
    return total * (3.0 if backward else 1.0)


def model_bytes(cfg: ArchConfig, shape: ShapeConfig, params: Any) -> float:
    """Analytic minimum HBM bytes per step (global): the memory-roofline
    floor. Train: params touched ~6x (fwd read, bwd read, grad write, adam
    m/v read+write) in f32 + one activation save/restore pass. Prefill:
    params once + KV write. Decode: active params once + full cache read."""
    n = count_params(params)
    n_act = count_active_params(cfg, params)
    d = cfg.d_model
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        act = 2 * tokens * d * cfg.n_layers * 2  # save+read residual, bf16
        return 6.0 * n * 4 + act
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        kv = (2 * tokens * cfg.n_kv_heads * cfg.d_head * 2 * cfg.n_layers
              if cfg.n_heads else 0)
        return n_act * 4 + kv + 2 * tokens * d * 2
    # decode: read active params + read the whole KV cache / state once
    cache_bytes = 0.0
    for kind in cfg.layer_pattern:
        if kind == "attn":
            span = shape.seq_len
        elif kind in ("local_attn", "swa_attn"):
            span = min(cfg.window, shape.seq_len)
        elif kind == "ssd":
            cache_bytes += (4 * shape.global_batch * cfg.ssm_heads
                            * cfg.ssm_state * cfg.ssm_head_dim) * cfg.n_groups
            continue
        elif kind == "rglru":
            cache_bytes += 4 * shape.global_batch * (cfg.lru_width or d) \
                * cfg.n_groups
            continue
        else:
            continue
        cache_bytes += (2 * shape.global_batch * span * cfg.n_kv_heads
                        * cfg.d_head * 2) * cfg.n_groups
    return n_act * 4 + cache_bytes


def model_flops(cfg: ArchConfig, shape: ShapeConfig, params: Any) -> float:
    """Useful model FLOPs for one step of the given shape (global)."""
    n_active = count_active_params(cfg, params)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens + _attention_flops(
            cfg, shape.seq_len, shape.global_batch, backward=True)
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens + _attention_flops(
            cfg, shape.seq_len, shape.global_batch, backward=False)
    # decode: one token per sequence; attention reads the whole cache
    tokens = shape.global_batch
    attn = 0.0
    for kind in cfg.layer_pattern:
        if kind == "attn":
            span = shape.seq_len
        elif kind in ("local_attn", "swa_attn"):
            span = min(cfg.window, shape.seq_len)
        else:
            continue
        attn += 4.0 * shape.global_batch * cfg.n_heads * span * cfg.d_head
    attn *= cfg.n_groups
    if cfg.is_encdec:
        attn += (4.0 * shape.global_batch * cfg.n_heads * cfg.encoder_len
                 * cfg.d_head) * cfg.n_layers
    return 2.0 * n_active * tokens + attn
