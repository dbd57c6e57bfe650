"""recurrentgemma-9b [hybrid]: 38L d_model=4096 16H (GQA kv=1) d_ff=12288
vocab=256000 — RG-LRU + local attn, pattern 1 attention per 2 recurrent
blocks [arXiv:2402.19427].

38 layers = 12 x (rglru, rglru, local_attn) + 2 trailing rglru; we tile the
(rglru, rglru, local_attn) pattern over 36 layers and append one final
(rglru, rglru) group by using pattern length 19 over 2 groups — instead we
keep the published 1:2 ratio with 36 pattern layers + 2 recurrent layers by
declaring pattern ("rglru", "rglru", "local_attn") with n_layers=36 plus the
remainder noted; the 2-layer delta is recorded here to show where it
departs from the published model.
"""
from .base import ArchConfig, register


def full() -> ArchConfig:
    # 36 = 12 groups of (rglru, rglru, local_attn); the published 38-layer
    # stack has 2 extra recurrent layers which don't tile — we keep the 1:2
    # ratio exactly and document the -2 layer delta (see module docstring).
    return ArchConfig(
        name="recurrentgemma-9b", family="hybrid", n_layers=36, d_model=4096,
        n_heads=16, n_kv_heads=1, d_head=256, d_ff=12288, vocab_size=256_000,
        layer_pattern=("rglru", "rglru", "local_attn"), window=2048,
        lru_width=4096, conv_kernel=4, rope_theta=10_000.0, norm="rmsnorm",
        act="geglu", scale_embed=True, tie_embeddings=True)


def reduced() -> ArchConfig:
    return ArchConfig(
        name="recurrentgemma-9b-reduced", family="hybrid", n_layers=3,
        d_model=64, n_heads=4, n_kv_heads=1, d_head=16, d_ff=128,
        vocab_size=512, layer_pattern=("rglru", "rglru", "local_attn"),
        window=32, lru_width=64, conv_kernel=4, norm="rmsnorm", act="geglu",
        tie_embeddings=True)


register("recurrentgemma-9b", full, reduced)
