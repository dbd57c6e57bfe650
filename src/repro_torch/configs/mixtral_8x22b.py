"""mixtral-8x22b [moe]: 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, MoE 8 experts top-2, sliding-window attention
[arXiv:2401.04088]."""
from .base import ArchConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="mixtral-8x22b", family="moe", n_layers=56, d_model=6144,
        n_heads=48, n_kv_heads=8, d_head=128, d_ff=16384, vocab_size=32_768,
        layer_pattern=("swa_attn",), window=4096, rope_theta=1_000_000.0,
        norm="rmsnorm", act="swiglu", n_experts=8, top_k=2,
        capacity_factor=1.25)


def reduced() -> ArchConfig:
    return ArchConfig(
        name="mixtral-8x22b-reduced", family="moe", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_head=16, d_ff=128, vocab_size=512,
        layer_pattern=("swa_attn",), window=32, norm="rmsnorm", act="swiglu",
        n_experts=4, top_k=2, capacity_factor=1.5)


register("mixtral-8x22b", full, reduced)
