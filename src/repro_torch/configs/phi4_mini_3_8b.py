"""phi4-mini-3.8b [dense]: 32L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=200064 — RoPE SwiGLU GQA [arXiv:2412.08905]."""
from .base import ArchConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="phi4-mini-3.8b", family="dense", n_layers=32, d_model=3072,
        n_heads=24, n_kv_heads=8, d_head=128, d_ff=8192, vocab_size=200_064,
        layer_pattern=("attn",), rope_theta=10_000.0, norm="rmsnorm",
        act="swiglu", tie_embeddings=True)


def reduced() -> ArchConfig:
    return ArchConfig(
        name="phi4-mini-3.8b-reduced", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_head=16, d_ff=128, vocab_size=512,
        layer_pattern=("attn",), norm="rmsnorm", act="swiglu",
        tie_embeddings=True)


register("phi4-mini-3.8b", full, reduced)
