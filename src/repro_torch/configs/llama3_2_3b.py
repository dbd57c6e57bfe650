"""llama3.2-3b [dense]: 28L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=128256 — small llama3 [hf:meta-llama/Llama-3.2-1B family]."""
from .base import ArchConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="llama3.2-3b", family="dense", n_layers=28, d_model=3072,
        n_heads=24, n_kv_heads=8, d_head=128, d_ff=8192, vocab_size=128_256,
        layer_pattern=("attn",), rope_theta=500_000.0, norm="rmsnorm",
        act="swiglu", tie_embeddings=True)


def reduced() -> ArchConfig:
    return ArchConfig(
        name="llama3.2-3b-reduced", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_head=16, d_ff=128, vocab_size=512,
        layer_pattern=("attn",), rope_theta=500_000.0, norm="rmsnorm",
        act="swiglu", tie_embeddings=True)


register("llama3.2-3b", full, reduced)
