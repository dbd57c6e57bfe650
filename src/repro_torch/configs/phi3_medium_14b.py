"""phi3-medium-14b [dense]: 40L d_model=5120 40H (GQA kv=10) d_ff=17920
vocab=100352 — RoPE SwiGLU GQA [arXiv:2404.14219]."""
from .base import ArchConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="phi3-medium-14b", family="dense", n_layers=40, d_model=5120,
        n_heads=40, n_kv_heads=10, d_head=128, d_ff=17920, vocab_size=100_352,
        layer_pattern=("attn",), rope_theta=10_000.0, norm="rmsnorm",
        act="swiglu")


def reduced() -> ArchConfig:
    return ArchConfig(
        name="phi3-medium-14b-reduced", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_head=16, d_ff=160, vocab_size=512,
        layer_pattern=("attn",), norm="rmsnorm", act="swiglu")


register("phi3-medium-14b", full, reduced)
