"""qwen2-vl-72b [vlm]: 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064 — M-RoPE, dynamic resolution [arXiv:2409.12191].

Backbone only: the vision frontend is a stub; input_specs() provides token
ids (text) — patch embeddings would enter through the same embedding slot.
M-RoPE is implemented with (t, h, w) sections; for text streams the three
position streams coincide (paper's degenerate case).
"""
from .base import ArchConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="qwen2-vl-72b", family="vlm", n_layers=80, d_model=8192,
        n_heads=64, n_kv_heads=8, d_head=128, d_ff=29568, vocab_size=152_064,
        layer_pattern=("attn",), rope_theta=1_000_000.0,
        mrope_sections=(16, 24, 24), norm="rmsnorm", act="swiglu")


def reduced() -> ArchConfig:
    return ArchConfig(
        name="qwen2-vl-72b-reduced", family="vlm", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_head=16, d_ff=128, vocab_size=512,
        layer_pattern=("attn",), mrope_sections=(4, 2, 2), norm="rmsnorm",
        act="swiglu")


register("qwen2-vl-72b", full, reduced)
