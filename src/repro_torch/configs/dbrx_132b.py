"""dbrx-132b [moe]: 40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352,
MoE 16 experts top-4, fine-grained [hf:databricks/dbrx-base]."""
from .base import ArchConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="dbrx-132b", family="moe", n_layers=40, d_model=6144,
        n_heads=48, n_kv_heads=8, d_head=128, d_ff=10752, vocab_size=100_352,
        layer_pattern=("attn",), rope_theta=500_000.0, norm="layernorm",
        act="swiglu", n_experts=16, top_k=4, capacity_factor=1.25)


def reduced() -> ArchConfig:
    return ArchConfig(
        name="dbrx-132b-reduced", family="moe", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_head=16, d_ff=128, vocab_size=512,
        layer_pattern=("attn",), norm="layernorm", act="swiglu",
        n_experts=4, top_k=2, capacity_factor=1.5)


register("dbrx-132b", full, reduced)
