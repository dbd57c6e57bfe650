"""gemma2-9b [dense]: 42L d_model=3584 16H (GQA kv=8) d_ff=14336
vocab=256000 — local+global alternating, logit softcap [arXiv:2408.00118]."""
from .base import ArchConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="gemma2-9b", family="dense", n_layers=42, d_model=3584,
        n_heads=16, n_kv_heads=8, d_head=256, d_ff=14336, vocab_size=256_000,
        layer_pattern=("local_attn", "attn"), window=4096,
        rope_theta=10_000.0, softcap_attn=50.0, softcap_logits=30.0,
        norm="rmsnorm", act="geglu", post_norm=True, scale_embed=True,
        tie_embeddings=True)


def reduced() -> ArchConfig:
    return ArchConfig(
        name="gemma2-9b-reduced", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_head=16, d_ff=128, vocab_size=512,
        layer_pattern=("local_attn", "attn"), window=32,
        softcap_attn=50.0, softcap_logits=30.0, norm="rmsnorm", act="geglu",
        tie_embeddings=True)


register("gemma2-9b", full, reduced)
