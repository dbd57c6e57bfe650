"""mamba2-780m [ssm]: 48L d_model=1536 (attn-free) vocab=50280,
ssm_state=128 — SSD state-space duality [arXiv:2405.21060]."""
from .base import ArchConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="mamba2-780m", family="ssm", n_layers=48, d_model=1536,
        n_heads=0, n_kv_heads=0, d_head=0, d_ff=0, vocab_size=50_280,
        layer_pattern=("ssd",), ssm_state=128, ssm_head_dim=64,
        ssm_expand=2, ssm_chunk=256, conv_kernel=4, norm="rmsnorm",
        tie_embeddings=True)


def reduced() -> ArchConfig:
    return ArchConfig(
        name="mamba2-780m-reduced", family="ssm", n_layers=2, d_model=64,
        n_heads=0, n_kv_heads=0, d_head=0, d_ff=0, vocab_size=512,
        layer_pattern=("ssd",), ssm_state=16, ssm_head_dim=16,
        ssm_expand=2, ssm_chunk=32, conv_kernel=4, norm="rmsnorm",
        tie_embeddings=True)


register("mamba2-780m", full, reduced)
