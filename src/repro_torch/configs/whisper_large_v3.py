"""whisper-large-v3 [audio]: enc-dec, 32+32L d_model=1280 20H (MHA kv=20)
d_ff=5120 vocab=51866 — conv frontend stubbed [arXiv:2212.04356].

The assigned spec lists 32L; Whisper large is a 32-encoder + 32-decoder
stack. The conv1d mel frontend is a STUB: input_specs() provides
precomputed frame embeddings (B, 1500, d_model). Decoder seq_len follows
the assigned shape; encoder length is the fixed 1500 frames.
"""
from .base import ArchConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="whisper-large-v3", family="audio", n_layers=32, d_model=1280,
        n_heads=20, n_kv_heads=20, d_head=64, d_ff=5120, vocab_size=51_866,
        layer_pattern=("attn",), rope_theta=0.0,  # learned abs positions
        norm="layernorm", act="gelu", encoder_layers=32, encoder_len=1500,
        cross_attention=True, tie_embeddings=True)


def reduced() -> ArchConfig:
    return ArchConfig(
        name="whisper-large-v3-reduced", family="audio", n_layers=2,
        d_model=64, n_heads=4, n_kv_heads=4, d_head=16, d_ff=128,
        vocab_size=512, layer_pattern=("attn",), rope_theta=0.0,
        norm="layernorm", act="gelu", encoder_layers=2, encoder_len=32,
        cross_attention=True, tie_embeddings=True)


register("whisper-large-v3", full, reduced)
