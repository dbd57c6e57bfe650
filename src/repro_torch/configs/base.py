"""Architecture config system: one frozen dataclass, a registry, and the
four assigned input shapes.

Every assigned arch registers itself via ``register``; ``get_config(name)``
and ``--arch <id>`` resolve through the registry. ``reduced()`` produces the
CPU-smoke-test variant of the same family (few layers, narrow, tiny vocab).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

VOCAB_PAD_MULTIPLE = 2048  # vocab padded so TP-16 shards stay lane-aligned


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int                # 0 => attention-free
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int
    # Layer pattern tiled over depth, e.g. ("rglru", "rglru", "local_attn").
    # Kinds: attn | local_attn | swa_attn | ssd | rglru
    layer_pattern: Tuple[str, ...] = ("attn",)
    window: int = 4096          # local/sliding-window size
    rope_theta: float = 10_000.0
    mrope_sections: Tuple[int, int, int] = ()  # qwen2-vl M-RoPE half-dims
    softcap_attn: float = 0.0   # gemma2: 50.0
    softcap_logits: float = 0.0  # gemma2: 30.0
    norm: str = "rmsnorm"       # rmsnorm | layernorm
    act: str = "swiglu"         # swiglu | geglu | gelu
    post_norm: bool = False     # gemma2: norm after each sublayer too
    scale_embed: bool = False   # gemma family: x *= sqrt(d_model)
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_kernel: int = 4
    # Recurrent (RG-LRU)
    lru_width: int = 0
    # Encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_len: int = 0
    cross_attention: bool = False
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    # ------------------------------------------------------------- derived
    @property
    def vocab_padded(self) -> int:
        return -(-self.vocab_size // VOCAB_PAD_MULTIPLE) * VOCAB_PAD_MULTIPLE

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def pattern_len(self) -> int:
        return len(self.layer_pattern)

    @property
    def n_groups(self) -> int:
        assert self.n_layers % self.pattern_len == 0, (
            f"{self.name}: n_layers {self.n_layers} must be divisible by "
            f"pattern length {self.pattern_len}")
        return self.n_layers // self.pattern_len

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def sub_quadratic(self) -> bool:
        """True if no layer kind requires a full-context dense KV compare at
        decode beyond a fixed window (used for the long_500k skip rule).
        gemma2 counts as hybrid (alternating local/global) and is included
        per DESIGN.md §5."""
        kinds = set(self.layer_pattern)
        return "attn" not in kinds or self.name in ("gemma2-9b",)

    # Exact parameter counts are derived from the actual param pytree
    # (models/model.py: count_params / count_active_params); the config
    # deliberately carries no analytic formula that could drift.


_REGISTRY: Dict[str, Callable[[], ArchConfig]] = {}
_REDUCED: Dict[str, Callable[[], ArchConfig]] = {}


def register(name: str, full: Callable[[], ArchConfig],
             reduced: Callable[[], ArchConfig]) -> None:
    _REGISTRY[name] = full
    _REDUCED[name] = reduced


def get_config(name: str, reduced: bool = False) -> ArchConfig:
    table = _REDUCED if reduced else _REGISTRY
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; have {sorted(table)}")
    return table[name]()


def list_archs() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


# ---------------------------------------------------------------------------
# Assigned input shapes (the 4 shapes paired with every arch)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

# Pure full-attention archs skip long_500k (DESIGN.md §5).
def shape_applicable(cfg: ArchConfig, shape: ShapeConfig) -> bool:
    if shape.name == "long_500k":
        return cfg.sub_quadratic
    return True
