"""Transformer assembly, serving part (port of ``repro.models.transformer``):
blocks, the layer stack in train / prefill / decode modes, embedding and
head, the decode cache, prefill and decode.

``Params`` is the reference's parameter tree as an ``nn.Module``: ``embed``,
``final_norm``, ``unembed`` (untied heads) and ``blocks``. The reference
stacks each position of ``cfg.layer_pattern`` over ``cfg.n_groups`` and
scans the group body; here ``blocks`` is one ``Block`` per layer in depth
order (layer ``g * len(layer_pattern) + pi`` is group ``g``'s position
``pi``) and the stack is a Python loop, so the decode cache is a list with
one entry per layer. There is no remat: it serves the training step,
which comes with that slice. The dense and MoE families (``attn``,
``local_attn`` and ``swa_attn`` blocks) are ported; the ssm, hybrid, audio
and vlm families (``ssd`` and ``rglru`` blocks, encoder–decoder configs,
M-RoPE positions) raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import torch
from torch import nn

from ..configs.base import ArchConfig
from . import attention as attn_mod
from . import moe as moe_mod
from .layers import (apply_ffn, apply_norm, cdtype, init_ffn, init_norm,
                     param, pdtype, softcap)
from .partitioning import shard_hint

MOE_AUX_KEYS = ("load_balance_loss", "expert_imbalance", "dropped_fraction")
ATTN_KINDS = ("attn", "local_attn", "swa_attn")
NOT_PORTED = ("ROADMAP Queue A item 7b: the training step and the ssm, "
              "hybrid, audio and vlm families")


PORTED_FAMILIES = ("dense", "moe")


def check_ported(cfg: ArchConfig) -> None:
    """Raise for the families this slice does not port (ssm, hybrid,
    audio, vlm)."""
    other = [k for k in cfg.layer_pattern if k not in ATTN_KINDS]
    if cfg.family not in PORTED_FAMILIES or other or cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet "
            f"({NOT_PORTED})")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """One layer's parameters: ``norm1``, ``mixer`` (attention),
    ``norm1_post`` (post-norm configs), ``norm2``, ``ffn`` (dense or MoE),
    ``norm2_post``."""

    def __init__(self, cfg: ArchConfig, kind: str, device) -> None:
        super().__init__()
        if kind not in ATTN_KINDS:
            raise NotImplementedError(f"{kind!r} blocks are not ported yet "
                                      f"({NOT_PORTED})")
        self.norm1 = init_norm(cfg, cfg.d_model, device)
        self.mixer = attn_mod.init_attention(cfg, device)
        if cfg.post_norm:
            self.norm1_post = init_norm(cfg, cfg.d_model, device)
        if cfg.d_ff > 0:
            self.norm2 = init_norm(cfg, cfg.d_model, device)
            self.ffn = (moe_mod.init_moe(cfg, device) if cfg.is_moe
                        else init_ffn(cfg, device))
            if cfg.post_norm:
                self.norm2_post = init_norm(cfg, cfg.d_model, device)


def _init_block(cfg: ArchConfig, kind: str, device) -> Block:
    return Block(cfg, kind, device)


class Params(nn.Module):
    """The model's parameters (the reference's tree, one ``Block`` per
    layer). Weights are allocated uninitialised (on the ``meta`` device:
    shapes only); ``draw_params`` draws them, which with this constructor
    is the reference's ``init_params``."""

    def __init__(self, cfg: ArchConfig, device) -> None:
        super().__init__()
        check_ported(cfg)
        dt = pdtype(cfg)
        self.embed = param((cfg.vocab_padded, cfg.d_model), dt, device)
        self.final_norm = init_norm(cfg, cfg.d_model, device)
        if not cfg.tie_embeddings:
            self.unembed = param((cfg.d_model, cfg.vocab_padded), dt, device)
        self.blocks = nn.ModuleList(
            _init_block(cfg, cfg.layer_pattern[i % cfg.pattern_len], device)
            for i in range(cfg.n_layers))


def draw_params(params: nn.Module, generator: torch.Generator) -> None:
    """Draw every weight of ``params`` in place with ``dense_init``'s
    distribution (normal, std 1/sqrt(fan_in), fan_in the second-to-last
    dim, as in the reference's ``init_params``), in registration order
    from ``generator``; the norms keep their ones and zeros."""
    from .layers import dense_init
    for t in params.parameters():
        if t.dim() >= 2:
            dense_init(t, generator)


# ---------------------------------------------------------------------------
# Block apply
# ---------------------------------------------------------------------------

def _apply_block(cfg: ArchConfig, kind: str, p: Block, x: torch.Tensor, *,
                 mode: str, cache: Optional[Dict],
                 pos: Optional[Union[int, torch.Tensor]],
                 attn_chunk: int = 1024, cache_len: Optional[int] = None):
    """One block. Returns (x, new_cache_dict, aux_metrics)."""
    new_cache: Dict[str, Any] = {}
    aux: Dict[str, torch.Tensor] = {}
    h = apply_norm(cfg, p.norm1, x)
    if mode == "decode":
        y, c_new = attn_mod.decode_attention(cfg, p.mixer, h, cache["self"],
                                             pos, kind=kind)
        new_cache["self"] = c_new
    else:
        ret = attn_mod.apply_attention(cfg, p.mixer, h, kind=kind,
                                       chunk=attn_chunk,
                                       return_kv=(mode == "prefill"))
        if mode == "prefill":
            y, (k_full, v_full) = ret
            new_cache["self"] = _kv_to_cache(cfg, kind, k_full, v_full,
                                             cache_len)
        else:
            y = ret
    if cfg.post_norm:
        y = apply_norm(cfg, p.norm1_post, y)
    x = x + y

    if cfg.d_ff > 0:
        h = apply_norm(cfg, p.norm2, x)
        if cfg.is_moe:
            y, aux = moe_mod.apply_moe(cfg, p.ffn, h)
        else:
            y = apply_ffn(cfg, p.ffn, h)
        if cfg.post_norm:
            y = apply_norm(cfg, p.norm2_post, y)
        x = x + y
    return x, new_cache, aux


def _kv_to_cache(cfg: ArchConfig, kind: str, k: torch.Tensor,
                 v: torch.Tensor, cache_len: Optional[int] = None
                 ) -> Dict[str, torch.Tensor]:
    """Pack prefill K/V into the decode cache layout (rolling for local;
    zero-padded to ``cache_len`` for full attention so decode can append)."""
    s = k.shape[1]
    dt = cdtype(cfg)
    if kind in attn_mod.WINDOWED and cfg.window < s:
        w = cfg.window
        # slot (p % w) holds position p for p in [s - w, s): slot j
        # holds the tail's entry (j - s) mod w
        order = (torch.arange(w, device=k.device) - s) % w
        k = k[:, s - w:][:, order]
        v = v[:, s - w:][:, order]
    elif cache_len is not None and cache_len > s:
        pad = (0, 0, 0, 0, 0, cache_len - s)
        k = torch.nn.functional.pad(k, pad)
        v = torch.nn.functional.pad(v, pad)
    return {"k": k.to(dt), "v": v.to(dt)}


# ---------------------------------------------------------------------------
# Stack
# ---------------------------------------------------------------------------

def apply_stack(cfg: ArchConfig, blocks, x: torch.Tensor,
                caches: Optional[List[Dict]] = None, *, mode: str,
                pos: Optional[Union[int, torch.Tensor]] = None,
                attn_chunk: int = 1024, cache_len: Optional[int] = None):
    """Run every layer in depth order.

    blocks: the ``Params.blocks`` list (one ``Block`` per layer).
    caches: one cache dict per layer (decode) or None (train/prefill).
    Returns (x, new caches (one per layer; empty dicts in train mode),
    the MoE aux metrics summed over layers).
    """
    if caches is None:
        caches = [None] * len(blocks)
    aux_total = ({k: torch.zeros((), device=x.device) for k in MOE_AUX_KEYS}
                 if cfg.is_moe else {})
    new_caches = []
    for i, (p, cache) in enumerate(zip(blocks, caches)):
        x = shard_hint(x, "batch", "act_seq", None)
        kind = cfg.layer_pattern[i % cfg.pattern_len]
        x, c_new, aux = _apply_block(cfg, kind, p, x, mode=mode,
                                     cache=cache, pos=pos,
                                     attn_chunk=attn_chunk,
                                     cache_len=cache_len)
        new_caches.append(c_new)
        for k in aux_total:
            aux_total[k] = aux_total[k] + aux.get(k, 0.0)
    return x, new_caches, aux_total


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def embed_tokens(cfg: ArchConfig, params: Params,
                 tokens: torch.Tensor) -> torch.Tensor:
    """Token embeddings (the audio family's sinusoidal positions come with
    ROADMAP item 7b)."""
    dt = cdtype(cfg)
    x = params.embed[tokens].to(dt)
    if cfg.scale_embed:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dt)
    return shard_hint(x, "batch", None, None)


def _unembed_matrix(cfg: ArchConfig, params: Params) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params.embed.T
    return params.unembed


def logits_at(cfg: ArchConfig, params: Params,
              h: torch.Tensor) -> torch.Tensor:
    """Logits over ``cfg.vocab_padded``, float32."""
    dt = cdtype(cfg)
    w = _unembed_matrix(cfg, params).to(dt)
    lg = (h @ w).float()
    lg = softcap(lg, cfg.softcap_logits)
    return shard_hint(lg, "batch", None, "vocab")


# ---------------------------------------------------------------------------
# Top-level serving functions
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device="cuda") -> List[Dict]:
    """Decode cache: one ``{"self": {"k", "v"}}`` per layer."""
    check_ported(cfg)
    dt = cdtype(cfg)
    return [{"self": attn_mod.init_attn_cache(
        cfg, cfg.layer_pattern[i % cfg.pattern_len], batch, max_len, dt,
        device)} for i in range(cfg.n_layers)]


def forward_prefill(cfg: ArchConfig, params: Params,
                    batch: Dict[str, torch.Tensor], *,
                    attn_chunk: int = 1024,
                    cache_len: Optional[int] = None
                    ) -> Tuple[torch.Tensor, List[Dict]]:
    """batch: tokens (B, S). Returns (last-position logits (B, V_pad),
    decode cache)."""
    check_ported(cfg)
    x = embed_tokens(cfg, params, batch["tokens"])
    x, caches, _ = apply_stack(cfg, params.blocks, x, mode="prefill",
                               attn_chunk=attn_chunk, cache_len=cache_len)
    x = apply_norm(cfg, params.final_norm, x)
    logits = logits_at(cfg, params, x[:, -1:])[:, 0]
    return logits, caches


def forward_decode(cfg: ArchConfig, params: Params, cache: List[Dict],
                   token: torch.Tensor, pos: Union[int, torch.Tensor]
                   ) -> Tuple[torch.Tensor, List[Dict]]:
    """token: (B,) ints; pos: the position it sits at. Returns (logits,
    the cache, updated in place)."""
    check_ported(cfg)
    x = embed_tokens(cfg, params, token[:, None])
    x, new_caches, _ = apply_stack(cfg, params.blocks, x, cache,
                                   mode="decode", pos=pos)
    x = apply_norm(cfg, params.final_norm, x)
    logits = logits_at(cfg, params, x)[:, 0]
    return logits, new_caches
