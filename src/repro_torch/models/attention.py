"""Attention for the LM substrate (port of ``repro.models.attention``).

Train/prefill uses a chunked online-softmax loop over KV chunks, the plain
twin of the flash kernel: the (S, S) score matrix never materializes.
Decode attends a single query against a (possibly rolling) KV cache.

GQA: KV heads are repeated to Q heads *per chunk* (small), so the cache
stays at KV-head size. Sliding windows are enforced by position masks.
Queries are taken in blocks of ``chunk`` too, and a KV chunk that no query
of the block can see (above the causal diagonal, wholly behind the
window, the banded skip, or wholly past ``kv_valid``) is not computed: for every query that is exactly
the reference's result, since a fully masked chunk adds zero weight after
a visible one and is wiped (``alpha = 0``) before the first.

Dots: the reference's score and context products take ``dot_dt``
operands (bf16 at bf16 compute) with float32 accumulation and a float32
result (``preferred_element_type``); here the ``dot_dt``-rounded operands
are multiplied in float32, which gives that result.

Under autograd each (query block, KV chunk) step runs under
``torch.utils.checkpoint`` with nothing saved, as the reference remats its
chunk step with ``nothing_saveable``: the (B, H, q, c) score block is
recomputed in the backward pass instead of being kept per chunk.
"""
from __future__ import annotations

import functools

from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from .layers import cdtype, mrope, param, pdtype, rope, softcap
from .partitioning import (local_apply, logical_to_spec, placed_axes,
                           shard_hint, shard_offset)

NEG_INF = -1e30
WINDOWED = ("local_attn", "swa_attn")


class Attention(nn.Module):
    """Q/K/V/O projection weights (``wq``, ``wk``, ``wv``, ``wo``)."""

    def __init__(self, cfg: ArchConfig, device) -> None:
        super().__init__()
        d, dt = cfg.d_model, pdtype(cfg)
        self.wq = param((d, cfg.n_heads * cfg.d_head), dt, device)
        self.wk = param((d, cfg.n_kv_heads * cfg.d_head), dt, device)
        self.wv = param((d, cfg.n_kv_heads * cfg.d_head), dt, device)
        self.wo = param((cfg.n_heads * cfg.d_head, d), dt, device)


def init_attention(cfg: ArchConfig, device) -> Attention:
    return Attention(cfg, device)


def _project_qkv(cfg: ArchConfig, p: Attention, x: torch.Tensor,
                 kv_x: Optional[torch.Tensor] = None):
    dt = cdtype(cfg)
    b, s, _ = x.shape
    kvx = x if kv_x is None else kv_x
    sk = kvx.shape[1]
    # (on a mesh the flat projections are placed by their heads first: a
    # head dim that does not divide the model axis is not split sharded)
    q = shard_hint(x @ p.wq.to(dt), "batch", None, "heads").reshape(
        b, s, cfg.n_heads, cfg.d_head)
    k = shard_hint(kvx @ p.wk.to(dt), "batch", None, "kv_heads").reshape(
        b, sk, cfg.n_kv_heads, cfg.d_head)
    v = shard_hint(kvx @ p.wv.to(dt), "batch", None, "kv_heads").reshape(
        b, sk, cfg.n_kv_heads, cfg.d_head)
    q = shard_hint(q, "batch", "attn_q_seq", "heads", None)
    k = shard_hint(k, "batch", None, "kv_heads", None)
    v = shard_hint(v, "batch", None, "kv_heads", None)
    return q, k, v


def _positions(cfg: ArchConfig, q, k, q_pos, k_pos):
    """RoPE on q and k, or M-RoPE (qwen2-vl) with the three position
    streams equal, as for text."""
    if cfg.rope_theta > 0:
        if cfg.mrope_sections:
            q = mrope(q, torch.stack([q_pos] * 3), cfg.rope_theta,
                      cfg.mrope_sections)
            k = mrope(k, torch.stack([k_pos] * 3), cfg.rope_theta,
                      cfg.mrope_sections)
        else:
            q = rope(q, q_pos, cfg.rope_theta)
            k = rope(k, k_pos, cfg.rope_theta)
    return q, k


def _chunk_step(cap: float, dot_dt: torch.dtype, q_blk, k_c, v_c, mask,
                m_run, l_run, acc):
    """One online-softmax step of a query block over one KV chunk."""
    s_blk = torch.einsum("bhqd,bchd->bhqc", q_blk, k_c.to(dot_dt).float())
    s_blk = softcap(s_blk, cap)
    s_blk = s_blk.masked_fill(~mask[None, None], NEG_INF)
    m_new = torch.maximum(m_run, s_blk.amax(-1))
    alpha = torch.exp(m_run - m_new)
    p_blk = torch.exp(s_blk - m_new[..., None])
    l_new = l_run * alpha + p_blk.sum(-1)
    acc_new = acc * alpha[..., None] + torch.einsum(
        "bhqc,bchd->bhqd", p_blk.to(dot_dt).float(), v_c.to(dot_dt).float())
    return m_new, l_new, acc_new


_BSH = ("batch", None, "heads", None)
_Q = ("batch", "attn_q_seq", "heads", None)
_KV = ("batch", None, "kv_heads", None)


def chunked_attention(cfg: ArchConfig, q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor, *, causal: bool, window: int = 0,
                      chunk: int = 1024, q_offset: int = 0,
                      kv_valid: Optional[int] = None) -> torch.Tensor:
    """Online-softmax attention. q: (B,Sq,H,D); k/v: (B,Sk,KV,D).

    window > 0 restricts to the sliding window (causal implied). kv_valid
    masks trailing KV padding (whisper's padded encoder length). The
    score/context products take compute-dtype operands with float32
    accumulation; softmax statistics stay float32.

    On a mesh the whole loop runs once on each rank's local shards
    (``local_apply``): q placed ``("batch", "attn_q_seq", "heads")``,
    k and v ``("batch", None, "kv_heads")``, whole over the sequence, and
    the output as q is. Where ``attn_q_seq`` splits q's sequence (context
    parallelism: heads the model axis does not divide), a rank's queries
    start at its shard's offset, so the causal and window masks, the
    banded skip and ``kv_valid`` see absolute positions; where the heads
    are split and the KV heads are not, a rank takes the KV heads of its
    query heads. The offsets come from the placements q and k received (a
    dim the axis does not divide stays whole: offset 0).
    """
    q = shard_hint(q, *_Q)
    k, v = shard_hint(k, *_KV), shard_hint(v, *_KV)
    q_axes = placed_axes(q, _Q)
    rep = q.shape[2] // k.shape[2]
    attend = functools.partial(
        _attend, cfg.softcap_attn, causal, window, chunk,
        q_offset + shard_offset(q, 1), kv_valid, rep,
        shard_offset(q, 2) - shard_offset(k, 2) * rep)
    return local_apply(attend, (q, k, v), (q_axes, _KV, _KV), (q_axes,))


def _attend(cap: float, causal: bool, window: int, chunk: int,
            q_offset: int, kv_valid: Optional[int], rep: int, head0: int,
            q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
            ) -> torch.Tensor:
    """``chunked_attention`` on (local) tensors: q's first row is at
    absolute position ``q_offset``, and its heads are those from
    ``head0`` of k's heads repeated ``rep`` times."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    chunk = min(chunk, sk)
    if sk % chunk:
        raise ValueError(f"key length {sk} is not a multiple of the "
                         f"attention chunk {chunk}")
    scale = 1.0 / (d ** 0.5)
    dev = q.device
    dot_dt = q.dtype
    remat = torch.is_grad_enabled()
    step = functools.partial(_chunk_step, cap, dot_dt)
    # the rounded dot operand, multiplied in float32
    qf = (q.float() * scale).to(dot_dt).float().transpose(1, 2)
    outs = []
    for q0 in range(0, sq, chunk):
        q1 = min(q0 + chunk, sq)
        q_pos = q_offset + torch.arange(q0, q1, device=dev)
        first, last = q_offset + q0, q_offset + q1 - 1
        q_blk = qf[:, :, q0:q1]
        m_run = torch.full_like(q_blk[..., 0], NEG_INF)
        l_run = torch.zeros_like(q_blk[..., 0])
        acc = torch.zeros_like(q_blk)
        for k0 in range(0, sk, chunk):
            k1 = k0 + chunk
            # banded skip: no query of this block sees the chunk
            if causal and k0 > last:
                break
            if window > 0 and first - (k1 - 1) >= window:
                continue
            if kv_valid is not None and k0 >= kv_valid:
                break
            k_c, v_c = k[:, k0:k1], v[:, k0:k1]
            if rep > 1:
                k_c = k_c.repeat_interleave(rep, dim=2)
                v_c = v_c.repeat_interleave(rep, dim=2)
            if k_c.shape[2] != h:       # heads split, KV heads whole
                k_c = k_c[:, :, head0:head0 + h]
                v_c = v_c[:, :, head0:head0 + h]
            k_pos = torch.arange(k0, k1, device=dev)
            mask = torch.ones((q1 - q0, chunk), dtype=torch.bool, device=dev)
            if causal:
                mask &= q_pos[:, None] >= k_pos[None, :]
            if window > 0:
                mask &= (q_pos[:, None] - k_pos[None, :]) < window
            if kv_valid is not None:
                mask &= (k_pos < kv_valid)[None, :]
            args = (q_blk, k_c, v_c, mask, m_run, l_run, acc)
            m_run, l_run, acc = (
                checkpoint(step, *args, use_reentrant=False)
                if remat else step(*args))
        outs.append(acc / torch.clamp_min(l_run, 1e-30)[..., None])
    out = torch.cat(outs, dim=2)
    return out.transpose(1, 2).to(q.dtype)                  # (B,Sq,H,D)


def apply_attention(cfg: ArchConfig, p: Attention, x: torch.Tensor, *,
                    kind: str, bidirectional: bool = False,
                    kv_x: Optional[torch.Tensor] = None,
                    kv_valid: Optional[int] = None, chunk: int = 1024,
                    return_kv: bool = False):
    """Train/prefill attention over a full sequence: causal or
    bidirectional self-attention, or cross-attention over ``kv_x`` (no
    positions), with trailing keys past ``kv_valid`` masked."""
    q, k, v = _project_qkv(cfg, p, x, kv_x)
    if kv_x is None:  # self-attention gets positions; cross-attention none
        q_pos = torch.arange(q.shape[1], device=x.device)
        k_pos = torch.arange(k.shape[1], device=x.device)
        q, k = _positions(cfg, q, k, q_pos, k_pos)
    window = cfg.window if kind in WINDOWED else 0
    out = chunked_attention(cfg, q, k, v, causal=not bidirectional,
                            window=window, chunk=chunk, kv_valid=kv_valid)
    # on a mesh the heads are merged and projected on each shard (DTensor
    # in torch 2.11 cannot flatten a split sequence, nor split the flat
    # dim's gradient where the heads do not divide it): the rows of a
    # split sequence by the whole ``wo``, as the reference's partitioned
    # product, or split heads by their rows of ``wo``, a partial sum over
    # the model axis
    axes = placed_axes(out, _Q)
    heads = logical_to_spec(axes[2:3])[0] if axes[2] else None
    y = local_apply(_merge_heads, (out, p.wo.to(cdtype(cfg))),
                    (axes, (axes[2], None)), (axes[:2] + (None,),),
                    [{heads: "sum"} if heads else {}])
    y = shard_hint(y, "batch", None, None)
    if return_kv:
        return y, (k, v)
    return y


def _merge_heads(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    return out.reshape(out.shape[0], out.shape[1], -1) @ wo


# ---------------------------------------------------------------- decode
def init_attn_cache(cfg: ArchConfig, kind: str, batch: int, max_len: int,
                    dtype: torch.dtype, device) -> Dict[str, torch.Tensor]:
    s = min(cfg.window, max_len) if kind in WINDOWED else max_len
    shape = (batch, s, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_attention(cfg: ArchConfig, p: Attention, x: torch.Tensor,
                     cache: Dict[str, torch.Tensor],
                     pos: Union[int, torch.Tensor], *, kind: str,
                     cross_kv: Optional[Tuple[torch.Tensor,
                                              torch.Tensor]] = None,
                     kv_valid: Optional[int] = None
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token attention. x: (B, 1, d); pos: the current position.

    Self-attention writes the new key and value into ``cache`` in place
    (the JAX function returns an updated copy; its serve loop donates the
    old one) and returns the same dict. Cross-attention (``cross_kv``, the
    encoder's keys and values, those past ``kv_valid`` masked) reads only
    and returns ``cache`` unchanged."""
    dt = cdtype(cfg)
    b = x.shape[0]
    dev = x.device
    if cross_kv is not None:
        q = (x @ p.wq.to(dt)).reshape(b, 1, cfg.n_heads, cfg.d_head)
        k, v = cross_kv
        mask = (torch.arange(k.shape[1], device=dev) < kv_valid
                if kv_valid is not None else None)
        out = _single_query_attention(cfg, q, k, v, mask)
        y = out.reshape(b, 1, -1) @ p.wo.to(dt)
        return y, cache

    pos = int(pos)
    q, k_new, v_new = _project_qkv(cfg, p, x)
    at = torch.full((1,), pos, device=dev)  # a fill: no host copy
    q, k_new = _positions(cfg, q, k_new, at, at)
    window = cfg.window if kind in WINDOWED else 0
    s_max = cache["k"].shape[1]
    slot = pos % s_max if window > 0 else min(pos, s_max - 1)
    cache["k"][:, slot] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v_new[:, 0].to(cache["v"].dtype)
    # absolute position held by each slot (rolling buffer arithmetic)
    idx = torch.arange(s_max, device=dev)
    slot_pos = pos - ((pos - idx) % s_max) if window > 0 else idx
    valid = slot_pos <= pos
    if window > 0:
        valid &= (pos - slot_pos) < window
    # the cache holds already-rotated keys (the rotation depends only on
    # the absolute position at write time); rolling slot re-use overwrites
    # only entries the window mask excludes, so nothing is rotated again
    out = _single_query_attention(cfg, q, cache["k"].to(dt),
                                  cache["v"].to(dt), valid)
    y = out.reshape(b, 1, -1) @ p.wo.to(dt)
    y = shard_hint(y, "batch", None, None)
    return y, cache


def _single_query_attention(cfg: ArchConfig, q, k, v, mask) -> torch.Tensor:
    rep = cfg.n_heads // cfg.n_kv_heads
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    args = (1.0 / (cfg.d_head ** 0.5), cfg.softcap_attn, q, k, v, mask)
    # on a mesh each (batch, head) shard alone, k and v placed as q is
    return local_apply(_single_query, args,
                       (None, None, _BSH, _BSH, _BSH, None), (_BSH,))


def _single_query(scale: float, cap: float, q, k, v, mask) -> torch.Tensor:
    s = torch.einsum("bqhd,bshd->bhqs", q.float() * scale, k.float())
    s = softcap(s, cap)
    if mask is not None:
        s = s.masked_fill(~mask[None, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqs,bshd->bqhd", p, v.float())
    return out.to(q.dtype)
