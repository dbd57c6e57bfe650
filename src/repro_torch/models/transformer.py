"""Transformer assembly (port of ``repro.models.transformer``): blocks, the
layer stack in train / prefill / decode modes with remat, the whisper
encoder, embedding and head, the chunked cross-entropy, the decode cache,
and the train / prefill / decode functions.

``Params`` is the reference's parameter tree as an ``nn.Module``: ``embed``,
``final_norm``, ``unembed`` (untied heads), ``blocks`` and, for
encoder-decoder configs, ``encoder`` and ``enc_final_norm``. The reference
stacks each position of ``cfg.layer_pattern`` over ``cfg.n_groups`` (and
the encoder over ``cfg.encoder_layers``) and scans; here ``blocks`` is one
``Block`` per layer in depth order (layer ``g * len(layer_pattern) + pi``
is group ``g``'s position ``pi``) and the stack is a Python loop, so the
decode cache is a list with one entry per layer.

Remat (``REMAT_POLICIES``, the reference's names) wraps each layer of the
stack in train mode under autograd: ``"full"`` saves nothing,
``"dots"`` saves the outputs of ``mm`` / ``bmm`` / ``addmm``,
``"dots_no_batch"`` those of ``mm`` / ``addmm`` (not the batched
attention products), ``"save_outs"`` the three sublayer outputs the
reference names ``mixer_out``, ``cross_out`` and ``ffn_out``
(``checkpoint_name`` tags them), all through
``torch.utils.checkpoint`` (non-reentrant; selective policies through
``create_selective_checkpoint_contexts``). Remat changes no number.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..configs.base import ArchConfig
from . import attention as attn_mod
from . import moe as moe_mod
from . import rglru as rglru_mod
from . import ssm as ssm_mod
from .layers import (apply_ffn, apply_norm, cdtype, init_ffn, init_norm,
                     param, pdtype, sinusoidal_positions, softcap)
from .partitioning import (current_rules, local_apply, shard_hint,
                           shard_offset)

MOE_AUX_KEYS = ("load_balance_loss", "expert_imbalance", "dropped_fraction")
ATTN_KINDS = ("attn", "local_attn", "swa_attn")
RECURRENT_KINDS = ("ssd", "rglru")


@torch.library.custom_op("repro_torch::checkpoint_name", mutates_args=())
def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """Identity that tags ``x`` as ``name`` for the ``"save_outs"`` remat
    policy (``jax.ad_checkpoint.checkpoint_name``)."""
    return x.clone()


@checkpoint_name.register_fake
def _(x, name):
    return torch.empty_like(x)


checkpoint_name.register_autograd(lambda ctx, grad: (grad, None))


def _tag(x: torch.Tensor, name: str) -> torch.Tensor:
    """``checkpoint_name`` of ``x``; a DTensor's local shard is tagged (the
    custom op has no DTensor sharding rule), keeping its placements."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return checkpoint_name(x, name)
    return DTensor.from_local(checkpoint_name(x.to_local(), name),
                              x.device_mesh, x.placements, run_check=False,
                              shape=x.shape, stride=x.stride())

_MM = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
REMAT_POLICIES = {
    "none": None,
    "full": (),
    "dots": _MM + (torch.ops.aten.bmm.default,),
    "dots_no_batch": _MM,
    "save_outs": (torch.ops.repro_torch.checkpoint_name.default,),
}


def _saving(ops, ctx, func, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if func in ops
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(policy: str, fn, *args):
    """``fn(*args)`` under ``REMAT_POLICIES[policy]``."""
    ops = REMAT_POLICIES[policy]
    if ops is None or not torch.is_grad_enabled():
        return fn(*args)
    if not ops:
        return checkpoint(fn, *args, use_reentrant=False)
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=functools.partial(
                          create_selective_checkpoint_contexts,
                          functools.partial(_saving, ops)))


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """One layer's parameters: ``norm1``, ``mixer`` (attention, SSD or
    RG-LRU), ``norm1_post`` (post-norm configs), ``norm_cross`` and
    ``cross`` (decoder layers of encoder-decoder configs), ``norm2``,
    ``ffn`` (dense or MoE), ``norm2_post``."""

    def __init__(self, cfg: ArchConfig, kind: str, device,
                 cross: bool = False) -> None:
        super().__init__()
        self.norm1 = init_norm(cfg, cfg.d_model, device)
        if kind in ATTN_KINDS:
            self.mixer = attn_mod.init_attention(cfg, device)
        elif kind == "ssd":
            self.mixer = ssm_mod.init_ssd(cfg, device)
        elif kind == "rglru":
            self.mixer = rglru_mod.init_rglru(cfg, device)
        else:
            raise ValueError(kind)
        if cfg.post_norm:
            self.norm1_post = init_norm(cfg, cfg.d_model, device)
        if cross:
            self.norm_cross = init_norm(cfg, cfg.d_model, device)
            self.cross = attn_mod.init_attention(cfg, device)
        if cfg.d_ff > 0:
            self.norm2 = init_norm(cfg, cfg.d_model, device)
            self.ffn = (moe_mod.init_moe(cfg, device) if cfg.is_moe
                        else init_ffn(cfg, device))
            if cfg.post_norm:
                self.norm2_post = init_norm(cfg, cfg.d_model, device)


class Params(nn.Module):
    """The model's parameters (the reference's tree, one ``Block`` per
    layer). Weights are allocated uninitialised (on the ``meta`` device:
    shapes only); ``draw_params`` draws them, which with this constructor
    is the reference's ``init_params``. Every block and encoder parameter
    is marked ``stacked``: the reference stacks it over the groups, so its
    tree gives it one more dim than it has here (``AdamW`` decays by that
    count)."""

    def __init__(self, cfg: ArchConfig, device) -> None:
        super().__init__()
        dt = pdtype(cfg)
        self.embed = param((cfg.vocab_padded, cfg.d_model), dt, device)
        self.final_norm = init_norm(cfg, cfg.d_model, device)
        if not cfg.tie_embeddings:
            self.unembed = param((cfg.d_model, cfg.vocab_padded), dt, device)
        self.blocks = nn.ModuleList(
            Block(cfg, cfg.layer_pattern[i % cfg.pattern_len], device,
                  cfg.cross_attention)
            for i in range(cfg.n_layers))
        if cfg.is_encdec:
            self.encoder = nn.ModuleList(
                Block(cfg, "attn", device) for _ in range(cfg.encoder_layers))
            self.enc_final_norm = init_norm(cfg, cfg.d_model, device)
        for stack in (self.blocks, getattr(self, "encoder", nn.ModuleList())):
            for t in stack.parameters():
                t.stacked = True


def draw_params(params: nn.Module, generator: torch.Generator) -> None:
    """Draw every weight of ``params`` in place, in registration order from
    ``generator``, with the reference's ``init_params`` distributions:
    a weight with an ``init_std`` (the SSD and RG-LRU convolutions) is
    normal with that std, every other weight of two or more dims
    ``dense_init`` (normal, std 1/sqrt(fan_in), fan_in the second-to-last
    dim); the norms and the recurrent constants keep their initial
    values."""
    from .layers import dense_init
    with torch.no_grad():
        for t in params.parameters():
            std = getattr(t, "init_std", None)
            if std is not None:
                t.normal_(0.0, std, generator=generator)
            elif t.dim() >= 2:
                dense_init(t, generator)


# ---------------------------------------------------------------------------
# Block apply
# ---------------------------------------------------------------------------

def _gathered(h: torch.Tensor) -> torch.Tensor:
    """A sublayer's input with the sequence whole: on a mesh the residual
    stream is sequence-sharded between layers ("act_seq") and gathered
    before each mixer and FFN, the all-gather GSPMD inserts for the
    reference (the identity on one card)."""
    return shard_hint(h, "batch", None, None)


def _apply_block(cfg: ArchConfig, kind: str, p: Block, x: torch.Tensor, *,
                 mode: str, cache: Optional[Dict],
                 pos: Optional[Union[int, torch.Tensor]],
                 bidirectional: bool = False,
                 self_kv_valid: Optional[int] = None,
                 cross_enc: Optional[torch.Tensor] = None,
                 enc_valid: Optional[int] = None, attn_chunk: int = 1024,
                 cache_len: Optional[int] = None, tag: bool = False):
    """One block. Returns (x, new_cache_dict, aux_metrics). ``tag`` marks
    the sublayer outputs for the ``"save_outs"`` remat policy."""
    def named(y, name):
        return _tag(y, name) if tag else y

    new_cache: Dict[str, Any] = {}
    aux: Dict[str, torch.Tensor] = {}
    h = _gathered(apply_norm(cfg, p.norm1, x))
    if kind in ATTN_KINDS:
        if mode == "decode":
            y, c_new = attn_mod.decode_attention(cfg, p.mixer, h,
                                                 cache["self"], pos,
                                                 kind=kind)
            new_cache["self"] = c_new
        else:
            ret = attn_mod.apply_attention(
                cfg, p.mixer, h, kind=kind, bidirectional=bidirectional,
                kv_valid=self_kv_valid, chunk=attn_chunk,
                return_kv=(mode == "prefill"))
            if mode == "prefill":
                y, (k_full, v_full) = ret
                new_cache["self"] = _kv_to_cache(cfg, kind, k_full, v_full,
                                                 cache_len)
            else:
                y = ret
    elif kind in RECURRENT_KINDS:
        init_c = (ssm_mod.init_ssd_cache if kind == "ssd"
                  else rglru_mod.init_rglru_cache)
        apply = ssm_mod.apply_ssd if kind == "ssd" else rglru_mod.apply_rglru
        if mode == "train":
            c_in = None
        elif mode == "prefill":
            c_in = init_c(cfg, h.shape[0], h.dtype, h.device)
        else:
            c_in = cache["self"]
        y, c_new = apply(cfg, p.mixer, h, cache=c_in, pos=pos)
        if mode != "train":
            new_cache["self"] = c_new
    else:
        raise ValueError(kind)
    if cfg.post_norm:
        y = apply_norm(cfg, p.norm1_post, y)
    x = x + named(y, "mixer_out")

    if hasattr(p, "cross"):
        h = _gathered(apply_norm(cfg, p.norm_cross, x))
        if mode == "decode":
            ck = cache["cross"]
            y, _ = attn_mod.decode_attention(
                cfg, p.cross, h, {}, pos, kind="attn",
                cross_kv=(ck["k"], ck["v"]), kv_valid=enc_valid)
            new_cache["cross"] = ck  # passed through unchanged
        else:
            y, (k_c, v_c) = attn_mod.apply_attention(
                cfg, p.cross, h, kind="attn", bidirectional=True,
                kv_x=cross_enc, kv_valid=enc_valid,
                chunk=min(attn_chunk, 512),  # encoder pads to 512 multiples
                return_kv=True)
            if mode == "prefill":
                new_cache["cross"] = {"k": k_c.to(cdtype(cfg)),
                                      "v": v_c.to(cdtype(cfg))}
        x = x + named(y, "cross_out")

    if cfg.d_ff > 0:
        h = _gathered(apply_norm(cfg, p.norm2, x))
        if cfg.is_moe:
            y, aux = moe_mod.apply_moe(cfg, p.ffn, h)
        else:
            y = apply_ffn(cfg, p.ffn, h)
        if cfg.post_norm:
            y = apply_norm(cfg, p.norm2_post, y)
        x = x + named(y, "ffn_out")
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

def _layer(cfg: ArchConfig, kind: str, p: Block, kw: Dict, x: torch.Tensor,
           cross_enc: Optional[torch.Tensor]):
    """``_apply_block`` with the tensors a checkpoint sees as its
    inputs last."""
    return _apply_block(cfg, kind, p, x, cross_enc=cross_enc, **kw)


def apply_stack(cfg: ArchConfig, blocks, x: torch.Tensor,
                caches: Optional[List[Dict]] = None, *, mode: str,
                pos: Optional[Union[int, torch.Tensor]] = None,
                cross_enc: Optional[torch.Tensor] = None,
                enc_valid: Optional[int] = None, remat: str = "none",
                attn_chunk: int = 1024, cache_len: Optional[int] = None):
    """Run every layer in depth order.

    blocks: the ``Params.blocks`` list (one ``Block`` per layer).
    caches: one cache dict per layer (decode) or None (train/prefill).
    remat: a ``REMAT_POLICIES`` name, applied to each layer in train mode.
    Returns (x, new caches (one per layer; empty dicts in train mode),
    the MoE aux metrics summed over layers).
    """
    if remat not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {remat!r}; one of "
                         f"{sorted(REMAT_POLICIES)}")
    if mode != "train":
        remat = "none"
    if caches is None:
        caches = [None] * len(blocks)
    aux_total = ({k: torch.zeros((), device=x.device) for k in MOE_AUX_KEYS}
                 if cfg.is_moe else {})
    new_caches = []
    for i, (p, cache) in enumerate(zip(blocks, caches)):
        x = shard_hint(x, "batch", "act_seq", None)
        kind = cfg.layer_pattern[i % cfg.pattern_len]
        layer = functools.partial(
            _layer, cfg, kind, p,
            dict(mode=mode, cache=cache, pos=pos, enc_valid=enc_valid,
                 attn_chunk=attn_chunk, cache_len=cache_len,
                 tag=(remat == "save_outs")))
        x, c_new, aux = _remat(remat, layer, x, cross_enc)
        new_caches.append(c_new)
        for k in aux_total:
            aux_total[k] = aux_total[k] + aux.get(k, 0.0)
    return x, new_caches, aux_total


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def _vocab_pick(src: torch.Tensor, idx: torch.Tensor, vdim: int,
                src_axes: tuple, out_axes: tuple, pick) -> torch.Tensor:
    """``pick(src, idx)``: the entries of ``src``'s vocab dim ``vdim`` at
    the token ids ``idx`` (B, S); ``src_axes`` and ``out_axes`` are the
    logical axes of ``src`` and of the result. On a mesh the vocab dim is
    sharded over the model axis ("vocab") and each shard picks the ids in
    its own range (0 for the others): a sum over the model axis, as GSPMD
    partitions the reference's gathers (DTensor in torch 2.11 cannot
    shard the lookup's backward, and its gather strategy fails to reduce
    the target pick's masked partial)."""
    from torch.distributed.tensor import DTensor
    rules = current_rules()
    if rules is None or not isinstance(src, DTensor):
        return pick(src, idx)
    src = shard_hint(src, *src_axes)
    offset = shard_offset(src, vdim)

    def local(t, ids):
        n = t.shape[vdim]
        j = ids - offset
        inside = (j >= 0) & (j < n)
        got = pick(t, j.clamp(0, n - 1))
        inside = inside.reshape(inside.shape + (1,) * (got.dim()
                                                       - inside.dim()))
        return torch.where(inside, got, torch.zeros_like(got))

    return local_apply(local, (src, idx), (src_axes, ("batch", None)),
                       (out_axes,), [{rules["vocab"]: "sum"}])


def _lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]`` (vocab-parallel on a mesh: ``_vocab_pick``)."""
    return _vocab_pick(table, tokens, 0, ("vocab", None),
                       ("batch", None, None), lambda t, ids: t[ids])


def embed_tokens(cfg: ArchConfig, params: Params, tokens: torch.Tensor,
                 positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token embeddings, plus absolute sinusoidal positions for configs
    without RoPE (whisper; ``positions`` default 0..S-1)."""
    dt = cdtype(cfg)
    x = _lookup(params.embed, tokens).to(dt)
    if cfg.scale_embed:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dt)
    if cfg.rope_theta <= 0:
        if positions is None:
            positions = torch.arange(tokens.shape[-1], device=x.device)
        x = x + sinusoidal_positions(positions, cfg.d_model).to(dt)
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


def _target_logit(lg: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``lg[..., t]`` (vocab-parallel on a mesh: ``_vocab_pick``)."""
    return _vocab_pick(lg, t, -1, ("batch", None, "vocab"),
                       ("batch", None),
                       lambda x, ids: x.gather(-1, ids[..., None])[..., 0])


def _logsumexp(lg: torch.Tensor) -> torch.Tensor:
    """``logsumexp`` over the vocab dim of (B, c, V) logits. On a mesh,
    vocab-parallel: the max over the shards (an all-reduce of (B, c)),
    each shard's sum of exponentials on its own (``local_apply``), and
    their sum (an all-reduce of (B, c)); DTensor would take ``logsumexp``
    over the split vocab by moving the logits between the ranks."""
    from torch.distributed.tensor import DTensor
    rules = current_rules()
    if rules is None or not isinstance(lg, DTensor):
        return torch.logsumexp(lg, dim=-1)
    m = lg.detach().amax(-1)
    s = local_apply(lambda x, mx: (x - mx[..., None]).exp().sum(-1),
                    (lg, m), (("batch", None, "vocab"), ("batch", None)),
                    (("batch", None),), [{rules["vocab"]: "sum"}])
    return s.log() + m


def _xent_chunk(cap: float, h_c, w, t_c, m_c):
    """Summed masked negative log-likelihood of one sequence chunk."""
    lg = softcap((h_c @ w).float(), cap)
    lg = shard_hint(lg, "batch", None, "vocab")
    lse = _logsumexp(lg)
    tgt = _target_logit(lg, t_c)
    return ((lse - tgt) * m_c).sum()


def chunked_xent(cfg: ArchConfig, params: Params, h: torch.Tensor,
                 targets: torch.Tensor, mask: torch.Tensor,
                 chunk: int = 512) -> torch.Tensor:
    """Cross-entropy over sequence chunks; never builds (B, S, V) logits.
    Under autograd each chunk runs under ``torch.utils.checkpoint``, so
    only one chunk's logits are live in the backward pass too."""
    s = h.shape[1]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"loss chunk {chunk}")
    # on a mesh the weight's data-axis shards are gathered (FSDP), as
    # GSPMD partitions the reference's product under the logits' hint:
    # else DTensor contracts over the data axis and gathers the batch
    w = shard_hint(_unembed_matrix(cfg, params).to(cdtype(cfg)), None,
                   "vocab")
    remat = torch.is_grad_enabled()
    tot = torch.zeros((), device=h.device)
    for c0 in range(0, s, chunk):
        args = (cfg.softcap_logits, h[:, c0:c0 + chunk], w,
                targets[:, c0:c0 + chunk], mask[:, c0:c0 + chunk])
        tot = tot + (checkpoint(_xent_chunk, *args, use_reentrant=False)
                     if remat else _xent_chunk(*args))
    return tot / torch.clamp_min(mask.sum(), 1.0)


# ---------------------------------------------------------------------------
# Top-level model functions
# ---------------------------------------------------------------------------

def encoder_pad_len(cfg: ArchConfig, chunk: int = 512) -> int:
    return -(-cfg.encoder_len // chunk) * chunk


def _encode(cfg: ArchConfig, params: Params, audio_embed: torch.Tensor,
            attn_chunk: int) -> torch.Tensor:
    """Whisper encoder over stubbed frame embeddings (B, enc_len, d):
    padded to a multiple of 512, sinusoidal positions, bidirectional
    attention over the ``encoder_len`` real frames, ``enc_final_norm``."""
    dt = cdtype(cfg)
    x = audio_embed.to(dt)
    pad = encoder_pad_len(cfg) - x.shape[1]
    if pad > 0:     # (a concatenation: DTensor in torch 2.11 fails to pad)
        x = torch.cat([x, x.new_zeros((x.shape[0], pad, x.shape[2]))], 1)
    x = x + sinusoidal_positions(torch.arange(x.shape[1], device=x.device),
                                 cfg.d_model).to(dt)
    x = shard_hint(x, "batch", None, None)
    for p in params.encoder:
        x, _, _ = _apply_block(cfg, "attn", p, x, mode="train", cache=None,
                               pos=None, bidirectional=True,
                               self_kv_valid=cfg.encoder_len,
                               attn_chunk=min(attn_chunk, 512))
    return apply_norm(cfg, params.enc_final_norm, x)


def _cross(cfg: ArchConfig, params: Params, batch: Dict[str, torch.Tensor],
           attn_chunk: int):
    if not cfg.is_encdec:
        return None, None
    return (_encode(cfg, params, batch["audio_embed"], attn_chunk),
            cfg.encoder_len)


def forward_train(cfg: ArchConfig, params: Params,
                  batch: Dict[str, torch.Tensor], *,
                  remat: str = "dots_no_batch", attn_chunk: int = 1024
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: tokens (B, S) [, loss_mask (B, S), audio_embed].

    Next-token objective: position i predicts tokens[i + 1] (the targets
    wrap; the last position is masked out). Returns (loss, metrics): the
    loss adds ``0.01 * load_balance_loss / n_groups`` for MoE configs, the
    metrics hold the cross-entropy ``loss`` and the MoE aux metrics over
    ``n_groups``."""
    tokens = batch["tokens"]
    x = embed_tokens(cfg, params, tokens)
    cross_enc, enc_valid = _cross(cfg, params, batch, attn_chunk)
    x, _, aux = apply_stack(cfg, params.blocks, x, mode="train",
                            cross_enc=cross_enc, enc_valid=enc_valid,
                            remat=remat, attn_chunk=attn_chunk)
    x = _gathered(apply_norm(cfg, params.final_norm, x))
    targets = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    mask = batch.get("loss_mask")
    mask = (torch.ones(tokens.shape, device=tokens.device) if mask is None
            else mask.float())
    mask = torch.cat([mask[:, :-1], torch.zeros_like(mask[:, -1:])], dim=1)
    loss = chunked_xent(cfg, params, x, targets.long(), mask)
    metrics = {"loss": loss,
               **{k: v / cfg.n_groups for k, v in aux.items()}}
    if cfg.is_moe:
        # both scalars replicated first: on a mesh their partial sums
        # carry different placements, whose sum's backward DTensor cannot
        # view (identities on one card)
        loss = (shard_hint(loss) + 0.01
                * shard_hint(aux["load_balance_loss"]) / cfg.n_groups)
    return loss, metrics


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device="cuda") -> List[Dict]:
    """Decode cache: per layer ``{"self": ...}`` (attention K/V, or the
    SSD / RG-LRU state and conv tail) and, for encoder-decoder configs,
    ``"cross"`` (the encoder's K/V, filled by prefill)."""
    dt = cdtype(cfg)
    out = []
    for i in range(cfg.n_layers):
        kind = cfg.layer_pattern[i % cfg.pattern_len]
        c: Dict[str, Any] = {}
        if kind in ATTN_KINDS:
            c["self"] = attn_mod.init_attn_cache(cfg, kind, batch, max_len,
                                                 dt, device)
        elif kind == "ssd":
            c["self"] = ssm_mod.init_ssd_cache(cfg, batch, dt, device)
        else:
            c["self"] = rglru_mod.init_rglru_cache(cfg, batch, dt, device)
        if cfg.cross_attention:
            kv = (batch, encoder_pad_len(cfg), cfg.n_kv_heads, cfg.d_head)
            c["cross"] = {"k": torch.zeros(kv, dtype=dt, device=device),
                          "v": torch.zeros(kv, dtype=dt, device=device)}
        out.append(c)
    return out


def forward_prefill(cfg: ArchConfig, params: Params,
                    batch: Dict[str, torch.Tensor], *,
                    attn_chunk: int = 1024,
                    cache_len: Optional[int] = None
                    ) -> Tuple[torch.Tensor, List[Dict]]:
    """batch: tokens (B, S) [, audio_embed]. Returns (last-position logits
    (B, V_pad), decode cache)."""
    x = embed_tokens(cfg, params, batch["tokens"])
    cross_enc, enc_valid = _cross(cfg, params, batch, attn_chunk)
    x, caches, _ = apply_stack(cfg, params.blocks, x, mode="prefill",
                               cross_enc=cross_enc, enc_valid=enc_valid,
                               attn_chunk=attn_chunk, cache_len=cache_len)
    x = _gathered(apply_norm(cfg, params.final_norm, x))
    logits = logits_at(cfg, params, x[:, -1:])[:, 0]
    return logits, caches


def forward_decode(cfg: ArchConfig, params: Params, cache: List[Dict],
                   token: torch.Tensor, pos: Union[int, torch.Tensor]
                   ) -> Tuple[torch.Tensor, List[Dict]]:
    """token: (B,) ints; pos: the position it sits at. Returns (logits,
    the cache; attention K/V are written in place)."""
    at = torch.full((1,), int(pos), device=token.device)
    x = embed_tokens(cfg, params, token[:, None], positions=at)
    enc_valid = cfg.encoder_len if cfg.is_encdec else None
    x, new_caches, _ = apply_stack(cfg, params.blocks, x, cache,
                                   mode="decode", pos=pos,
                                   enc_valid=enc_valid)
    x = apply_norm(cfg, params.final_norm, x)
    logits = logits_at(cfg, params, x)[:, 0]
    return logits, new_caches
