"""Mixture-of-Experts FFN with capacity-bounded dispatch (port of
``repro.models.moe``).

Tokens-per-expert is SpChar's nnz-per-row partition problem, and the
load-balance statistics logged here are Eq. 5 verbatim.

Dispatch, as the reference does it: per batch row, each token's top-k
experts get slots in an (E, C) buffer through a token-major cumsum (GShard
priority = token order); capacity C = ceil8(top_k * S * capacity_factor /
E); overflow tokens are dropped and counted. The expert FFN runs on the
(B, E, C, d) buffer and a scatter-add with the gate weights combines it
back. The grouped-GEMM kernel (``moe_gmm``) is the serving example's path;
this layer stays plain PyTorch, as the reference stays plain JAX.

Where the two frameworks differ, the port does what JAX does:
``jax.lax.top_k`` breaks ties toward the lower expert index, which a
stable descending sort gives (``torch.topk`` promises no order); a
scatter with ``mode="drop"`` at slot ``cap`` becomes a buffer with one pad
column that is sliced off. The combine adds at most ``top_k`` bf16 values
per token in index order, as the reference's scatter-add does; bf16
rounds after each add, so a changed order moves a sum by up to a few bf16
ulps.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ArchConfig
from .layers import cdtype, gelu, param, pdtype
from .partitioning import (current_rules, local_apply, logical_to_spec,
                           shard_hint)


class MoE(nn.Module):
    """Router (float32, (d, E)) and stacked expert FFN weights."""

    def __init__(self, cfg: ArchConfig, device) -> None:
        super().__init__()
        d, ff, e, dt = cfg.d_model, cfg.d_ff, cfg.n_experts, pdtype(cfg)
        self.router = param((d, e), torch.float32, device)
        self.wi_gate = param((e, d, ff), dt, device)
        self.wi_up = param((e, d, ff), dt, device)
        self.wo = param((e, ff, d), dt, device)


def init_moe(cfg: ArchConfig, device) -> MoE:
    return MoE(cfg, device)


def _capacity(cfg: ArchConfig, s: int) -> int:
    c = int(cfg.top_k * s * cfg.capacity_factor / cfg.n_experts)
    return max(-(-c // 8) * 8, 8)  # pad to 8 for lane alignment


def top_k_lower_index(probs: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest along the last axis, ties to the
    lower index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def apply_moe(cfg: ArchConfig, p: MoE, x: torch.Tensor
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, d) -> (out (B, S, d), metrics).

    Returns aux metrics: load_balance_loss (Switch aux), expert_imbalance
    (Eq. 5 over tokens-per-expert), dropped_fraction.

    On a mesh (``local_apply``) each shard of the batch routes its own
    tokens over all experts, then runs the experts it holds: all of them
    with its slice of their hidden dim ("moe_ffn": tensor parallelism,
    mixtral), or its slice of the experts whole ("experts": expert
    parallelism, dbrx). Either way its output is a part of a sum over the
    model axis, and the metrics are a mean over the batch shards."""
    weights = (p.router, p.wi_gate, p.wi_up, p.wo)
    rules = current_rules()
    if rules is None:
        return _moe(cfg, x, *weights)
    from torch.distributed.tensor import DTensor
    offset = 0
    if isinstance(p.wi_gate, DTensor):
        from torch.distributed.tensor._utils import \
            compute_local_shape_and_global_offset
        from ..launch.sharding import placements
        w = p.wi_gate
        _, off = compute_local_shape_and_global_offset(
            w.shape, w.device_mesh,
            placements(w.device_mesh, logical_to_spec(_WI)))
        offset = off[0]
    split = {a for a in (rules.get("experts"), rules.get("moe_ffn")) if a}
    batch = rules.get("batch") or ()
    over_batch = {a: "avg" for a in
                  (batch if isinstance(batch, tuple) else (batch,))}

    def layer(*args):
        out, aux = _moe(cfg, *args, expert_offset=offset)
        return (out,) + tuple(aux[k] for k in _AUX)

    out, *aux = local_apply(
        layer, (x,) + weights,
        (("batch", None, None), (None, None), _WI, _WI, _WO),
        (("batch", None, None),) + ((),) * len(_AUX),
        [{a: "sum" for a in split}] + [over_batch] * len(_AUX))
    return out, dict(zip(_AUX, aux))


_AUX = ("load_balance_loss", "expert_imbalance", "dropped_fraction")
_WI = ("experts", None, "moe_ffn")           # (E, d, ff)
_WO = ("experts", "moe_ffn", None)           # (E, ff, d)


def _moe(cfg: ArchConfig, x: torch.Tensor, router: torch.Tensor,
         wi_gate: torch.Tensor, wi_up: torch.Tensor, wo: torch.Tensor,
         expert_offset: int = 0
         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The layer on plain tensors; the weights hold the experts
    ``expert_offset`` .. ``expert_offset + len(wi_gate)`` (all of them but
    on a mesh with expert parallelism)."""
    dt = cdtype(cfg)
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = _capacity(cfg, s)
    dev = x.device

    # float32 routing logits from x and the router in x's dtype
    logits = x.float() @ router.to(x.dtype).float()            # (B,S,E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k_lower_index(probs, k)           # (B,S,K)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(-1, keepdim=True), 1e-9)                  # renormalize

    # ---- slot of each (token, k) within its expert, token-major priority
    sel = F.one_hot(gate_idx, e).to(torch.int32)                # (B,S,K,E)
    flat = sel.reshape(b, s * k, e)
    pos_in_e = torch.cumsum(flat, dim=1) - flat
    pos = (pos_in_e * flat).sum(-1).reshape(b, s, k)            # (B,S,K)
    keep = pos < cap
    dropped = 1.0 - keep.float().mean()

    # ---- inverse map (B, E, C) -> source token (s = the zero pad row);
    # dropped pairs land in the pad column ``cap``, which is cut off
    src = torch.arange(s, device=dev)[None, :, None].expand(b, s, k)
    slot = torch.where(keep, pos, torch.full_like(pos, cap))
    bi = torch.arange(b, device=dev)[:, None, None].expand(b, s, k)
    inv = torch.full((b, e, cap + 1), s, dtype=torch.int64, device=dev)
    inv[bi, gate_idx, slot] = torch.where(keep, src,
                                          torch.full_like(src, s))
    gate_slot = torch.zeros((b, e, cap + 1), dtype=torch.float32,
                            device=dev)
    gate_slot[bi, gate_idx, slot] = torch.where(
        keep, gate_vals, torch.zeros_like(gate_vals))
    held = slice(expert_offset, expert_offset + wi_gate.shape[0])
    inv, gate_slot = inv[:, held, :cap], gate_slot[:, held, :cap]

    # ---- dispatch: gather tokens into (B, E, C, d)
    x_pad = torch.cat([x, x.new_zeros((b, 1, d))], dim=1)
    x_e = x_pad[torch.arange(b, device=dev)[:, None, None], inv]
    x_e = shard_hint(x_e, "batch", "experts", None, "expert_dm")

    # ---- expert FFN
    wig, wiu, wo = wi_gate.to(dt), wi_up.to(dt), wo.to(dt)
    g = torch.einsum("becd,edf->becf", x_e, wig)
    u = torch.einsum("becd,edf->becf", x_e, wiu)
    g = shard_hint(g, "batch", "experts", None, "moe_ffn")
    h = (F.silu(g) if cfg.act == "swiglu" else gelu(g)) * u
    y_e = torch.einsum("becf,efd->becd", h, wo)
    y_e = shard_hint(y_e, "batch", "experts", None, "expert_dm")

    # ---- combine: scatter-add back to token positions with gate weights
    y_w = (y_e * gate_slot[..., None].to(y_e.dtype)).to(dt)
    y_w = shard_hint(y_w, "batch", "experts", None, "moe_out_dm")
    rows = (inv + (s + 1) * torch.arange(b, device=dev)[:, None, None])
    out = torch.zeros((b * (s + 1), d), dtype=dt, device=dev)
    out.index_add_(0, rows.reshape(-1), y_w.reshape(-1, d))
    out = out.reshape(b, s + 1, d)[:, :s]
    out = shard_hint(out, "batch", "act_seq", None)

    # ---- metrics: Switch aux loss + SpChar Eq. 5 imbalance
    counts = sel.sum(dim=(1, 2)).float()                        # (B,E)
    frac_tokens = counts / (s * k)
    mean_prob = probs.mean(dim=1)                               # (B,E)
    aux = (e * (frac_tokens * mean_prob).sum(-1)).mean()
    ideal = counts.sum(-1, keepdim=True) / e
    imbalance = (torch.abs(counts - ideal)
                 / torch.clamp_min(ideal, 1e-9)).mean()         # Eq. 5
    return out, {"load_balance_loss": aux, "expert_imbalance": imbalance,
                 "dropped_fraction": dropped}
