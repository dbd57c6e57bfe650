"""RG-LRU recurrent block (Griffin / RecurrentGemma) [arXiv:2402.19427]
(port of ``repro.models.rglru``).

Recurrence:  r_t = sigmoid(W_a x_t);  i_t = sigmoid(W_x x_t)
             a_t = exp(-c * softplus(Lambda) * r_t),  c = 8
             h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Train/prefill runs the recurrence as a log-depth scan over the sequence:
the reference's ``jax.lax.associative_scan`` with the same ``combine``
(a1*a2, b1*a2 + b2) becomes a Hillis-Steele scan, ceil(log2 S) elementwise
passes over (B, S, W) (``linear_scan``), not a Python loop over S. Decode
is a single step. The block wraps the recurrence with the Griffin residual
structure: x -> [linear -> conv1d -> RG-LRU] * gelu (gate branch) ->
linear out.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ArchConfig
from .layers import causal_depthwise_conv1d, cdtype, gelu, param, pdtype
from .partitioning import local_apply, shard_hint

RGLRU_C = 8.0


class RGLRU(nn.Module):
    """The block's weights: ``w_x`` (recurrent branch), ``w_gate`` (gelu
    gate), ``conv_w``, ``w_a`` (recurrence gate), ``w_i`` (input gate),
    ``lam`` (Lambda, 2.0 at init) and ``w_out``."""

    def __init__(self, cfg: ArchConfig, device) -> None:
        super().__init__()
        d = cfg.d_model
        w = cfg.lru_width or d
        dt = pdtype(cfg)
        self.w_x = param((d, w), dt, device)
        self.w_gate = param((d, w), dt, device)
        self.conv_w = param((cfg.conv_kernel, w), dt, device)
        self.conv_w.init_std = 0.1           # normal * 0.1, not dense_init
        self.w_a = param((w, w), dt, device)
        self.w_i = param((w, w), dt, device)
        self.lam = nn.Parameter(torch.full((w,), 2.0, dtype=dt,
                                           device=device))
        self.w_out = param((w, d), dt, device)


def init_rglru(cfg: ArchConfig, device) -> RGLRU:
    return RGLRU(cfg, device)


def linear_scan(a: torch.Tensor, b: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of h_t = a_t h_{t-1} + b_t along dim 1 (h_{-1} = 0),
    Hillis-Steele: pass k combines each element with the one 2^k before it
    by (a1, b1) . (a2, b2) = (a1 a2, b1 a2 + b2). Returns (the products of
    a, h)."""
    s = a.shape[1]
    d = 1
    while d < s:
        a_prev = F.pad(a[:, :-d], (0, 0, d, 0), value=1.0)
        b_prev = F.pad(b[:, :-d], (0, 0, d, 0), value=0.0)
        a, b = a_prev * a, b_prev * a + b
        d *= 2
    return a, b


_BSW = ("batch", None, "ffn")


def _rglru_core(p: RGLRU, x: torch.Tensor, h0: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, W) -> (y (B, S, W), h_final (B, W)). float32 math."""
    xf = x.float()
    r = torch.sigmoid(xf @ p.w_a.float())
    i = torch.sigmoid(xf @ p.w_i.float())
    log_a = -RGLRU_C * F.softplus(p.lam.float()) * r
    a = torch.exp(log_a)                                 # (B,S,W) in (0,1)
    b = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (i * xf)
    if h0 is not None:
        # fold the initial state in as a virtual step 0
        a = torch.cat([torch.ones_like(a[:, :1]), a], dim=1)
        b = torch.cat([h0[:, None].float(), b], dim=1)
    # on a mesh each (batch, channel) shard scans alone
    _, h = local_apply(linear_scan, (a, b), (_BSW, _BSW), (_BSW, _BSW))
    if h0 is not None:
        h = h[:, 1:]
    return h, h[:, -1]


def apply_rglru(cfg: ArchConfig, p: RGLRU, u: torch.Tensor, *,
                cache: Optional[Dict] = None, pos=None
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """u: (B, S, d). cache: {"h": (B, W), "conv": (B, K-1, W)} for
    prefill and decode. Returns (out, the new cache or None)."""
    dt = cdtype(cfg)
    x = u @ p.w_x.to(dt)
    x = shard_hint(x, "batch", None, "ffn")
    gate = gelu(u @ p.w_gate.to(dt))
    tail = cache["conv"] if cache is not None else None
    x, new_tail = causal_depthwise_conv1d(x, p.conv_w.to(dt), tail)
    h0 = cache["h"] if cache is not None else None
    if u.shape[1] == 1 and cache is not None:  # decode single step
        xf = x[:, 0].float()
        r = torch.sigmoid(xf @ p.w_a.float())
        i = torch.sigmoid(xf @ p.w_i.float())
        a = torch.exp(-RGLRU_C * F.softplus(p.lam.float()) * r)
        h_new = a * h0.float() \
            + torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (i * xf)
        y = h_new[:, None]
        h_f = h_new
    else:
        y, h_f = _rglru_core(p, x, h0)
    y = (y.to(dt) * gate) @ p.w_out.to(dt)
    y = shard_hint(y, "batch", None, None)
    new_cache = {"h": h_f, "conv": new_tail} if cache is not None else None
    return y, new_cache


def init_rglru_cache(cfg: ArchConfig, batch: int, dtype: torch.dtype,
                     device) -> Dict[str, torch.Tensor]:
    w = cfg.lru_width or cfg.d_model
    return {"h": torch.zeros((batch, w), device=device),
            "conv": torch.zeros((batch, cfg.conv_kernel - 1, w),
                                dtype=dtype, device=device)}
