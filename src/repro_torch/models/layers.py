"""Shared layers of the LM substrate (port of ``repro.models.layers``):
norms, activations, positions, FFN.

Parameters live in small ``nn.Module``s whose attribute names are the
JAX parameter dicts' keys (``scale``/``bias``, ``wi_gate``/``wi_up``/``wo``),
so a JAX tree carries across name for name (``repro_torch.convert``). The
functions are the reference's, over those modules: parameters are kept in
``cfg.param_dtype`` and cast to ``cfg.compute_dtype`` at each call, with
float32 reductions, as there.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ArchConfig
from .partitioning import shard_hint


def cdtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def pdtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


# ------------------------------------------------------------------- init
def param(shape: Sequence[int], dtype: torch.dtype,
          device: torch.device) -> nn.Parameter:
    """An uninitialised weight: ``Model.init`` writes ``dense_init``'s
    draws into it, or a carried-across state is loaded."""
    return nn.Parameter(torch.empty(tuple(shape), dtype=dtype,
                                    device=device))


def dense_init(t: torch.Tensor, generator: torch.Generator,
               in_axis: int = -2) -> torch.Tensor:
    """Fill ``t`` in place with the reference's ``dense_init``
    distribution: normal with std 1/sqrt(fan_in), fan_in = ``t.shape
    [in_axis]``. The draws are the generator's, not JAX's."""
    std = 1.0 / math.sqrt(t.shape[in_axis])
    with torch.no_grad():
        return t.normal_(0.0, std, generator=generator)


# ------------------------------------------------------------------- norms
class Norm(nn.Module):
    """RMSNorm (``scale``) or LayerNorm (``scale``, ``bias``), initialised
    to ones and zeros as ``init_norm`` is in the reference."""

    def __init__(self, cfg: ArchConfig, d: int, device) -> None:
        super().__init__()
        dt = pdtype(cfg)
        self.scale = nn.Parameter(torch.ones(d, dtype=dt, device=device))
        if cfg.norm == "layernorm":
            self.bias = nn.Parameter(torch.zeros(d, dtype=dt,
                                                 device=device))


def init_norm(cfg: ArchConfig, d: int, device) -> Norm:
    return Norm(cfg, d, device)


def apply_norm(cfg: ArchConfig, p: Norm, x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + 1e-6)
        y = y * p.scale.float() + p.bias.float()
    else:  # rmsnorm
        var = (xf ** 2).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + 1e-6) * p.scale.float()
    return y.to(x.dtype)


def gated_rmsnorm(scale: torch.Tensor, x: torch.Tensor,
                  z: torch.Tensor) -> torch.Tensor:
    """Mamba-2's norm-then-gate: RMSNorm(x) * silu(z)."""
    xf = x.float()
    y = xf * torch.rsqrt((xf ** 2).mean(-1, keepdim=True) + 1e-6)
    return (y * scale.float() * F.silu(z.float())).to(x.dtype)


# --------------------------------------------------------------- softcaps
def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0.0:
        return x
    return cap * torch.tanh(x / cap)


# --------------------------------------------------------------- positions
def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _freqs(half: int, theta: float, device) -> torch.Tensor:
    return theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=device) / half)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Standard rotary embedding. x: (..., S, H, D); positions: (..., S)."""
    half = x.shape[-1] // 2
    ang = positions[..., None].float() * _freqs(half, theta, x.device)
    return _rotate(x, ang)


def mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
          sections: Tuple[int, int, int]) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: the head dim's frequency bands are split
    into (t, h, w) sections, each rotated by its own position stream.
    positions3: (3, ..., S). For text all three streams coincide."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {sections} must sum to the "
                         f"half head dim {half}")
    sec_id = torch.repeat_interleave(
        torch.arange(3, device=x.device),
        torch.as_tensor(sections, device=x.device),
        output_size=half)                                    # (half,)
    pos_sel = torch.movedim(positions3[sec_id], 0, -1)      # (..., S, half)
    ang = pos_sel.float() * _freqs(half, theta, x.device)
    return _rotate(x, ang)


def sinusoidal_positions(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Whisper-style absolute sinusoidal embeddings (frontend stub side)."""
    half = d // 2
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32,
                                    device=positions.device)
                      * math.log(10_000.0) / max(half - 1, 1))
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ------------------------------------------------------------------- FFN
class FFN(nn.Module):
    """Gated (swiglu / geglu: ``wi_gate``, ``wi_up``, ``wo``) or plain
    (gelu: ``wi``, ``wo``) feed-forward weights."""

    def __init__(self, cfg: ArchConfig, device) -> None:
        super().__init__()
        d, ff, dt = cfg.d_model, cfg.d_ff, pdtype(cfg)
        if cfg.act in ("swiglu", "geglu"):
            self.wi_gate = param((d, ff), dt, device)
            self.wi_up = param((d, ff), dt, device)
        else:
            self.wi = param((d, ff), dt, device)
        self.wo = param((ff, d), dt, device)


def init_ffn(cfg: ArchConfig, device) -> FFN:
    return FFN(cfg, device)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def apply_ffn(cfg: ArchConfig, p: FFN, x: torch.Tensor) -> torch.Tensor:
    dt = cdtype(cfg)
    if cfg.act in ("swiglu", "geglu"):
        g = x @ p.wi_gate.to(dt)
        u = x @ p.wi_up.to(dt)
        g = shard_hint(g, "batch", None, "ffn")
        act = F.silu(g) if cfg.act == "swiglu" else gelu(g)
        h = act * u
    else:
        h = gelu(x @ p.wi.to(dt))
        h = shard_hint(h, "batch", None, "ffn")
    out = h @ p.wo.to(dt)
    return shard_hint(out, "batch", None, None)


# ------------------------------------------------------------- conv (stub+)
def causal_depthwise_conv1d(x: torch.Tensor, w: torch.Tensor,
                            tail: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal depthwise conv over (B, S, C) with kernel (K, C).

    Returns (y, new_tail) where tail is the last K-1 inputs (decode state).
    """
    k = w.shape[0]
    if tail is None:
        tail = x.new_zeros(x.shape[:-2] + (k - 1, x.shape[-1]))
    xp = torch.cat([tail, x], dim=-2)                  # (B, S+K-1, C)
    s = x.shape[-2]
    y = sum(xp[..., i: i + s, :] * w[i] for i in range(k))
    new_tail = xp[..., xp.shape[-2] - (k - 1):, :]
    return y.to(x.dtype), new_tail
