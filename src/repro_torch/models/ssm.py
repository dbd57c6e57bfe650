"""Mamba-2 SSD (state-space duality) mixer [arXiv:2405.21060] (port of
``repro.models.ssm``).

Chunked algorithm: the sequence is split into chunks of Q; within a chunk
the output is the masked-decay "attention" form (quadratic in Q only), and
chunk-to-chunk information flows through the (H, N, P) state carried by a
Python loop over the chunks. Decode is the pure recurrence. Under autograd
each chunk step runs under ``torch.utils.checkpoint`` with nothing saved
(the reference remats its scan body with ``nothing_saveable``), so the
(B, Q, Q, H) decay matrix is recomputed in the backward pass instead of
being kept per chunk.

One deliberate divergence: the reference forms the intra-chunk decay as
``where(tri, exp(li), 0)``, which takes ``exp`` of the positive upper
triangle too. Over a chunk of 256 steps that overflows to inf, and the
backward pass then multiplies the masked zero cotangent by it (0 * inf =
NaN). Here ``li`` is set to -inf above the diagonal before the ``exp``: the
values are the same (exp(-inf) = 0) and the gradient stays finite.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from .layers import (causal_depthwise_conv1d, cdtype, gated_rmsnorm, param,
                     pdtype)
from .partitioning import local_apply, shard_hint


class SSD(nn.Module):
    """The mixer's weights: ``w_in`` (to [z, x, B, C, dt]), ``conv_w`` over
    [x, B, C], ``a_log`` (A = -exp(a_log)), ``dt_bias``, ``d_skip``,
    ``norm_scale`` and ``w_out``; the constants start as the reference's
    ``init_ssd`` sets them."""

    def __init__(self, cfg: ArchConfig, device) -> None:
        super().__init__()
        d, din = cfg.d_model, cfg.ssm_d_inner
        h, n = cfg.ssm_heads, cfg.ssm_state
        dt = pdtype(cfg)
        self.w_in = param((d, 2 * din + 2 * n + h), dt, device)
        self.conv_w = param((cfg.conv_kernel, din + 2 * n), dt, device)
        self.conv_w.init_std = 0.1           # normal * 0.1, not dense_init
        self.a_log = nn.Parameter(torch.zeros(h, dtype=dt, device=device))
        self.dt_bias = nn.Parameter(torch.full((h,), -1.0, dtype=dt,
                                               device=device))
        self.d_skip = nn.Parameter(torch.ones(h, dtype=dt, device=device))
        self.norm_scale = nn.Parameter(torch.ones(din, dtype=dt,
                                                  device=device))
        self.w_out = param((din, d), dt, device)


def init_ssd(cfg: ArchConfig, device) -> SSD:
    return SSD(cfg, device)


def _split_proj(cfg: ArchConfig, proj: torch.Tensor):
    din, n, h = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
    return torch.split(proj, [din, din, n, n, h], dim=-1)


def _dt_lin(dt_log_decay: torch.Tensor) -> torch.Tensor:
    """The input scale from the (negative) log decay: da = dt * A with
    A = -exp(a_log), and its magnitude is used as the ZOH input scale
    u_j = dt_j x_j (the per-head constant absorbed into W_in's dt head), as
    in the reference."""
    return -dt_log_decay


def _chunk_step(h_prev, x_k, dt_k, b_k, c_k):
    """One chunk. x_k (B,Q,H,P), dt_k (B,Q,H) log-decays, b_k / c_k
    (B,Q,N), h_prev (B,H,N,P). Returns (h_new, y (B,Q,H,P))."""
    q = x_k.shape[1]
    cum = torch.cumsum(dt_k, dim=1)                       # inclusive (B,Q,H)
    # intra-chunk: L[i,j] = exp(cum_i - cum_j) for i >= j, 0 above
    li = cum[:, :, None, :] - cum[:, None, :, :]          # (B,Q,Q,H)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x_k.device))
    l_mat = torch.exp(li.masked_fill(~tri[None, :, :, None], float("-inf")))
    scores = torch.einsum("bin,bjn->bij", c_k, b_k)       # (B,Q,Q)
    # input enters scaled by dt (ZOH-lite): u_j = dt_j * x_j
    u = x_k * _dt_lin(dt_k)[..., None]                    # (B,Q,H,P)
    y_intra = torch.einsum("bijh,bjhp->bihp", scores[..., None] * l_mat, u)
    # inter-chunk: the incoming state, decayed to i
    y_inter = torch.einsum("bin,bhnp,bih->bihp", c_k, h_prev, torch.exp(cum))
    # new state: h = exp(total) h_prev + sum_j exp(cum_last - cum_j) B_j u_j
    total = cum[:, -1]                                    # (B,H)
    decay_to_end = torch.exp(total[:, None] - cum)        # (B,Q,H)
    h_new = (torch.exp(total)[:, :, None, None] * h_prev
             + torch.einsum("bjn,bjh,bjhp->bhnp", b_k, decay_to_end, u))
    return h_new, y_intra + y_inter


_BHNP = ("batch", "heads", None, None)
_BQHP = ("batch", None, "heads", None)


def _local_chunk_step(h_prev, x_k, dt_k, b_k, c_k):
    """``_chunk_step``, on a mesh on each (batch, head) shard alone."""
    return local_apply(_chunk_step, (h_prev, x_k, dt_k, b_k, c_k),
                       (_BHNP, _BQHP, _BQHP[:3], ("batch", None, None),
                        ("batch", None, None)), (_BHNP, _BQHP))


def _chunk_scan(cfg: ArchConfig, x, dt, bmat, cmat, h0):
    """Chunked SSD. x: (B,S,H,P); dt: (B,S,H); bmat/cmat: (B,S,N).

    Returns (y (B,S,H,P), h_final (B,H,N,P)). Single B/C group (G=1) as in
    mamba2-780m; decay per step a_t = exp(dt_t * A_h).
    """
    s = x.shape[1]
    q = min(cfg.ssm_chunk, s)
    if s % q:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"SSD chunk {q}")
    remat = torch.is_grad_enabled()
    h, ys = h0, []
    for c0 in range(0, s, q):
        args = (h, x[:, c0:c0 + q], dt[:, c0:c0 + q], bmat[:, c0:c0 + q],
                cmat[:, c0:c0 + q])
        h, y = (checkpoint(_local_chunk_step, *args, use_reentrant=False)
                if remat else _local_chunk_step(*args))
        ys.append(y)
    return torch.cat(ys, dim=1), h


def apply_ssd(cfg: ArchConfig, p: SSD, u: torch.Tensor, *,
              cache: Optional[Dict] = None, pos=None
              ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Full mixer: in_proj -> conv -> SSD -> gated norm -> out_proj.

    Train/prefill: u (B,S,d), cache None or initial. Decode: u (B,1,d) with
    cache {"h": (B,H,N,P), "conv": (B,K-1,conv_dim)}. Returns (out, the new
    cache or None)."""
    dt_ = cdtype(cfg)
    b, s, _ = u.shape
    din, n, h = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
    phead = cfg.ssm_head_dim
    proj = u @ p.w_in.to(dt_)
    z, x, bmat, cmat, dt_raw = _split_proj(cfg, proj)
    conv_in = torch.cat([x, bmat, cmat], dim=-1)
    tail = cache["conv"] if cache is not None else None
    conv_out, new_tail = causal_depthwise_conv1d(conv_in, p.conv_w.to(dt_),
                                                 tail)
    conv_out = F.silu(conv_out)
    x, bmat, cmat = torch.split(conv_out, [din, n, n], dim=-1)
    x = shard_hint(x.reshape(b, s, h, phead), "batch", None, "heads", None)
    a = -torch.exp(p.a_log.float())                       # (H,) < 0
    dt_pos = F.softplus(dt_raw.float() + p.dt_bias.float())  # (B,S,H)
    da = dt_pos * a                                       # (B,S,H) < 0

    h0 = (cache["h"] if cache is not None
          else torch.zeros((b, h, n, phead), device=u.device))
    if s == 1 and cache is not None:  # decode recurrence
        # input scale matches _chunk_scan's u_j = x_j * (-da_j)
        u_in = x[:, 0].float() * (-da[:, 0])[:, :, None]   # (B,H,P)
        h_new = (torch.exp(da[:, 0])[..., None, None] * h0
                 + torch.einsum("bn,bhp->bhnp", bmat[:, 0].float(), u_in))
        y = torch.einsum("bn,bhnp->bhp", cmat[:, 0].float(), h_new)
        y = y[:, None]                                     # (B,1,H,P)
        h_f = h_new
    else:
        y, h_f = _chunk_scan(cfg, x.float(), da, bmat.float(), cmat.float(),
                             h0)
    y = y + x.float() * p.d_skip.float()[None, None, :, None]
    y = y.reshape(b, s, din).to(dt_)
    y = gated_rmsnorm(p.norm_scale, y, z)
    out = y @ p.w_out.to(dt_)
    out = shard_hint(out, "batch", None, None)
    new_cache = {"h": h_f, "conv": new_tail} if cache is not None else None
    return out, new_cache


def init_ssd_cache(cfg: ArchConfig, batch: int, dtype: torch.dtype,
                   device) -> Dict[str, torch.Tensor]:
    conv_dim = cfg.ssm_d_inner + 2 * cfg.ssm_state
    return {
        "h": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_state,
                          cfg.ssm_head_dim), device=device),
        "conv": torch.zeros((batch, cfg.conv_kernel - 1, conv_dim),
                            dtype=dtype, device=device),
    }
