"""Gradient compression with error feedback (port of
``repro.optim.compression``), on dicts of tensors.

bf16 compression with float32 error feedback: the quantization residual is
carried to the next step so compression error does not accumulate. int8
mode adds per-tensor scaling (rounding half to even, as ``jnp.round``
does). The returned values are the dequantized float32 representatives.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

Tree = Dict[str, torch.Tensor]


def compress_tree(grads: Tree, error: Tree, mode: str = "bf16"
                  ) -> Tuple[Tree, Tree]:
    """Returns (compressed float32 view, new error)."""
    if mode == "none":
        return grads, error
    if mode not in ("bf16", "int8"):
        raise ValueError(mode)
    comp, err = {}, {}
    for k, g in grads.items():
        gf = g.float() + error[k]
        if mode == "bf16":
            q = gf.to(torch.bfloat16).float()
        else:
            scale = torch.clamp_min(gf.abs().max(), 1e-12) / 127.0
            q = torch.round(gf / scale).to(torch.int8).float() * scale
        comp[k], err[k] = q, gf - q
    return comp, err


def decompress_tree(comp: Tree) -> Tree:
    return comp  # representatives are already dequantized float32


def init_error(params: Tree) -> Tree:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}
