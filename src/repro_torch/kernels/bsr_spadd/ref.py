"""Plain PyTorch version of the block-union SpADD kernel (twin of
``repro.kernels.bsr_spadd.ref``): ``C.blocks = a_blocks[ia] + b_blocks[ib]``.

It is exact: one fp32 add per element (or an add of the zero sentinel), so
it, the CUDA kernel and the JAX ``jnp`` path agree bit for bit.
"""
from __future__ import annotations

import torch

from ..bsr_spmv.ref import _member_gather


def ref_block_union_add(ia: torch.Tensor, ib: torch.Tensor,
                        a_blocks: torch.Tensor,
                        b_blocks: torch.Tensor) -> torch.Tensor:
    """(n_c,) indices into (n_a+1, bs, bs) / (n_b+1, bs, bs) blocks ->
    (n_c, bs, bs); with a leading member axis on every argument, member b
    is computed from its own arrays."""
    if a_blocks.dim() == 4:
        return _member_gather(a_blocks, ia) + _member_gather(b_blocks, ib)
    return a_blocks[ia.long()] + b_blocks[ib.long()]
