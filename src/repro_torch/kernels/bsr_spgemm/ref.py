"""Plain PyTorch versions of the SpGEMM numeric phase (twins of
``repro.kernels.bsr_spgemm.ref``): padded pairs and flat cells.

Each takes an optional leading member axis (``a_blocks`` of shape
(B, n_a, bs, bs); every other argument carries the same leading B). The
gathers are chunked over output blocks (pairs) or cells, each chunk
holding about ``CHUNK_BYTES`` of gathered tiles: taken literally, the JAX
reference gathers (n_c, max_pairs, bs, bs) twice, which at C's full size
is far beyond the card's memory. The function is the same.

On the card these run only to check the kernels; keep
``torch.backends.cuda.matmul.allow_tf32 = False`` there (the default) so
the products stay in full fp32 like the reference.
"""
from __future__ import annotations

import torch

from ..bsr_spmv.ref import cell_rows

CHUNK_BYTES = 256 << 20


def _chunk(n_tiles_per_item: int, bs: int) -> int:
    return max(1, CHUNK_BYTES // (n_tiles_per_item * bs * bs * 4))


def ref_pair_gemm(pair_a: torch.Tensor, pair_b: torch.Tensor,
                  a_blocks: torch.Tensor,
                  b_blocks: torch.Tensor) -> torch.Tensor:
    """C[k] = sum_p a_blocks[pair_a[k, p]] @ b_blocks[pair_b[k, p]]:
    (n_c, mp) pairs -> (n_c, bs, bs)."""
    if a_blocks.dim() == 4:
        return torch.stack([ref_pair_gemm(*m) for m in
                            zip(pair_a, pair_b, a_blocks, b_blocks)])
    n_c, mp = pair_a.shape
    bs = a_blocks.shape[-1]
    out = a_blocks.new_empty((n_c, bs, bs))
    step = _chunk(2 * mp, bs)
    for k0 in range(0, n_c, step):
        pa, pb = pair_a[k0:k0 + step].long(), pair_b[k0:k0 + step].long()
        out[k0:k0 + step] = torch.einsum("kpab,kpbc->kac", a_blocks[pa],
                                         b_blocks[pb])
    return out


def ref_cell_gemm(cell_a: torch.Tensor, cell_b: torch.Tensor,
                  cell_c: torch.Tensor, a_blocks: torch.Tensor,
                  b_blocks: torch.Tensor, n_c_blocks: int) -> torch.Tensor:
    """Cell-flattened numeric phase: C[c] = sum over cells t with
    cell_c[t] == c of a_blocks[cell_a[t]] @ b_blocks[cell_b[t]]."""
    if a_blocks.dim() == 4:
        return torch.stack([ref_cell_gemm(ca, cb, cc, ab, bb, n_c_blocks)
                            for ca, cb, cc, ab, bb in
                            zip(cell_a, cell_b, cell_c, a_blocks, b_blocks)])
    bs = a_blocks.shape[-1]
    out = a_blocks.new_zeros((n_c_blocks, bs, bs))
    step = _chunk(3, bs)
    for t0 in range(0, cell_a.shape[0], step):
        prods = torch.bmm(a_blocks[cell_a[t0:t0 + step].long()],
                          b_blocks[cell_b[t0:t0 + step].long()])
        out.index_add_(0, cell_c[t0:t0 + step].long(), prods)
    return out


def ref_cell_gemm_ptr(cell_a: torch.Tensor, cell_b: torch.Tensor,
                      cell_ptr: torch.Tensor, a_blocks: torch.Tensor,
                      b_blocks: torch.Tensor) -> torch.Tensor:
    """The cells CUDA kernel's exact function: block c sums the cells
    ``cell_ptr[c]:cell_ptr[c+1]`` assigns it; cells past ``cell_ptr[-1]``
    belong to no block. (n_c+1,) pointer -> (n_c, bs, bs)."""
    n_c = cell_ptr.shape[-1] - 1
    ids = cell_rows(cell_ptr, cell_a.shape[-1])   # dead cells -> n_c
    out = ref_cell_gemm(cell_a, cell_b, ids, a_blocks, b_blocks, n_c + 1)
    return out[..., :n_c, :, :]
