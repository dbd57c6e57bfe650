"""The work a sparse product, or a served model's decode step, needs, whatever
container or kernel computes it.

``Y = A X`` with ``A`` an ``n_rows x n_cols`` CSR of ``nnz`` fp32 values and
``X`` of ``k`` fp32 columns needs ``2 nnz k`` operations and, reading each
input byte once and writing each output byte once: the values (4 bytes
each), the int32 column indices (4 each) and row pointers
(``4 (n_rows + 1)``), X (``4 n_cols k``) and Y (``4 n_rows k``). Its least
time on the card is the larger of bytes over HBM bandwidth and operations
over the fp32 peak. Counts come from the generated CSR alone, never from
the program's container, so a smaller block, another layout or a CSR
kernel is held to the same count.
"""
from __future__ import annotations

from typing import Dict, Tuple

from . import peaks


def needed(n_rows: int, n_cols: int, nnz: int, k: int) -> Tuple[int, int]:
    """(bytes, flops) that one product needs."""
    nbytes = 4 * nnz + 4 * nnz + 4 * (n_rows + 1) + 4 * n_cols * k \
        + 4 * n_rows * k
    return nbytes, 2 * nnz * k


def least_seconds(n_rows: int, n_cols: int, nnz: int, k: int) -> float:
    """The least time one product can take on the card."""
    nbytes, flops = needed(n_rows, n_cols, nnz, k)
    return max(nbytes / peaks.HBM_BYTES_PER_S,
               flops / peaks.FP32_FLOP_PER_S)


def decode_token_flops(m: Dict, attended: int) -> int:
    """The model FLOPs of one generated token of a mixture-of-experts
    decoder of sizes ``m`` (a configuration file's ``model``) whose query
    attends ``attended`` positions in every layer: twice the matrix
    parameters on its path (q, k, v, o, the router, its ``top_k`` experts'
    SwiGLU, the output head), and ``4 H D attended`` a layer for the
    scores and the weighted values. Counted from the sizes alone: padding,
    capacity slots and masked cache slots the program computes are not
    model FLOPs."""
    d, h, kv, dh = m["d_model"], m["n_heads"], m["n_kv_heads"], m["d_head"]
    per_layer = (d * h * dh + 2 * d * kv * dh + h * dh * d
                 + d * m["n_experts"] + m["top_k"] * 3 * d * m["d_ff"])
    return (2 * (m["n_layers"] * per_layer + d * m["vocab_size"])
            + 4 * m["n_layers"] * h * dh * attended)
