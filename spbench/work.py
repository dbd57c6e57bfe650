"""The work a sparse product needs, whatever container or kernel computes it.

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

from typing import Tuple

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
