"""The plain reference and the comparison that decides ``correct``.

The reference is the textbook CSR product, ``y_i = sum_j a_ij x_j``, in
plain PyTorch on the benchmark's own generated arrays (values, column
indices, row pointers), in float64 and in blocks of nonzeros so that it
fits beside what the card still holds. It imports nothing of the program
and takes nothing the program made.

Each kept product is judged row by row: the gap of row ``i`` is
``|y_i - ref_i| / sum_j |a_ij x_j|``, the error measured against the
largest rounding the row's own terms allow (a ratio that cancellation
cannot blow up). ``prod_gap`` is the widest gap over the rows of every
kept product; a row whose terms are all zero must read exactly zero.
A result of the wrong shape, or a NaN, reads infinity.

The control is the same product in TF32, the step below float32 on this
card: values and inputs rounded to TF32's 10-bit mantissa, products
(exact in float32) summed in float32, as a tensor-core product with TF32
on would compute them.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

# nonzeros x columns per block of the reference (float64 terms: 128 MiB)
BLOCK_TERMS = 1 << 24


def tf32(t):
    """``t`` (float32) rounded to TF32, to nearest with ties to even."""
    import torch
    i = t.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & -0x2000
    return i.view(torch.float32)


class Reference:
    def __init__(self, mat: Dict, device) -> None:
        import torch
        self.device = torch.device(device)
        self.shape = tuple(int(s) for s in mat["shape"])
        rp = torch.as_tensor(np.asarray(mat["row_ptrs"], np.int64),
                             device=self.device)
        self.cols = torch.as_tensor(np.asarray(mat["col_idxs"], np.int64),
                                    device=self.device)
        self.vals = torch.as_tensor(np.asarray(mat["vals"], np.float32),
                                    device=self.device)
        self.rows = torch.repeat_interleave(
            torch.arange(self.shape[0], device=self.device), rp[1:] - rp[:-1])

    def _out(self, x, dtype):
        import torch
        return torch.zeros((self.shape[0],) + tuple(x.shape[1:]),
                           dtype=dtype, device=self.device)

    def _blocks(self, x):
        k = 1 if x.dim() == 1 else x.shape[1]
        step = max(BLOCK_TERMS // k, 1)
        for a in range(0, self.vals.numel(), step):
            yield slice(a, a + step)

    def product(self, x):
        """(y, |terms| summed per row), both float64."""
        import torch
        x64 = x.to(self.device, torch.float64)
        y, mag = self._out(x, torch.float64), self._out(x, torch.float64)
        for s in self._blocks(x):
            v = self.vals[s].double()
            terms = x64[self.cols[s]] * (v if x.dim() == 1 else v[:, None])
            y.index_add_(0, self.rows[s], terms)
            mag.index_add_(0, self.rows[s], terms.abs())
        return y, mag

    def control(self, x):
        """The same product in TF32: the control, in the program's place."""
        import torch
        xt = tf32(x.to(self.device, torch.float32))
        vt = tf32(self.vals)
        y = self._out(x, torch.float32)
        for s in self._blocks(x):
            v = vt[s] if x.dim() == 1 else vt[s][:, None]
            y.index_add_(0, self.rows[s], xt[self.cols[s]] * v)
        return y


def row_gap(y, ref, mag) -> float:
    """The widest gap of ``y`` against ``ref`` over its rows (see above)."""
    import torch
    if tuple(y.shape) != tuple(ref.shape):
        return math.inf
    diff = (y.to(ref.device, torch.float64) - ref).abs()
    if not bool(torch.isfinite(diff).all()):
        return math.inf
    zero = mag == 0
    if bool((diff[zero] != 0).any()):
        return math.inf
    return float((diff / torch.where(zero, 1.0, mag)).max()) \
        if diff.numel() else 0.0


def judge(ref: Reference, samples: List[Tuple], limits: Dict,
          ops: int, failed: int) -> Tuple[bool, Dict]:
    """``correct`` and each number compared beside its limit."""
    gap = 0.0
    for x, y in samples:
        yr, mag = ref.product(x)
        gap = max(gap, row_gap(y, yr, mag))
    checks = {
        "prod_gap": {"value": gap, "limit": limits["prod_gap"]},
        "products_checked": {"value": len(samples),
                             "limit": limits["min_products"]},
        "failed_ops": {"value": failed, "limit": 0},
    }
    correct = (gap <= limits["prod_gap"]
               and len(samples) >= limits["min_products"]
               and failed == 0 and ops > 0)
    return correct, checks
