"""The yardstick: the plain reference against a dense float64 product, the
row gap, TF32 rounding, and the work a product needs."""
import math

import numpy as np
import pytest
import torch

from spbench import reference, work
from spbench.metrics import product_roofline


def _csr(n_rows, n_cols, density, seed, empty_rows=()):
    rng = np.random.default_rng(seed)
    dense = (rng.random((n_rows, n_cols)) < density) \
        * rng.standard_normal((n_rows, n_cols))
    dense[list(empty_rows)] = 0.0
    dense = dense.astype(np.float32)
    rows, cols = np.nonzero(dense)
    row_ptrs = np.zeros(n_rows + 1, np.int64)
    np.add.at(row_ptrs, rows + 1, 1)
    return dense, {"row_ptrs": np.cumsum(row_ptrs),
                   "col_idxs": cols.astype(np.uint32),
                   "vals": dense[rows, cols], "shape": (n_rows, n_cols)}


@pytest.mark.parametrize("k", [1, 5])
def test_reference_matches_a_dense_float64_product(k):
    dense, mat = _csr(37, 29, 0.2, seed=k, empty_rows=(0, 11))
    ref = reference.Reference(mat, "cpu")
    ref_blocks = reference.Reference(mat, "cpu")
    x = torch.randn((29,) if k == 1 else (29, k), dtype=torch.float32)
    want = dense.astype(np.float64) @ x.double().numpy()
    y, mag = ref.product(x)
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(mag.numpy(),
                               np.abs(dense.astype(np.float64))
                               @ np.abs(x.double().numpy()), rtol=1e-12)
    # in blocks of a few nonzeros the sums are the same
    old = reference.BLOCK_TERMS
    try:
        reference.BLOCK_TERMS = 7
        y2, _ = ref_blocks.product(x)
    finally:
        reference.BLOCK_TERMS = old
    np.testing.assert_allclose(y2.numpy(), want, rtol=1e-12, atol=1e-12)


def test_row_gap_reads_errors_shapes_nans_and_empty_rows():
    ref = torch.tensor([1.0, -2.0, 0.0], dtype=torch.float64)
    mag = torch.tensor([2.0, 4.0, 0.0], dtype=torch.float64)
    y = torch.tensor([1.0, -2.0, 0.0])
    assert reference.row_gap(y, ref, mag) == 0.0
    y = torch.tensor([1.5, -2.0, 0.0])
    assert reference.row_gap(y, ref, mag) == pytest.approx(0.25)
    assert reference.row_gap(torch.tensor([1.0, -2.0, 1e-30]), ref, mag) \
        == math.inf
    assert reference.row_gap(torch.tensor([1.0, float("nan"), 0.0]), ref,
                             mag) == math.inf
    assert reference.row_gap(torch.zeros(2), ref, mag) == math.inf


def test_tf32_rounds_to_ten_mantissa_bits_ties_to_even():
    ulp = 2.0 ** -10
    x = torch.tensor([1.0, 1 + ulp / 2, 1 + ulp * 1.5, 1 + ulp * 0.51,
                      -(1 + ulp * 0.51), 3.0, 0.0], dtype=torch.float32)
    got = reference.tf32(x).tolist()
    assert got == [1.0, 1.0, 1 + 2 * ulp, 1 + ulp, -(1 + ulp), 3.0, 0.0]


def test_the_control_fails_the_limit_the_float32_product_passes():
    _, mat = _csr(400, 400, 0.03, seed=3)
    ref = reference.Reference(mat, "cpu")
    x = torch.randn(400)
    yr, mag = ref.product(x)
    y32 = yr.float()
    limit = 2e-5
    assert reference.row_gap(y32, yr, mag) < limit
    assert reference.row_gap(ref.control(x), yr, mag) > 10 * limit


def test_needed_work_on_a_hand_checked_csr():
    # 3 x 4, 5 nonzeros, 2 right-hand columns: values 20 B, column
    # indices 20 B, row pointers 16 B, X 32 B, Y 24 B
    assert work.needed(3, 4, 5, 2) == (112, 20)
    assert work.least_seconds(3, 4, 5, 2) == 112 / 3.35e12


def test_the_roofline_counts_the_csr_not_the_container():
    """Two containers of one CSR (BSR blocks of 32 and of 256) differ in
    bytes; the roofline reads the same for the same device time, since
    its count sees only the CSR."""
    from repro_torch.core.autotune import Schedule
    from repro_torch.core.csr import CSR
    from repro_torch.sparse import plan
    _, mat = _csr(300, 300, 0.01, seed=5)
    A = CSR(mat["row_ptrs"], mat["col_idxs"], mat["vals"], mat["shape"])
    held = []
    for bs in (32, 256):
        p = plan("spmv", A, schedule=Schedule("bsr", bs, 1.0), device="cpu")
        held.append(sum(t.numel() * t.element_size()
                        for t in p.operands[0].arrays.values()))
    assert held[1] > 2 * held[0]

    class Ev:
        name, dur, in_execute = "bsr_spmv", 100.0, True

    class Tl:
        n_execute = 4

        def execute_events(self):
            return [Ev()] * 4

    class Ctx:
        timeline = Tl()
        work = {"n_rows": 300, "n_cols": 300,
                "nnz": int(mat["row_ptrs"][-1]), "k": 1}
    got = product_roofline.read(Ctx)
    want = 100 * work.least_seconds(300, 300, Ctx.work["nnz"], 1) / 100e-6
    assert got == pytest.approx(want)
