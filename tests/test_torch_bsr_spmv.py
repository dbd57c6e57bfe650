"""The port's ELL/SELL-BSR SpMV/SpMM kernels held against the JAX package:
the plain PyTorch versions (what the wrappers compute on CPU tensors) match
the JAX ``ref_*`` oracles AND the Pallas kernels run with
``interpret=True``, on the shapes of ``tests/test_kernels.py``; the stacked
member form equals the per-member form; the wrappers' CUDA branch raises
on a failed launch and never falls back; and the package imports neither
jax nor ``repro``. The kernels themselves run on the card in
``test_torch_cuda.py``."""
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BSR as JBSR
from repro.core import CSR as JCSR
from repro.core import ELLBSR as JELLBSR
from repro.kernels.bsr_spmv import kernel as jk
from repro.kernels.bsr_spmv import ref as jref
from repro.sparse import SparseTensor as JSparseTensor
from repro.sparse import plan as jplan
from repro.sparse import plan_bucket as jplan_bucket
from repro.sparse.resilience import GuardedExecutor
from repro.core.autotune import Schedule as JSchedule
from repro_torch.core import (BSR, CSR, ELLBSR, SELLBSR, Schedule,
                              spmm_oracle, spmv_oracle)
from repro_torch.core.synthetic import gen_zipf
from repro_torch.kernels import common
from repro_torch.kernels.bsr_spmv import kernel as K
from repro_torch.kernels.bsr_spadd import kernel as AK
from repro_torch.kernels.bsr_spgemm import kernel as GK
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.bsr_spmv import ops, ref
from repro_torch.sparse import GuardedExecutor as TGuardedExecutor
from repro_torch.sparse import (PreparedStore, SparseTensor, content_key,
                                plan, plan_bucket)
from repro_torch.sparse.ops_builtin import (_build_matvec_bucket,
                                           _pad_member_axis, _stack_resident,
                                           _member_tensors)

ELL_SHAPES = [(64, 8), (100, 16), (257, 32), (96, 96)]
SELL_SHAPES = [(64, 8, 2, 8), (100, 16, 4, 2), (257, 32, 3, 1000),
               (96, 96, 8, 64)]
K_ODD = 5


def _dense(n, m, density, seed):
    rng = np.random.default_rng(seed)
    d = (rng.random((n, m)) < density) * rng.standard_normal((n, m))
    return d.astype(np.float32)


def _x_blocks(x, n_bc, bs):
    xb = np.zeros((n_bc * bs,) + x.shape[1:], np.float32)
    xb[: x.shape[0]] = x
    return xb.reshape((n_bc, bs) + x.shape[1:])


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _ell_case(n, bs, multi):
    d = _dense(n, n, 0.06, n)
    ell = ELLBSR.from_bsr(BSR.from_csr(CSR.from_dense(d), bs))
    jell = JELLBSR.from_bsr(JBSR.from_csr(JCSR.from_dense(d), bs))
    np.testing.assert_array_equal(ell.block_indices, jell.block_indices)
    np.testing.assert_array_equal(ell.blocks, jell.blocks)
    rng = np.random.default_rng(n + bs)
    x = rng.standard_normal((n, K_ODD) if multi else n).astype(np.float32)
    return d, ell, _x_blocks(x, -(-n // bs), bs), x


@pytest.mark.parametrize("n,bs", ELL_SHAPES)
@pytest.mark.parametrize("multi", [False, True])
def test_ell_plain_matches_jax_ref_and_interpret(n, bs, multi):
    d, ell, xb, x = _ell_case(n, bs, multi)
    args = (ell.block_indices, ell.block_cols, ell.blocks, xb)
    fn = K.bsr_spmm_cuda if multi else K.bsr_spmv_cuda     # CPU: plain
    y = fn(*(_t(a) for a in args), valid_counts=_t(ell.valid_counts)).numpy()
    jr = (jref.ref_bsr_spmm if multi else jref.ref_bsr_spmv)(
        *(jnp.asarray(a) for a in args))
    ji = (jk.bsr_spmm_pallas if multi else jk.bsr_spmv_pallas)(
        *(jnp.asarray(a) for a in args), interpret=True)
    np.testing.assert_allclose(y, np.asarray(jr), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(y, np.asarray(ji), rtol=2e-5, atol=2e-5)
    flat = y.reshape((-1,) + x.shape[1:])[:n]
    np.testing.assert_allclose(flat, d.astype(np.float64) @ x, rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("n,bs,C,sigma", SELL_SHAPES)
@pytest.mark.parametrize("multi", [False, True])
def test_sell_plain_matches_jax_ref_and_interpret(n, bs, C, sigma, multi):
    d = _dense(n, n, 0.06, n)
    sell = SELLBSR.from_bsr(BSR.from_csr(CSR.from_dense(d), bs), C, sigma)
    rng = np.random.default_rng(n + bs)
    x = rng.standard_normal((n, K_ODD) if multi else n).astype(np.float32)
    xb = _x_blocks(x, -(-n // bs), bs)
    cb, cc, ptr, perm, blocks, cv = ops.sell_device_arrays(sell,
                                                           device="cpu")
    fn = K.bsr_spmm_sell_cuda if multi else K.bsr_spmv_sell_cuda
    y = fn(cb, cc, ptr, perm, blocks, _t(xb), cell_valid=cv).numpy()
    jargs = (jnp.asarray(sell.cell_block), jnp.asarray(sell.cell_col),
             jnp.asarray(sell.cell_row), jnp.asarray(sell.blocks),
             jnp.asarray(xb))
    n_br = sell.n_block_rows
    jr = (jref.ref_bsr_spmm_sell if multi else jref.ref_bsr_spmv_sell)(
        *jargs, n_br)
    ji = (jk.bsr_spmm_sell_pallas if multi else jk.bsr_spmv_sell_pallas)(
        *jargs, n_br, interpret=True)
    for y_sorted in (np.asarray(jr), np.asarray(ji)):
        want = np.zeros_like(y_sorted)
        want[sell.row_perm] = y_sorted            # the scatter JAX does after
        np.testing.assert_allclose(y, want, rtol=1e-4, atol=1e-4)
    # the sorted segment sum itself (cell_row form) matches the JAX ref
    ys = (ref.ref_bsr_spmm_sell if multi else ref.ref_bsr_spmv_sell)(
        _t(sell.cell_block), _t(sell.cell_col), _t(sell.cell_row),
        _t(sell.blocks), _t(xb), n_br).numpy()
    np.testing.assert_allclose(ys, np.asarray(jr), rtol=1e-4, atol=1e-4)


def test_cell_ptr_round_trips_cell_row():
    """The row pointer the SELL kernels walk encodes exactly ``cell_row``,
    bucket pad cells (extending the last row) and empty pad rows too."""
    sell = SELLBSR.from_bsr(BSR.from_csr(gen_zipf(300, seed=2), 32), 4, 8)
    cr = np.concatenate([sell.cell_row, np.full(5, sell.cell_row[-1])])
    ptr = ops.sell_cell_ptr(cr, sell.n_block_rows + 3)
    assert ptr[0] == 0 and ptr[-1] == cr.size
    assert (ptr[-4:] == cr.size).all()            # 3 pad rows own no cells
    np.testing.assert_array_equal(ref.cell_rows(_t(ptr), cr.size).numpy(),
                                  cr)


@pytest.mark.parametrize("layout", ["ell", "sell"])
@pytest.mark.parametrize("multi", [False, True])
def test_stacked_members_equal_per_member(layout, multi):
    """The member axis computes member b from its own arrays (per-member
    zero-block index, per-member row permutation)."""
    bs, k = 16, 8
    mats = [gen_zipf(n, seed=10 + n) for n in (96, 80, 64)]
    hosts = [(ELLBSR.from_bsr(BSR.from_csr(m, bs)) if layout == "ell"
              else SELLBSR.from_bsr(BSR.from_csr(m, bs), 2, 4))
             for m in mats]
    sched = (Schedule("bsr", bs, 1.0) if layout == "ell" else
             Schedule("bsr", bs, 1.0, layout="sell", slice_height=2))
    built = _pad_member_axis(_build_matvec_bucket(
        hosts, sched, 4, True, torch.device("cpu")), 4)
    arrs = built["arrays"]
    n_bc = built["width"] // bs
    rng = np.random.default_rng(3)
    xs = np.zeros((4, n_bc, bs) + ((k,) if multi else ()), np.float32)
    for i, m in enumerate(mats):
        x = rng.standard_normal((m.shape[1], k) if multi else m.shape[1])
        xs[i] = _x_blocks(x.astype(np.float32), n_bc, bs)
    names = (("block_indices", "block_cols") if layout == "ell" else
             ("cell_block", "cell_col", "cell_ptr", "row_perm"))
    fn = {("ell", False): K.bsr_spmv_cuda, ("ell", True): K.bsr_spmm_cuda,
          ("sell", False): K.bsr_spmv_sell_cuda,
          ("sell", True): K.bsr_spmm_sell_cuda}[(layout, multi)]
    count = "valid_counts" if layout == "ell" else "cell_valid"
    stacked = fn(*(arrs[n] for n in names), arrs["blocks"], _t(xs),
                 **{count: arrs[count]})
    for b in range(4):
        one = fn(*(arrs[n][b] for n in names), arrs["blocks"][b],
                 _t(xs[b]), **{count: arrs[count][b]})
        np.testing.assert_array_equal(stacked[b].numpy(), one.numpy())
    assert not stacked[3].any()                   # the zero member
    for b, m in enumerate(mats):
        got = stacked[b].reshape((-1,) + xs.shape[3:])[: m.shape[0]]
        xv = xs[b].reshape((-1,) + xs.shape[3:])[: m.shape[1]]
        want = (spmm_oracle(m, xv) if multi else spmv_oracle(m, xv))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_oracles_match_dense_without_densifying():
    m = gen_zipf(200, seed=5)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(200)
    X = rng.standard_normal((200, 3))
    d = m.to_dense().astype(np.float64)
    np.testing.assert_allclose(spmv_oracle(m, x), d @ x, rtol=1e-12,
                               atol=1e-10)
    np.testing.assert_allclose(spmm_oracle(m, X), d @ X, rtol=1e-12,
                               atol=1e-10)


# ------------------------------- valid_counts: the real slots of a row

def _assert_real_prefix(idx, counts, zero):
    """Slots ``[:counts[r]]`` of row r hold real blocks, the rest the zero
    block."""
    slot = np.arange(idx.shape[-1])
    real = slot[None, :] < counts[:, None]
    assert (idx[real] != zero).all() and (idx[~real] == zero).all()


@pytest.mark.parametrize("shape_bucket", [False, True])
@pytest.mark.parametrize("n,bs", [(100, 16), (257, 32), (300, 64)])
def test_valid_counts_match_jax_and_mark_the_real_prefix(n, bs,
                                                         shape_bucket):
    csr = gen_zipf(n, seed=n)
    jcsr = JCSR(csr.row_ptrs, csr.col_idxs, csr.nnz_vals, csr.shape)
    st = SparseTensor.from_csr(csr, block_size=bs,
                               shape_bucket=shape_bucket, device="cpu")
    jst = JSparseTensor.from_csr(jcsr, block_size=bs,
                                 shape_bucket=shape_bucket)
    vc = st.arrays["valid_counts"].numpy()
    np.testing.assert_array_equal(vc, np.asarray(jst.arrays["valid_counts"]))
    assert vc.dtype == np.int32
    _assert_real_prefix(st.arrays["block_indices"].numpy(), vc, st._zero_idx)


@pytest.mark.parametrize("resident", [False, True])
@pytest.mark.parametrize("shape_bucket", [False, True])
def test_bucket_valid_counts_are_per_member(resident, shape_bucket):
    """Stacked buckets of unequal members, built from host containers or
    from the members' resident tensors: member b's counts are its own
    (its pad rows 0) and mark the real prefix against its own zero block;
    the padded zero members own no slot."""
    bs = 16
    mats = [gen_zipf(n, seed=n) for n in (120, 90, 64)]
    sched = Schedule("bsr", bs, 1.0)
    dev = torch.device("cpu")
    if resident:
        sts = _member_tensors(mats, sched, 4, shape_bucket,
                              PreparedStore(), [content_key(m) for m in mats],
                              dev)
        built = _stack_resident(sts, shape_bucket)
    else:
        built = _build_matvec_bucket(mats, sched, 4, shape_bucket, dev)
    arrs = _pad_member_axis(built, 4)["arrays"]
    vc, idx = arrs["valid_counts"].numpy(), arrs["block_indices"].numpy()
    assert vc.shape == idx.shape[:2] and vc.dtype == np.int32
    for b, m in enumerate(mats):
        jell = JELLBSR.from_bsr(JBSR.from_csr(
            JCSR(m.row_ptrs, m.col_idxs, m.nnz_vals, m.shape), bs))
        own = np.asarray(jell.valid_counts)
        np.testing.assert_array_equal(vc[b, : own.size], own)
        assert not vc[b, own.size:].any()
        _assert_real_prefix(idx[b], vc[b], jell.blocks.shape[0] - 1)
    assert not vc[3].any()                        # the zero member


def _two_block_csr(n, bs, rng):
    """Block-rows 0..n_br-2 hold two real blocks (columns r and r + 1) and
    no ELL pad slot; the last one holds one real block and one pad slot."""
    n_br = -(-n // bs)
    d = np.zeros((n, n), np.float32)
    for r in range(n_br):
        for c in (r, r + 1):
            d[r * bs:(r + 1) * bs, c * bs:(c + 1) * bs] = rng.standard_normal(
                d[r * bs:(r + 1) * bs, c * bs:(c + 1) * bs].shape)
    return CSR.from_dense(d)


def _assert_plan_ell_nonfinite_matches_jax(op, bad, where, cols):
    """The port's ELL plan and the JAX facade's (jnp), both with their NaN
    guards off (on, each would raise NonFiniteOutput), on x with ``bad`` at row 3 (in x[0:bs],
    which every pad slot reads) or in a real block's row, at the column
    index ``cols`` (``()`` for SpMV)."""
    n, bs = 200, 16
    n_br = -(-n // bs)
    rng = np.random.default_rng(0)
    csr = _two_block_csr(n, bs, rng)
    jcsr = JCSR(csr.row_ptrs, csr.col_idxs, csr.nnz_vals, csr.shape)
    x = rng.standard_normal((n, 3) if op == "spmm" else n).astype(np.float32)
    x[(3 if where == "first_block" else 5 * bs + 2,) + cols] = bad
    y = plan(op, (csr,), schedule=Schedule("bsr", bs, 1.0),
             shape_bucket=False, device="cpu",
             executor=TGuardedExecutor(nan_guard=False)).execute(x).numpy()
    jy = np.asarray(jplan(op, (jcsr,), schedule=JSchedule("bsr", bs, 1.0),
                          backend="jnp", shape_bucket=False,
                          executor=GuardedExecutor(nan_guard=False)
                          ).execute(x))
    _assert_nonfinite_equal(y, jy)
    fin = np.isfinite(jy)
    assert (~fin).any() and fin.any()
    # the last block-row reads x[0:bs] only through its pad slot
    assert np.isnan(y[(n_br - 1) * bs:]).any() == (where == "first_block")
    return y


@pytest.mark.parametrize("bad", [np.nan, np.inf])
@pytest.mark.parametrize("where", ["first_block", "real_column"])
def test_plan_spmv_ell_nonfinite_x_matches_jax(bad, where):
    """A NaN or an Inf in x[0:bs] (the column every ELL pad slot reads) or
    in a real column gives the JAX facade's NaN/Inf pattern: the port's
    plain path sums every slot, as the Pallas kernel does. Block-rows 0-11
    hold two real blocks and no pad slot, the last one real block and one
    pad slot. (Both plans run without their NaN guards.)"""
    y = _assert_plan_ell_nonfinite_matches_jax("spmv", bad, where, ())
    assert np.isnan(y[(200 // 16) * 16:]).all() == (where == "first_block")


@pytest.mark.parametrize("bad", [np.nan, np.inf])
@pytest.mark.parametrize("where", ["first_block", "real_column"])
def test_plan_spmm_ell_nonfinite_x_matches_jax(bad, where):
    """The SpMM form: ``bad`` in column 1 of x only, so each block-row that
    reads it is non-finite in column 1 alone, and with it in x[0:bs] the
    last block-row's pad slot makes exactly its column 1 NaN."""
    y = _assert_plan_ell_nonfinite_matches_jax("spmm", bad, where, (1,))
    assert np.isfinite(y[:, [0, 2]]).all()
    last = y[(200 // 16) * 16:]
    assert np.isnan(last[:, 1]).all() == (where == "first_block")


# ------------------- SELL: the bucket-pad cells of a member's last row

SELL_NF = (Schedule("bsr", 16, 1.0, layout="sell", slice_height=4),
           JSchedule("bsr", 16, 1.0, layout="sell", slice_height=4))


def _diag_csr(n, bs, seed):
    """One dense diagonal block per block-row: every SELL slice is one cell
    wide, so no cell is a slice-width pad and only the bucket-pad cells
    read x_blocks[0] outside block-row 0."""
    rng = np.random.default_rng(seed)
    d = np.zeros((n, n), np.float32)
    for r in range(0, n, bs):
        d[r:r + bs, r:r + bs] = rng.standard_normal((min(bs, n - r),) * 2)
    return CSR.from_dense(d)


def _jcsr(csr):
    return JCSR(csr.row_ptrs, csr.col_idxs, csr.nnz_vals, csr.shape)


def _bad_x(n, op, bad, col, seed):
    x = np.random.default_rng(seed).standard_normal(
        (n, 3) if op == "spmm" else n).astype(np.float32)
    x[col] = bad
    return x


def _assert_nonfinite_equal(y, jy):
    """The JAX facade's NaN and Inf pattern, its infinities, and its finite
    rest within 2e-5."""
    np.testing.assert_array_equal(np.isnan(y), np.isnan(jy))
    np.testing.assert_array_equal(np.isinf(y), np.isinf(jy))
    np.testing.assert_array_equal(y[np.isinf(jy)], jy[np.isinf(jy)])
    fin = np.isfinite(jy)
    np.testing.assert_allclose(y[fin], jy[fin], rtol=2e-5, atol=2e-5)


def _bad_block_rows(y, bs):
    """The block-rows that hold a non-finite output."""
    rows = ~np.isfinite(y.reshape(y.shape[0], -1)).all(1)
    return set(np.nonzero(rows)[0] // bs)


@pytest.mark.parametrize("op", ["spmv", "spmm"])
@pytest.mark.parametrize("bad", [np.nan, np.inf])
@pytest.mark.parametrize("where", ["first_block", "real_column"])
def test_plan_sell_nonfinite_x_matches_jax(op, bad, where):
    """A NaN or an Inf in x[0:bs] or in a real column, through a single
    shape-bucketed SELL plan: 13 cells padded to 16, the pad cells (zero
    block, column 0) on the last sorted row. The JAX facade sums them into
    that row, so x[3] makes block-rows 0 and 12 non-finite; the port gives
    the same pattern. (Both plans run without their NaN guards.)"""
    n, bs = 208, 16
    csr = _diag_csr(n, bs, 0)
    x = _bad_x(n, op, bad, 3 if where == "first_block" else 5 * bs + 2, 1)
    st = SparseTensor.from_csr(csr, SELL_NF[0], shape_bucket=True,
                               device="cpu")
    assert st.arrays["cell_block"].shape[0] == 16 > int(csr.shape[0]) // bs
    y = plan(op, (st,), device="cpu",
             executor=TGuardedExecutor(nan_guard=False)).execute(x).numpy()
    jy = np.asarray(jplan(op, (_jcsr(csr),), schedule=SELL_NF[1],
                          backend="jnp",
                          executor=GuardedExecutor(nan_guard=False)
                          ).execute(x))
    _assert_nonfinite_equal(y, jy)
    assert _bad_block_rows(y, bs) == ({0, 12} if where == "first_block"
                                      else {5})
    y2 = plan(op, (csr,), schedule=SELL_NF[0], device="cpu",
              executor=TGuardedExecutor(nan_guard=False)).execute(x)
    np.testing.assert_array_equal(y2.numpy(), y)


@pytest.mark.parametrize("op", ["spmv", "spmm"])
@pytest.mark.parametrize("bad", [np.nan, np.inf])
@pytest.mark.parametrize("resident", [False, True])
def test_plan_bucket_sell_nonfinite_x_matches_jax(op, bad, resident):
    """A two-member SELL bucket, stacked from host containers or from the
    members' resident tensors: 13 and 12 cells stacked to 16, so each
    member's stream is padded past its live cells (the second only by the
    stack) and the pad cells reach its last sorted row. x[3] in each member
    gives the JAX bucket's NaN/Inf pattern: its block-row 0 and its last."""
    bs = 16
    mats = [_diag_csr(208, bs, 0), _diag_csr(192, bs, 1)]
    xs = [_bad_x(m.shape[1], op, bad, 3, 2 + i) for i, m in enumerate(mats)]
    kw = (dict(store=PreparedStore(), member_keys=[content_key(m)
                                                   for m in mats])
          if resident else {})
    ys = plan_bucket(op, mats, SELL_NF[0], device="cpu",
                     executor=TGuardedExecutor(nan_guard=False),
                     **kw).execute(xs)
    jys = jplan_bucket(op, [_jcsr(m) for m in mats], SELL_NF[1],
                       backend="jnp",
                       executor=GuardedExecutor(nan_guard=False)).execute(xs)
    for y, jy, m in zip(ys, jys, mats):
        y, jy = y.numpy(), np.asarray(jy)
        _assert_nonfinite_equal(y, jy)
        assert _bad_block_rows(y, bs) == {0, m.shape[0] // bs - 1}


def _assert_real_cells_lead(cb, ptr, valid, zero):
    """Row r's cells under ``ptr`` start with ``valid[r]`` real ones and
    hold no other real cell."""
    assert valid.dtype == np.int32 and valid.shape == (ptr.size - 1,)
    for r in range(ptr.size - 1):
        cells = cb[ptr[r]:ptr[r + 1]]
        assert valid[r] == np.count_nonzero(cells != zero)
        assert (cells[:valid[r]] != zero).all()


@pytest.mark.parametrize("shape_bucket", [False, True])
@pytest.mark.parametrize("n,bs,C", [(100, 16, 2), (257, 32, 4),
                                    (300, 64, 8)])
def test_cell_valid_counts_the_real_cells_that_lead_each_row(n, bs, C,
                                                             shape_bucket):
    st = SparseTensor.from_csr(gen_zipf(n, seed=n), block_size=bs,
                               layout="sell", slice_height=C,
                               shape_bucket=shape_bucket, device="cpu")
    a = {k: v.numpy() for k, v in st.arrays.items()}
    _assert_real_cells_lead(a["cell_block"], a["cell_ptr"], a["cell_valid"],
                            st._zero_idx)
    assert a["cell_valid"].sum() == np.count_nonzero(
        a["cell_block"] != st._zero_idx)


@pytest.mark.parametrize("resident", [False, True])
@pytest.mark.parametrize("shape_bucket", [False, True])
def test_bucket_cell_valid_and_pointer_are_per_member(resident,
                                                      shape_bucket):
    """Stacked SELL buckets of unequal members: member b's counts mark its
    real cells against its own zero block (its pad rows own none), its
    pointer gives its last row exactly one pad cell when the stack pads
    past its live cells, and the padded zero members own nothing."""
    bs = 16
    mats = [gen_zipf(n, seed=n) for n in (120, 90, 64)]
    sched = Schedule("bsr", bs, 1.0, layout="sell", slice_height=2)
    dev = torch.device("cpu")
    if resident:
        sts = _member_tensors(mats, sched, 4, shape_bucket,
                              PreparedStore(), [content_key(m) for m in mats],
                              dev)
        built = _stack_resident(sts, shape_bucket)
    else:
        built = _build_matvec_bucket(mats, sched, 4, shape_bucket, dev)
    arrs = {k: v.numpy() for k, v in _pad_member_axis(built, 4)["arrays"]
            .items()}
    cv, ptr, cb = arrs["cell_valid"], arrs["cell_ptr"], arrs["cell_block"]
    assert cv.shape == arrs["row_perm"].shape
    for b, m in enumerate(mats):
        sell = SELLBSR.from_bsr(BSR.from_csr(m, bs), 2, 4)
        zero = sell.blocks.shape[0] - 1
        _assert_real_cells_lead(cb[b], ptr[b], cv[b], zero)
        last = sell.n_block_rows - 1
        live = sell.n_cells
        assert ptr[b, last + 1] == live + (1 if cb.shape[1] > live else 0)
        assert (ptr[b, last + 1:] == ptr[b, last + 1]).all()
        assert not cv[b, sell.n_block_rows:].any()
    assert not cv[3].any() and not ptr[3].any()   # the zero member


def test_spmv_sell_wrapper_needs_its_cell_valid():
    """The count is required, on CPU tensors as on the card, and must have
    the sorted rows' shape and int32."""
    sell = SELLBSR.from_bsr(BSR.from_csr(gen_zipf(64, seed=1), 16), 2, 4)
    *args, cv = ops.sell_device_arrays(sell, device="cpu")
    xb = torch.zeros((4, 16))
    with pytest.raises(TypeError, match="cell_valid"):
        K.bsr_spmv_sell_cuda(*args, xb)
    for bad in (cv.long(), cv[:2]):
        with pytest.raises(ValueError, match="cell_valid"):
            K.bsr_spmv_sell_cuda(*args, xb, cell_valid=bad)
    y = K.bsr_spmv_sell_cuda(*args, xb, cell_valid=cv)
    assert y.shape == (4, 16) and not y.any()


# ------------------------ plan keywords: nothing is dropped silently

def _spmv_operand():
    return gen_zipf(64, seed=1)


@pytest.fixture(scope="module")
def small_service_tuner():
    from repro_torch.core import H100_SXM, ScheduleTuner, corpus
    return ScheduleTuner("spmv", H100_SXM).fit(
        corpus(n_matrices=6, n_min=256, n_max=384, seed=0), max_mats=6)


@pytest.mark.parametrize("entry", ["plan", "plan_bucket"])
@pytest.mark.parametrize("keyword", ["selector", "executor"])
def test_plan_takes_selector_and_executor(entry, keyword,
                                          small_service_tuner):
    """Both entry points consume both keywords, as the reference's plan
    does: an explicit GuardedExecutor carries the launch (the process
    default's ledger stays empty), a SelectorService lends its store and
    executor (and, to ``plan``, its schedule), and any other selector
    raises the reference's TypeError."""
    from repro_torch.selector import SelectorService
    from repro_torch.sparse import default_executor, reset_resilience
    reset_resilience()
    a = _spmv_operand()
    s = Schedule("bsr", 16, 1.0)
    x = np.ones(a.shape[1], np.float32)

    def build(**kw):
        if entry == "plan":
            return plan("spmv", (a,), device="cpu",
                        **({} if "selector" in kw else {"schedule": s}), **kw)
        return plan_bucket("spmv", [a, a], s, device="cpu", **kw)

    def run(p):
        return p.execute(x) if entry == "plan" else p.execute([x, x])[0]

    want = a.to_dense().astype(np.float64) @ x
    if keyword == "selector":
        with pytest.raises(TypeError, match="unsupported selector object; "
                           "pass a SelectorService or a fitted "
                           "ScheduleTuner"):
            build(selector=object())
        ex = TGuardedExecutor()
        svc = SelectorService(small_service_tuner, executor=ex,
                              device="cpu")
        p = build(selector=svc)
        assert len(svc.prepared_store) == 1
        if entry == "plan":
            assert p.source.startswith("selector-")
            assert p.fingerprint_key and p.confidence is not None
    else:
        ex = TGuardedExecutor()
        p = build(executor=ex)
    np.testing.assert_allclose(run(p).numpy(), want, rtol=2e-5, atol=2e-5)
    assert ex.telemetry() == default_executor().telemetry()
    assert sum(ex.telemetry().values()) == 0
    with pytest.raises(TypeError, match="unexpected keyword"):
        build(executor=ex, selectr=None)
    reset_resilience()


@pytest.mark.parametrize("op", ["spmv", "spmm", "spgemm", "spadd",
                                "moe_gmm", "flash_attention"])
def test_plan_raises_on_a_keyword_its_planner_does_not_take(op):
    a = _spmv_operand()
    operands = {"spgemm": (a, a), "spadd": (a, a),
                "moe_gmm": (np.zeros(2, np.int32),),
                "flash_attention": ()}.get(op, (a,))
    with pytest.raises(TypeError, match="no_such_option"):
        plan(op, operands, device="cpu", no_such_option=1)


@pytest.mark.parametrize("op", ["spmv", "spmm", "spgemm", "spadd"])
def test_plan_bucket_raises_on_a_keyword_its_planner_does_not_take(op):
    a = _spmv_operand()
    members = [(a, a)] * 2 if op in ("spgemm", "spadd") else [a, a]
    with pytest.raises(TypeError, match="no_such_option"):
        plan_bucket(op, members, Schedule("bsr", 16, 1.0), device="cpu",
                    no_such_option=1)


def _c_argtypes(source: str):
    """{entry point: ctypes argument types} parsed from the ``extern "C"``
    block of ``csrc/<source>.cu``."""
    path = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" /
            "csrc" / f"{source}.cu")
    block = path.read_text().split('extern "C" {', 1)[1]
    sigs = {}
    for name, params in re.findall(r"int (\w+)\(([^)]*)\)\s*\{", block):
        types = []
        for param in (" ".join(q.split()) for q in params.split(",")):
            if "*" in param or param.startswith("cudaStream_t"):
                types.append(ctypes.c_void_p)
            elif param.startswith("long long "):
                types.append(ctypes.c_longlong)
            elif param.startswith("float "):
                types.append(ctypes.c_float)
            else:
                assert param.startswith("int "), param
                types.append(ctypes.c_int)
        sigs[name] = types
    return sigs


def test_ctypes_argtypes_match_the_cu_signatures():
    """Each wrapper's ctypes argument list is its kernel's C signature (a
    pointer passed as a 32-bit int, or a count in the wrong place, would
    reach the kernel silently)."""
    spmv = _c_argtypes("bsr_spmv")
    assert sorted(spmv) == sorted(K._ARGTYPES)
    for name, types in K._ARGTYPES.items():
        assert spmv[name] == types, name
    gemm = _c_argtypes("bsr_spgemm")
    assert sorted(gemm) == ["bsr_spgemm_cells", "bsr_spgemm_pairs"]
    for name, types in gemm.items():
        assert types == GK._ARGTYPES, name
    # the counted ELL kernels take valid_counts third, the SELL ones
    # cell_valid fourth; each SpMM kernel takes one more int (k) before
    # rows_per_cta
    for layout, n_ptr in (("ell", 6), ("sell", 8)):
        v, m = spmv[f"bsr_spmv_{layout}"], spmv[f"bsr_spmm_{layout}"]
        assert v[:n_ptr] == m[:n_ptr] == [ctypes.c_void_p] * n_ptr
        assert m == v[:-2] + [ctypes.c_int] + v[-2:]


@pytest.mark.parametrize("source,module", [("bsr_spadd", AK),
                                           ("flash_attention", FK)])
def test_spadd_and_flash_argtypes_match_the_cu_signatures(source, module):
    """As above for the one entry point of ``bsr_spadd.cu`` (its
    ``sentinels`` third) and of ``flash_attention.cu``."""
    sigs = _c_argtypes(source)
    assert list(sigs) == [source]
    assert sigs[source] == module._ARGTYPES
    if source == "bsr_spadd":
        assert sigs[source][:6] == [ctypes.c_void_p] * 6


def test_spmv_wrapper_needs_its_valid_counts():
    """The count is required, on CPU tensors as on the card, and must have
    the rows' shape and int32."""
    ell = ELLBSR.from_bsr(BSR.from_csr(gen_zipf(64, seed=1), 16))
    xb = torch.zeros((4, 16))
    args = [_t(ell.block_indices), _t(ell.block_cols), _t(ell.blocks), xb]
    with pytest.raises(TypeError, match="valid_counts"):
        K.bsr_spmv_cuda(*args)
    for bad in (_t(ell.valid_counts).long(), _t(ell.valid_counts)[:2]):
        with pytest.raises(ValueError, match="valid_counts"):
            K.bsr_spmv_cuda(*args, valid_counts=bad)


@pytest.mark.parametrize("layout", ["ell", "sell"])
def test_spmm_wrappers_need_their_counts(layout):
    """The SpMM wrappers take their layout's count as a required keyword,
    on CPU tensors as on the card, of the rows' shape and int32."""
    bsr = BSR.from_csr(gen_zipf(64, seed=1), 16)
    xb = torch.zeros((4, 16, 8))
    if layout == "ell":
        ell = ELLBSR.from_bsr(bsr)
        fn, key, count = K.bsr_spmm_cuda, "valid_counts", _t(ell.valid_counts)
        args = [_t(ell.block_indices), _t(ell.block_cols), _t(ell.blocks)]
    else:
        fn, key = K.bsr_spmm_sell_cuda, "cell_valid"
        *args, count = ops.sell_device_arrays(SELLBSR.from_bsr(bsr, 2, 4),
                                              device="cpu")
    with pytest.raises(TypeError, match=key):
        fn(*args, xb)
    for bad in (count.long(), count[:2], count.float()):
        with pytest.raises(ValueError, match=key):
            fn(*args, xb, **{key: bad})
    y = fn(*args, xb, **{key: count})
    assert y.shape == (4, 16, 8) and not y.any()


# ------------------------------------------------ the wrappers' CUDA branch

def _meta_ell(multi):
    """ELL arguments on the meta device: no data, but the wrappers take
    their non-CPU branch — the one CUDA tensors take."""
    dev = "meta"
    idx = torch.zeros((4, 3), dtype=torch.int32, device=dev)
    blocks = torch.zeros((5, 8, 8), dtype=torch.float32, device=dev)
    x = torch.zeros((4, 8, 8) if multi else (4, 8), dtype=torch.float32,
                    device=dev)
    return idx, idx.clone(), blocks, x


def _meta_counts():
    return torch.zeros(4, dtype=torch.int32, device="meta")


@pytest.mark.parametrize("name", sorted(K.LAUNCHES))
def test_wrappers_raise_on_failed_launch_without_fallback(name, monkeypatch):
    """A failed launch raises and is counted; nothing retries it on the
    plain version."""
    monkeypatch.setattr(K, "_fn", lambda n: (lambda *a: 700))
    monkeypatch.setattr(K, "_stream", lambda dev: None)
    for fn in ("ref_bsr_spmv", "ref_bsr_spmm", "ref_bsr_spmv_sell_perm",
               "ref_bsr_spmm_sell_perm"):
        monkeypatch.setattr(ref, fn, lambda *a: pytest.fail("fell back"))
    multi = "spmm" in name
    idx, cols, blocks, x = _meta_ell(multi)
    before = K.LAUNCHES[name]
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        if not name.endswith("_sell"):
            fn = K.bsr_spmm_cuda if multi else K.bsr_spmv_cuda
            fn(idx, cols, blocks, x, valid_counts=_meta_counts())
        else:
            cb = torch.zeros(6, dtype=torch.int32, device="meta")
            ptr = torch.zeros(5, dtype=torch.int32, device="meta")
            perm = torch.zeros(4, dtype=torch.int32, device="meta")
            fn = K.bsr_spmm_sell_cuda if multi else K.bsr_spmv_sell_cuda
            fn(cb, cb.clone(), ptr, perm, blocks, x,
               cell_valid=_meta_counts())
    assert K.LAUNCHES[name] == before + 1


def test_wrappers_reject_what_the_kernel_does_not_take():
    idx, cols, blocks, x = _meta_ell(False)
    vc = _meta_counts()
    with pytest.raises(TypeError):
        K.bsr_spmv_cuda(idx.long(), cols, blocks, x, valid_counts=vc)
    with pytest.raises(ValueError, match="multiple of 8"):
        K.bsr_spmm_cuda(idx, cols, blocks,
                        torch.zeros((4, 8, 5), device="meta"),
                        valid_counts=vc)
    with pytest.raises(ValueError, match="block size"):
        K.bsr_spmv_cuda(idx, cols, torch.zeros((5, 6, 6), device="meta"),
                        torch.zeros((4, 6), device="meta"), valid_counts=vc)
    with pytest.raises(ValueError, match="contiguous"):
        K.bsr_spmv_cuda(idx, cols, blocks, torch.zeros((8, 4),
                                                       device="meta").t(),
                        valid_counts=vc)


# ------------------------------------------------------------ guards

def test_package_imports_neither_jax_nor_repro():
    code = (
        "import sys, pkgutil, importlib, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert int(out.stdout.strip()) > 10


@pytest.mark.parametrize("bs,n_ctas,want", [
    (32, 16384, 32),      # gen_spatial: enough block-rows, no split
    (128, 64, 16),        # gen_zipf(8192): 64 block-rows -> 8 CTAs each
    (96, 64, 24),         # non-power-of-two tiles split evenly
    (8, 10, 8),           # never below 16 rows (or the whole tile)
    (256, 4096, 256)])
def test_rows_per_cta_fills_the_card(bs, n_ctas, want):
    rows = K.rows_per_cta(bs, n_ctas)
    assert rows == want and bs % rows == 0
    assert n_ctas * (bs // rows) <= max(K.TARGET_CTAS, n_ctas)


def test_backend_resolution():
    assert common.resolve_backend("auto", "cpu") == "torch"
    assert common.resolve_backend("torch", "cpu") == "torch"
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        common.resolve_backend("cuda", "cpu")
    with pytest.raises(ValueError):
        common.resolve_backend("pallas", "cpu")
