"""The port's CUDA kernels on the card: each kernel against its plain
PyTorch version on the same inputs, over the block sizes the kernels take
(8 to 256, powers of two or not), one member and a stacked bucket, and the
plan paths (spmv, spgemm, spadd) end to end against float64 references;
the grouped GEMM over tile_m 32-256 and the attention kernel over head
dims 32-256, float32 and bfloat16, with ragged edges, the MoE decode
loop and flash plan on the card, the ServingEngine on the card (its
drains against a CPU engine's, its serving thread), sharded plans (one
stacked launch; one stream per shard) and the LM's prefill and decode
against the CPU port.

Run on a machine with an NVIDIA GPU and nvcc:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Without a card every test here skips (the kernels have no CPU mode). This
file imports neither jax nor the JAX package, so it runs where only
PyTorch is installed.
"""
import time

import numpy as np
import pytest
import torch

from repro_torch.core import (BSR, CSR, ELLBSR, SELLBSR, Schedule,
                              spmv_oracle)
from repro_torch.core.synthetic import gen_zipf
from repro_torch.kernels.bsr_spmv import kernel as K
from repro_torch.kernels.bsr_spmv import ops, ref
from repro_torch.kernels.bsr_spadd import kernel as AK
from repro_torch.kernels.bsr_spadd import ref as AR
from repro_torch.kernels.bsr_spgemm import kernel as GK
from repro_torch.kernels.bsr_spgemm import ref as GR
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.flash_attention import ref as FR
from repro_torch.kernels.moe_gmm import kernel as MK
from repro_torch.kernels.moe_gmm import ref as MR
from repro_torch.kernels.moe_gmm.ops import route_and_pad
from repro_torch.serving import decode_moe_ticks
from repro_torch.sparse import (PreparedStore, launch_count, ops_builtin,
                                plan, plan_bucket, reset_counters)

pytestmark = pytest.mark.cuda
SIZES = [(64, 8), (100, 16), (257, 32), (96, 96), (512, 128), (600, 256)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    # the plain versions run on the card here: keep them in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _dense(n, density, seed):
    rng = np.random.default_rng(seed)
    d = (rng.random((n, n)) < density) * rng.standard_normal((n, n))
    return d.astype(np.float32)


def _x_blocks(x, n_bc, bs, device):
    xb = np.zeros((n_bc * bs,) + x.shape[1:], np.float32)
    xb[: x.shape[0]] = x
    return torch.as_tensor(xb.reshape((n_bc, bs) + x.shape[1:]),
                           device=device)


@pytest.mark.parametrize("n,bs", SIZES)
@pytest.mark.parametrize("layout", ["ell", "sell"])
@pytest.mark.parametrize("multi", [False, True])
def test_kernel_matches_plain(card, n, bs, layout, multi):
    bsr = BSR.from_csr(CSR.from_dense(_dense(n, 0.06, n)), bs)
    rng = np.random.default_rng(n)
    x = rng.standard_normal((n, 16) if multi else n).astype(np.float32)
    xb = _x_blocks(x, -(-n // bs), bs, card)
    if layout == "ell":
        ell = ELLBSR.from_bsr(bsr)
        idx, cols, blocks, _ = ops.ell_device_arrays(ell, card)
        args = (idx, cols, blocks)
        vc = torch.as_tensor(ell.valid_counts, device=card)
        fn = (lambda *a: (K.bsr_spmm_cuda if multi else K.bsr_spmv_cuda)(
            *a, valid_counts=vc))
        plain = ref.ref_bsr_spmm if multi else ref.ref_bsr_spmv
    else:
        *args, cv = ops.sell_device_arrays(SELLBSR.from_bsr(bsr, 4, 8), card)
        fn = (lambda *a: (K.bsr_spmm_sell_cuda if multi else
                          K.bsr_spmv_sell_cuda)(*a, cell_valid=cv))
        plain = (ref.ref_bsr_spmm_sell_perm if multi
                 else ref.ref_bsr_spmv_sell_perm)
    y = fn(*args, xb)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, plain(*args, xb), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("layout", ["ell", "sell"])
def test_plan_and_bucket_on_card(card, layout):
    mats = [gen_zipf(n, seed=n) for n in (700, 600, 500)]
    s = (Schedule("bsr", 64, 1.0, layout="sell", slice_height=4)
         if layout == "sell" else Schedule("bsr", 64, 1.0))
    rng = np.random.default_rng(1)
    xs = [rng.standard_normal(m.shape[1]).astype(np.float32) for m in mats]
    for m, x in zip(mats, xs):
        y = plan("spmv", (m,), schedule=s).execute(x).cpu().numpy()
        np.testing.assert_allclose(y, spmv_oracle(m, x), rtol=1e-4,
                                   atol=1e-4)
    name = "bsr_spmv_sell" if layout == "sell" else "bsr_spmv_ell"
    before = K.LAUNCHES[name]
    reset_counters()
    ys = plan_bucket("spmv", mats, s).execute(xs)
    assert launch_count("spmv") == 1 and K.LAUNCHES[name] == before + 1
    for y, m, x in zip(ys, mats, xs):
        np.testing.assert_allclose(y.cpu().numpy(), spmv_oracle(m, x),
                                   rtol=1e-4, atol=1e-4)


# ------------------------- bsr_spmv_ell: real slots plus one pad slot

REDESIGN_BS = [8, 16, 32, 96, 128, 256]


def _ell_members(rng, bs, case, n_mem):
    """Stacked ELL arrays built by hand: real slots lead each row (random
    tiles and columns), the rest hold the member's own zero block and
    column 0; each member's zero block sits at its own index, with bucket
    pad blocks (zeros) after it. Rows with 0 real slots, rows with no pad
    slot, and, for ``case == "long"``, rows longer than one 256-slot index
    batch."""
    n_br, n_bc = 6, 5
    mb = 300 if case == "long" else 7
    nb = 10                                    # blocks incl. pad blocks
    idx = np.zeros((n_mem, n_br, mb), np.int32)
    cols = np.zeros((n_mem, n_br, mb), np.int32)
    counts = np.zeros((n_mem, n_br), np.int32)
    blocks = np.zeros((n_mem, nb, bs, bs), np.float32)
    for b in range(n_mem):
        zero = 6 + b % 3                       # the member's sentinel
        blocks[b, :zero] = rng.standard_normal((zero, bs, bs))
        cnt = np.array([0, mb, mb - 1, 1, mb // 2, 2 + b])[:n_br]
        counts[b] = cnt
        for r, c in enumerate(cnt):
            idx[b, r] = zero
            idx[b, r, :c] = rng.integers(0, zero, c)
            cols[b, r, :c] = rng.integers(0, n_bc, c)
    x = rng.standard_normal((n_mem, n_bc, bs)).astype(np.float32)
    return idx, cols, counts, blocks, x


def _near(got, want, tol=1e-4):
    """NaN where ``want`` is NaN, the same infinities, and the finite rest
    within ``tol * max|want|``."""
    assert got.shape == want.shape
    assert torch.equal(got.isnan(), want.isnan())
    inf = want.isinf()
    assert torch.equal(got.isinf(), inf) and torch.equal(got[inf], want[inf])
    fin = want.isfinite()
    if fin.any():
        d = float((got[fin] - want[fin]).abs().max())
        assert d <= tol * max(float(want[fin].abs().max()), 1e-30), d


@pytest.mark.parametrize("bs", REDESIGN_BS)
@pytest.mark.parametrize("case", ["short", "long"])
@pytest.mark.parametrize("stacked", [False, True])
def test_spmv_ell_counts_match_all_slot_plain(card, bs, case, stacked):
    rng = np.random.default_rng(bs + len(case))
    n_mem = 3 if stacked else 1
    arrs = [torch.as_tensor(a, device=card)
            for a in _ell_members(rng, bs, case, n_mem)]
    if not stacked:
        arrs = [a[0] for a in arrs]
    idx, cols, counts, blocks, x = arrs
    before = K.LAUNCHES["bsr_spmv_ell"]
    y = K.bsr_spmv_cuda(idx, cols, blocks, x, valid_counts=counts)
    torch.cuda.synchronize()
    assert K.LAUNCHES["bsr_spmv_ell"] == before + 1
    _near(y, ref.ref_bsr_spmv(idx, cols, blocks, x))


@pytest.mark.parametrize("bs", REDESIGN_BS)
@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
@pytest.mark.parametrize("where", ["first_block", "real_column"])
def test_spmv_ell_nonfinite_x_gives_plain_nan_pattern(card, bs, bad, where):
    """A NaN or an Inf in ``x_blocks[0]`` (which every pad slot reads) or
    in a real column: NaN in exactly the rows the all-slot sum makes NaN,
    rows without a pad slot included."""
    rng = np.random.default_rng(bs)
    idx, cols, counts, blocks, x = (torch.as_tensor(a[0], device=card)
                                    for a in _ell_members(rng, bs, "short",
                                                          1))
    x[0 if where == "first_block" else 3, bs // 2] = bad
    y = K.bsr_spmv_cuda(idx, cols, blocks, x, valid_counts=counts)
    torch.cuda.synchronize()
    want = ref.ref_bsr_spmv(idx, cols, blocks, x)
    assert bool((want.isnan() if where == "first_block"
                 else ~want.isfinite()).any())
    _near(y, want)


def test_spmv_ell_wrapper_needs_its_counts(card):
    idx = torch.zeros((4, 3), dtype=torch.int32, device=card)
    blocks = torch.zeros((5, 8, 8), device=card)
    x = torch.zeros((4, 8), device=card)
    with pytest.raises(TypeError, match="valid_counts"):
        K.bsr_spmv_cuda(idx, idx, blocks, x)
    with pytest.raises(ValueError, match="valid_counts"):
        K.bsr_spmv_cuda(idx, idx, blocks, x, valid_counts=idx[:, 0].long())


def test_spmv_ell_wrapper_needs_aligned_x(card):
    """The kernel copies x segments 16 bytes at a time: a contiguous view
    of x one float into its storage is refused, not launched."""
    idx = torch.zeros((4, 3), dtype=torch.int32, device=card)
    blocks = torch.zeros((5, 8, 8), device=card)
    counts = torch.zeros(4, dtype=torch.int32, device=card)
    x = torch.zeros(4 * 8 + 1, device=card)[1:].view(4, 8)
    assert x.is_contiguous() and x.data_ptr() % 16
    before = K.LAUNCHES["bsr_spmv_ell"]
    with pytest.raises(ValueError, match="x_blocks must be 16-byte aligned"):
        K.bsr_spmv_cuda(idx, idx, blocks, x, valid_counts=counts)
    assert K.LAUNCHES["bsr_spmv_ell"] == before


# ----------------------- bsr_spmm_ell / bsr_spmm_sell: the counted SpMM

SPMM_K = [8, 16, 64]


def _rhs(rng, x, k):
    """A (.., n_bc, bs, k) RHS in place of the members' (.., n_bc, bs) x."""
    return torch.as_tensor(
        rng.standard_normal(tuple(x.shape) + (k,)).astype(np.float32),
        device=x.device)


@pytest.mark.parametrize("bs", REDESIGN_BS)
@pytest.mark.parametrize("k", SPMM_K)
@pytest.mark.parametrize("case", ["short", "long"])
@pytest.mark.parametrize("stacked", [False, True])
def test_spmm_ell_counts_match_all_slot_plain(card, bs, k, case, stacked):
    """Rows with 0 real slots, with no pad slot and (``long``) longer than
    one 256-slot index batch and the ring; one member or three, each with
    its own zero block."""
    rng = np.random.default_rng(bs + k + len(case))
    n_mem = 3 if stacked else 1
    arrs = [torch.as_tensor(a, device=card)
            for a in _ell_members(rng, bs, case, n_mem)]
    if not stacked:
        arrs = [a[0] for a in arrs]
    idx, cols, counts, blocks, x = arrs
    x = _rhs(rng, x, k)
    before = K.LAUNCHES["bsr_spmm_ell"]
    y = K.bsr_spmm_cuda(idx, cols, blocks, x, valid_counts=counts)
    torch.cuda.synchronize()
    assert K.LAUNCHES["bsr_spmm_ell"] == before + 1
    _near(y, ref.ref_bsr_spmm(idx, cols, blocks, x))


@pytest.mark.parametrize("bs", REDESIGN_BS)
@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
@pytest.mark.parametrize("where", ["first_block", "real_column"])
def test_spmm_ell_nonfinite_x_gives_plain_nan_pattern(card, bs, bad, where):
    """A NaN or an Inf in one RHS column of ``x_blocks[0]`` (which every
    pad slot reads) or of a real block: NaN in exactly the outputs the
    all-slot sum makes NaN, rows without a pad slot included."""
    rng = np.random.default_rng(bs)
    idx, cols, counts, blocks, x = (torch.as_tensor(a[0], device=card)
                                    for a in _ell_members(rng, bs, "short",
                                                          1))
    x = _rhs(rng, x, 16)
    x[0 if where == "first_block" else 3, bs // 2, 9] = bad
    y = K.bsr_spmm_cuda(idx, cols, blocks, x, valid_counts=counts)
    torch.cuda.synchronize()
    want = ref.ref_bsr_spmm(idx, cols, blocks, x)
    assert bool((want.isnan() if where == "first_block"
                 else ~want.isfinite()).any())
    _near(y, want)


def _spmm_args(card, layout, x):
    """Small arguments of one SpMM kernel and its count keyword."""
    if layout == "ell":
        idx = torch.zeros((4, 3), dtype=torch.int32, device=card)
        blocks = torch.zeros((5, 8, 8), device=card)
        counts = torch.zeros(4, dtype=torch.int32, device=card)
        return (K.bsr_spmm_cuda, (idx, idx, blocks, x), "valid_counts",
                counts)
    cb = torch.zeros(6, dtype=torch.int32, device=card)
    ptr = torch.zeros(5, dtype=torch.int32, device=card)
    perm = torch.arange(4, dtype=torch.int32, device=card)
    blocks = torch.zeros((5, 8, 8), device=card)
    return (K.bsr_spmm_sell_cuda, (cb, cb, ptr, perm, blocks, x),
            "cell_valid", perm)


@pytest.mark.parametrize("layout", ["ell", "sell"])
def test_spmm_wrappers_need_their_counts(card, layout):
    fn, args, key, counts = _spmm_args(card, layout,
                                       torch.zeros((4, 8, 8), device=card))
    with pytest.raises(TypeError, match=key):
        fn(*args)
    for bad in (counts.long(), counts[:2]):
        with pytest.raises(ValueError, match=key):
            fn(*args, **{key: bad})
    y = fn(*args, **{key: counts})
    torch.cuda.synchronize()
    assert y.shape == (4, 8, 8) and not bool(y.any())


@pytest.mark.parametrize("layout", ["ell", "sell"])
def test_spmm_wrappers_need_aligned_x(card, layout):
    """The kernels copy x segments 16 bytes at a time: a contiguous view of
    x one float into its storage is refused, not launched."""
    x = torch.zeros(4 * 8 * 8 + 1, device=card)[1:].view(4, 8, 8)
    assert x.is_contiguous() and x.data_ptr() % 16
    fn, args, key, counts = _spmm_args(card, layout, x)
    name = "bsr_spmm_ell" if layout == "ell" else "bsr_spmm_sell"
    before = K.LAUNCHES[name]
    with pytest.raises(ValueError, match="x_blocks must be 16-byte aligned"):
        fn(*args, **{key: counts})
    assert K.LAUNCHES[name] == before


# ------------------ bsr_spmv_sell: real cells plus one pad cell per row

def _sell_members(rng, bs, case, n_mem):
    """Stacked SELL cell streams built by hand. Each member's sorted rows
    own (real, pad) cells: real cells lead (random tiles and columns), pad
    cells hold the member's own zero block and column 0; a row of pad cells
    only, a row with no pad cell, rows that own no cells at all (bucket-pad
    rows) and, for ``case == "long"``, a row longer than one 256-cell index
    batch. Past the live cells the stream is padded with pad cells, and the
    pointer gives the last row that owns cells exactly one of them."""
    n_bc, nb = 5, 10                           # blocks incl. pad blocks
    long_n = 300 if case == "long" else 6
    shape = [(2, 1), (0, 2), (long_n, 0), (1, 0), (3, 2), (0, 0), (0, 0)]
    n_br = len(shape)
    live = sum(r + p for r, p in shape)
    n_cells = live + 5 + n_mem                 # the stacked stream's width
    cb = np.zeros((n_mem, n_cells), np.int32)
    cc = np.zeros((n_mem, n_cells), np.int32)
    ptr = np.zeros((n_mem, n_br + 1), np.int32)
    valid = np.zeros((n_mem, n_br), np.int32)
    perm = np.zeros((n_mem, n_br), np.int32)
    blocks = np.zeros((n_mem, nb, bs, bs), np.float32)
    for b in range(n_mem):
        zero = 6 + b % 3                       # the member's zero block
        blocks[b, :zero] = rng.standard_normal((zero, bs, bs))
        cb[b] = zero
        t = 0
        for r, (n_real, n_pad) in enumerate(shape):
            cb[b, t:t + n_real] = rng.integers(0, zero, n_real)
            cc[b, t:t + n_real] = rng.integers(0, n_bc, n_real)
            valid[b, r] = n_real
            t += n_real + n_pad
            ptr[b, r + 1] = t
        ptr[b, 5:] += 1                        # row 4's one bucket-pad cell
        perm[b] = rng.permutation(n_br)
    x = rng.standard_normal((n_mem, n_bc, bs)).astype(np.float32)
    return cb, cc, ptr, perm, blocks, x, valid


@pytest.mark.parametrize("bs", REDESIGN_BS)
@pytest.mark.parametrize("case", ["short", "long"])
@pytest.mark.parametrize("stacked", [False, True])
def test_spmv_sell_counts_match_all_cell_plain(card, bs, case, stacked):
    """The kernel sums cell_valid real cells and one pad cell per row whose
    range is longer; the plain version sums every cell of the range."""
    rng = np.random.default_rng(bs + len(case))
    n_mem = 3 if stacked else 1
    arrs = [torch.as_tensor(a, device=card)
            for a in _sell_members(rng, bs, case, n_mem)]
    if not stacked:
        arrs = [a[0] for a in arrs]
    cb, cc, ptr, perm, blocks, x, valid = arrs
    before = K.LAUNCHES["bsr_spmv_sell"]
    y = K.bsr_spmv_sell_cuda(cb, cc, ptr, perm, blocks, x, cell_valid=valid)
    torch.cuda.synchronize()
    assert K.LAUNCHES["bsr_spmv_sell"] == before + 1
    want = ref.ref_bsr_spmv_sell_perm(cb, cc, ptr, perm, blocks, x)
    _near(y, want)
    for yb, pb in ((y, perm),) if not stacked else zip(y, perm):
        assert not bool(yb[pb[5:].long()].any())   # rows that own no cells


@pytest.mark.parametrize("bs", REDESIGN_BS)
@pytest.mark.parametrize("k", SPMM_K)
@pytest.mark.parametrize("case", ["short", "long"])
@pytest.mark.parametrize("stacked", [False, True])
def test_spmm_sell_counts_match_all_cell_plain(card, bs, k, case, stacked):
    """The SpMM kernel sums cell_valid real cells and one pad cell per row
    whose range is longer: a row of pad cells only, a row with no pad cell,
    rows that own no cells and (``long``) a row longer than one 256-cell
    index batch and the ring; one member or three."""
    rng = np.random.default_rng(bs + k + len(case))
    n_mem = 3 if stacked else 1
    arrs = [torch.as_tensor(a, device=card)
            for a in _sell_members(rng, bs, case, n_mem)]
    if not stacked:
        arrs = [a[0] for a in arrs]
    cb, cc, ptr, perm, blocks, x, valid = arrs
    x = _rhs(rng, x, k)
    before = K.LAUNCHES["bsr_spmm_sell"]
    y = K.bsr_spmm_sell_cuda(cb, cc, ptr, perm, blocks, x, cell_valid=valid)
    torch.cuda.synchronize()
    assert K.LAUNCHES["bsr_spmm_sell"] == before + 1
    _near(y, ref.ref_bsr_spmm_sell_perm(cb, cc, ptr, perm, blocks, x))
    for yb, pb in ((y, perm),) if not stacked else zip(y, perm):
        assert not bool(yb[pb[5:].long()].any())   # rows that own no cells


@pytest.mark.parametrize("bs", REDESIGN_BS)
@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
@pytest.mark.parametrize("multi", [False, True])
def test_sell_nonfinite_x_gives_plain_nan_pattern(card, bs, bad, multi):
    """A NaN or an Inf in ``x_blocks[0]``, which every pad cell reads, for
    both SELL kernels: NaN in exactly the rows the all-cell sum makes NaN
    (the row of pad cells only, the rows with slice-width pad cells and the
    row that owns the bucket-pad cell), one member and stacked."""
    rng = np.random.default_rng(bs)
    cb, cc, ptr, perm, blocks, x, valid = (
        torch.as_tensor(a, device=card)
        for a in _sell_members(rng, bs, "short", 2))
    if multi:
        x = x.unsqueeze(-1).expand(-1, -1, -1, 8).contiguous()
    x[:, 0, bs // 2] = bad
    for args in ((cb, cc, ptr, perm, blocks, x),
                 tuple(t[1] for t in (cb, cc, ptr, perm, blocks, x))):
        cv = valid if args[0].dim() == 2 else valid[1]
        if multi:
            y = K.bsr_spmm_sell_cuda(*args, cell_valid=cv)
            want = ref.ref_bsr_spmm_sell_perm(*args)
        else:
            y = K.bsr_spmv_sell_cuda(*args, cell_valid=cv)
            want = ref.ref_bsr_spmv_sell_perm(*args)
        torch.cuda.synchronize()
        assert bool(want.isnan().any())
        _near(y, want)


def test_spmv_sell_wrapper_needs_its_counts(card):
    cb = torch.zeros(6, dtype=torch.int32, device=card)
    ptr = torch.zeros(5, dtype=torch.int32, device=card)
    perm = torch.arange(4, dtype=torch.int32, device=card)
    blocks = torch.zeros((5, 8, 8), device=card)
    x = torch.zeros((4, 8), device=card)
    with pytest.raises(TypeError, match="cell_valid"):
        K.bsr_spmv_sell_cuda(cb, cb, ptr, perm, blocks, x)
    with pytest.raises(ValueError, match="cell_valid"):
        K.bsr_spmv_sell_cuda(cb, cb, ptr, perm, blocks, x,
                             cell_valid=perm.long())
    bad_x = torch.zeros(4 * 8 + 1, device=card)[1:].view(4, 8)
    with pytest.raises(ValueError, match="x_blocks must be 16-byte aligned"):
        K.bsr_spmv_sell_cuda(cb, cb, ptr, perm, blocks, bad_x,
                             cell_valid=perm)


# --------------------- bsr_spgemm_pairs: the real pairs of each block

def _pair_members(rng, bs, case, n_mem):
    """Stacked pair lists built by hand: real pairs lead each row, the
    rest are the member's own (A sentinel, B sentinel); blocks with 0
    pairs, with every slot real, and (``case == "long"``) more pairs than
    one index batch and the ring hold."""
    n_c = 5
    mp = {"short": 5, "long": 300 if bs >= 96 else 40, "empty": 3}[case]
    n_a, n_b = 8, 9                            # tiles incl. pad tiles
    pa = np.zeros((n_mem, n_c, mp), np.int32)
    pb = np.zeros((n_mem, n_c, mp), np.int32)
    counts = np.zeros((n_mem, n_c), np.int32)
    a = np.zeros((n_mem, n_a, bs, bs), np.float32)
    b = np.zeros((n_mem, n_b, bs, bs), np.float32)
    for m in range(n_mem):
        za, zb = 5 + m % 3, 4 + m % 2          # the member's sentinels
        a[m, :za] = rng.standard_normal((za, bs, bs))
        b[m, :zb] = rng.standard_normal((zb, bs, bs))
        cnt = (np.zeros(n_c, np.int32) if case == "empty" else
               np.array([0, mp, 1, mp - 1, m + 1])[:n_c])
        counts[m] = cnt
        for k, c in enumerate(cnt):
            pa[m, k], pb[m, k] = za, zb
            pa[m, k, :c] = rng.integers(0, za, c)
            pb[m, k, :c] = rng.integers(0, zb, c)
    return pa, pb, counts, a, b


@pytest.mark.parametrize("bs", REDESIGN_BS)
@pytest.mark.parametrize("case", ["short", "long", "empty"])
@pytest.mark.parametrize("stacked", [False, True])
def test_spgemm_pairs_counts_match_all_slot_plain(card, bs, case, stacked):
    rng = np.random.default_rng(bs + len(case))
    n_mem = 2 if stacked else 1
    arrs = [torch.as_tensor(t, device=card)
            for t in _pair_members(rng, bs, case, n_mem)]
    if not stacked:
        arrs = [t[0] for t in arrs]
    pa, pb, counts, a, b = arrs
    before = GK.LAUNCHES["bsr_spgemm_pairs"]
    c = GK.bsr_spgemm_pairs_cuda(pa, pb, a, b, pair_counts=counts)
    torch.cuda.synchronize()
    assert GK.LAUNCHES["bsr_spgemm_pairs"] == before + 1
    want = GR.ref_pair_gemm(pa, pb, a, b)
    if case == "empty":
        assert not bool(c.any())
    _near(c, want)


def test_spgemm_pairs_nonfinite_tile_gives_plain_nan_pattern(card):
    """A NaN and an Inf in real A and B tiles: the products that read them
    are NaN or Inf exactly as in the all-slot sum."""
    rng = np.random.default_rng(5)
    pa, pb, counts, a, b = (torch.as_tensor(t[0], device=card) for t in
                            _pair_members(rng, 32, "short", 1))
    a[int(pa[1, 0]), 3, 4] = float("nan")
    b[int(pb[2, 0]), 5, 6] = float("inf")
    c = GK.bsr_spgemm_pairs_cuda(pa, pb, a, b, pair_counts=counts)
    torch.cuda.synchronize()
    want = GR.ref_pair_gemm(pa, pb, a, b)
    assert bool(want.isnan().any())
    _near(c, want)


def test_spgemm_pairs_wrapper_needs_its_counts(card):
    pa = torch.zeros((4, 3), dtype=torch.int32, device=card)
    a = torch.zeros((5, 8, 8), device=card)
    with pytest.raises(TypeError, match="pair_counts"):
        GK.bsr_spgemm_pairs_cuda(pa, pa, a, a)
    with pytest.raises(ValueError, match="pair_counts"):
        GK.bsr_spgemm_pairs_cuda(pa, pa, a, a, pair_counts=pa[:3, 0])


# ------------------- bsr_spgemm_cells: the flat cell stream of each block

def _cell_members(rng, bs, case, n_mem):
    """Stacked flat cell streams built by hand: output block k owns
    ``counts[k]`` real (A, B) cells, consecutive in the stream; 13 blocks
    (runs of consecutive blocks end inside and at the end of the output),
    blocks with no cells, and (``case == "long"``) a block with more cells
    than one index batch. Past the live cells the stream is padded with
    the member's (A sentinel, B sentinel) cells, which belong to no block."""
    long_n = 300 if case == "long" and bs >= 96 else 40
    counts = np.array([0, 1, 2, 1, long_n if case == "long" else 3, 0, 3, 1,
                       1, 0, 2, 1, 1])
    n_c = counts.size
    n_a, n_b = 8, 9                            # tiles incl. pad tiles
    n_list = int(counts.sum()) + 4 + n_mem
    ca = np.zeros((n_mem, n_list), np.int32)
    cbl = np.zeros((n_mem, n_list), np.int32)
    ptr = np.zeros((n_mem, n_c + 1), np.int32)
    a = np.zeros((n_mem, n_a, bs, bs), np.float32)
    b = np.zeros((n_mem, n_b, bs, bs), np.float32)
    for m in range(n_mem):
        za, zb = 5 + m % 3, 4 + m % 2          # the member's sentinels
        a[m, :za] = rng.standard_normal((za, bs, bs))
        b[m, :zb] = rng.standard_normal((zb, bs, bs))
        cnt = np.roll(counts, m)
        live = int(cnt.sum())
        ca[m], cbl[m] = za, zb
        ca[m, :live] = rng.integers(0, za, live)
        cbl[m, :live] = rng.integers(0, zb, live)
        ptr[m, 1:] = np.cumsum(cnt)
    return ca, cbl, ptr, a, b


@pytest.mark.parametrize("bs", REDESIGN_BS)
@pytest.mark.parametrize("case", ["short", "long"])
@pytest.mark.parametrize("stacked", [False, True])
def test_spgemm_cells_match_plain(card, bs, case, stacked):
    rng = np.random.default_rng(bs + len(case))
    n_mem = 2 if stacked else 1
    arrs = [torch.as_tensor(t, device=card)
            for t in _cell_members(rng, bs, case, n_mem)]
    if not stacked:
        arrs = [t[0] for t in arrs]
    ca, cbl, ptr, a, b = arrs
    before = GK.LAUNCHES["bsr_spgemm_cells"]
    c = GK.bsr_spgemm_cells_cuda(ca, cbl, ptr, a, b)
    torch.cuda.synchronize()
    assert GK.LAUNCHES["bsr_spgemm_cells"] == before + 1
    _near(c, GR.ref_cell_gemm_ptr(ca, cbl, ptr, a, b))
    empty = (ptr[..., 1:] == ptr[..., :-1])
    assert not bool(c[empty].any())            # blocks that own no cells


# ------------------------------------------------------- spgemm / spadd

PAIROP_SIZES = [(64, 8), (100, 16), (257, 32), (288, 96), (512, 128),
                (600, 256)]


def _pairop_entry(card, op, layout, n, bs, stacked):
    """The device leaves a plan (or a bucket of 3) caches, from its store
    entry: the kernel's exact inputs at the planner's shapes."""
    sched = (Schedule("bsr", bs, 1.0, layout="sell") if layout == "sell"
             else Schedule("bsr", bs, 1.0))
    pairs = [(CSR.from_dense(_dense(n - 8 * i, 0.06, 10 + i)),
              CSR.from_dense(_dense(n - 8 * i, 0.06, 20 + i)))
             for i in range(3 if stacked else 1)]
    store = PreparedStore(byte_budget=1 << 34)
    if stacked:
        plan_bucket(op, pairs, sched, store=store, device=card)
    else:
        plan(op, pairs[0], schedule=sched, store=store, device=card)
    (entry, _), = store._entries.values()
    return entry["stacked" if stacked else "dev"], entry["mode"]


@pytest.mark.parametrize("n,bs", PAIROP_SIZES)
@pytest.mark.parametrize("mode", ["pairs", "cells", "spadd"])
@pytest.mark.parametrize("stacked", [False, True])
def test_pairop_kernel_matches_plain(card, n, bs, mode, stacked):
    op, layout = (("spadd", "ell") if mode == "spadd" else
                  ("spgemm", "sell" if mode == "cells" else "ell"))
    dev, got_mode = _pairop_entry(card, op, layout, n, bs, stacked)
    assert got_mode == mode
    cuda_fn, plain_fn, _, _ = ops_builtin._PAIROP_FNS[mode]
    args, kw = ops_builtin.pairop_args(dev, mode)
    c = cuda_fn(*args, **kw)
    torch.cuda.synchronize()
    want = plain_fn(*args)
    if mode == "spadd":
        assert torch.equal(c, want)               # one fp32 add: exact
    else:
        torch.testing.assert_close(c, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("op,layout", [("spgemm", "ell"), ("spgemm", "sell"),
                                       ("spadd", "ell")])
def test_pairop_plan_and_bucket_on_card(card, op, layout):
    sched = (Schedule("bsr", 32, 1.0, layout="sell") if layout == "sell"
             else Schedule("bsr", 32, 1.0))
    pairs = [(CSR.from_dense(_dense(n, 0.05, n)),
              CSR.from_dense(_dense(n, 0.05, n + 1))) for n in (200, 160, 96)]

    def reference(a, b):
        da, db = a.to_dense().astype(np.float64), b.to_dense().astype(
            np.float64)
        return da @ db if op == "spgemm" else da + db

    for a, b in pairs:
        C = plan(op, (a, b), schedule=sched).execute()
        assert C.layout == "bsr" and C.device.type == "cuda"
        np.testing.assert_allclose(C.to_host().to_dense(), reference(a, b),
                                   rtol=1e-4, atol=1e-4)
    name = ("bsr_spadd" if op == "spadd" else
            "bsr_spgemm_cells" if layout == "sell" else "bsr_spgemm_pairs")
    counts = AK.LAUNCHES if op == "spadd" else GK.LAUNCHES
    before = counts[name]
    reset_counters()
    Cs = plan_bucket(op, pairs, sched).execute()
    assert launch_count(op) == 1 and counts[name] == before + 1
    for C, (a, b) in zip(Cs, pairs):
        np.testing.assert_allclose(C.to_host().to_dense(), reference(a, b),
                                   rtol=1e-4, atol=1e-4)


def _spadd_member(rng, bs, n_a, n_b, n_both, n_pad, a_pad, b_pad):
    """ia/ib over an A of n_a real tiles and a B of n_b (each followed by
    its +0.0 sentinel and a_pad / b_pad +0.0 bucket-pad tiles): n_both C
    blocks in both, the rest of A's and B's tiles alone, then n_pad C
    blocks that point past both sentinels (bucket-pad blocks)."""
    a = np.zeros((n_a + 1 + a_pad, bs, bs), np.float32)
    b = np.zeros((n_b + 1 + b_pad, bs, bs), np.float32)
    a[:n_a] = rng.standard_normal((n_a, bs, bs))
    b[:n_b] = rng.standard_normal((n_b, bs, bs))
    pa, pb = rng.permutation(n_a), rng.permutation(n_b)
    ia = np.concatenate([pa[:n_both], pa[n_both:],
                         np.full(n_b - n_both, n_a),
                         rng.integers(n_a, n_a + 1 + a_pad, n_pad)])
    ib = np.concatenate([pb[:n_both], np.full(n_a - n_both, n_b),
                         pb[n_both:], rng.integers(n_b, n_b + 1 + b_pad,
                                                   n_pad)])
    return (ia.astype(np.int32), ib.astype(np.int32), a, b,
            np.array([n_a, n_b], np.int32))


def _spadd_inputs(bs, members, seed):
    """One member, or ``members`` stacked as the bucket builder stacks
    them (each padded with its own sentinels and +0.0 tiles), on the
    host."""
    rng = np.random.default_rng(seed)
    ms = [_spadd_member(rng, bs, 7 + 3 * i, 5 + 2 * i, 3 + i, 2 + i, i, 2)
          for i in range(members)]
    if members == 1:
        return ms[0]
    n_c = max(m[0].size for m in ms)
    n_a = max(m[2].shape[0] for m in ms)
    n_b = max(m[3].shape[0] for m in ms)
    ia = np.stack([np.pad(m[0], (0, n_c - m[0].size),
                          constant_values=m[4][0]) for m in ms])
    ib = np.stack([np.pad(m[1], (0, n_c - m[1].size),
                          constant_values=m[4][1]) for m in ms])
    a = np.stack([np.pad(m[2], ((0, n_a - m[2].shape[0]), (0, 0), (0, 0)))
                  for m in ms])
    b = np.stack([np.pad(m[3], ((0, n_b - m[3].shape[0]), (0, 0), (0, 0)))
                  for m in ms])
    return ia, ib, a, b, np.stack([m[4] for m in ms])


def _real_tiles(blocks, sent, col):
    """(member index or Ellipsis, real tile slice) of each member: the
    tiles before its sentinel ``sent[..., col]``."""
    if blocks.ndim == 3:
        return [(Ellipsis, slice(0, int(sent[col])))]
    return [(m, slice(0, int(sent[m, col]))) for m in range(len(blocks))]


def _same_bits(x, y):
    """Equal bit for bit; NaN where the other is NaN."""
    nan = x.isnan()
    return (bool((nan == y.isnan()).all())
            and torch.equal(x[~nan].view(torch.int32),
                            y[~nan].view(torch.int32)))


@pytest.mark.parametrize("bs", [8, 32, 96, 128, 256])
@pytest.mark.parametrize("members", [1, 3])
def test_spadd_kernel_matches_plain_bit_for_bit(card, bs, members):
    """Blocks in A only, B only and both, and bucket-pad blocks past both
    sentinels, each member with its own sentinels."""
    ia, ib, a, b, sent = (torch.as_tensor(x, device=card)
                          for x in _spadd_inputs(bs, members, bs + members))
    before = AK.LAUNCHES["bsr_spadd"]
    c = AK.bsr_spadd_cuda(ia, ib, a, b, sentinels=sent)
    torch.cuda.synchronize()
    assert AK.LAUNCHES["bsr_spadd"] == before + 1
    assert _same_bits(c, AR.ref_block_union_add(ia, ib, a, b))
    pad = (ia >= sent[..., :1]) & (ib >= sent[..., 1:])
    assert bool(pad.any()) and bool((c[pad] == 0).all())
    assert not bool(torch.signbit(c[pad]).any())


@pytest.mark.parametrize("members", [1, 3])
def test_spadd_negative_zero_tile_gives_plus_zero(card, members):
    """-0.0 in every real A tile against a missing B: -0.0 + 0.0 is +0.0,
    as in the plain version; a copy would keep -0.0."""
    ia, ib, a, b, sent = _spadd_inputs(32, members, 5)
    for m, real in _real_tiles(a, sent, 0):
        a[m][real, 0, :4] = -0.0
    a_only = (ia < sent[..., :1]) & (ib >= sent[..., 1:])
    assert a_only.any()
    ia, ib, a, b, sent = (torch.as_tensor(x, device=card)
                          for x in (ia, ib, a, b, sent))
    c = AK.bsr_spadd_cuda(ia, ib, a, b, sentinels=sent)
    torch.cuda.synchronize()
    assert _same_bits(c, AR.ref_block_union_add(ia, ib, a, b))
    head = c[torch.as_tensor(a_only, device=card)][:, 0, :4]
    assert bool((head == 0).all()) and not bool(torch.signbit(head).any())


@pytest.mark.parametrize("bad", [float("nan"), float("inf"), -float("inf")])
@pytest.mark.parametrize("members", [1, 3])
def test_spadd_nonfinite_tiles_match_plain(card, bad, members):
    """NaN and Inf in A tiles reach C where the plain version puts them,
    alone and against a B tile (Inf + -Inf is NaN there too)."""
    ia, ib, a, b, sent = _spadd_inputs(16, members, 9)
    for m, real in _real_tiles(a, sent, 0):
        a[m][real][:4, 1, 2] = bad
    for m, real in _real_tiles(b, sent, 1):
        b[m][real][:2, 1, 2] = -bad
    ia, ib, a, b, sent = (torch.as_tensor(x, device=card)
                          for x in (ia, ib, a, b, sent))
    c = AK.bsr_spadd_cuda(ia, ib, a, b, sentinels=sent)
    torch.cuda.synchronize()
    want = AR.ref_block_union_add(ia, ib, a, b)
    assert not bool(want.isfinite().all())
    assert _same_bits(c, want)


def test_spadd_wrapper_needs_its_sentinels_on_card(card):
    ia, ib, a, b, sent = (torch.as_tensor(x, device=card)
                          for x in _spadd_inputs(8, 1, 0))
    with pytest.raises(TypeError, match="sentinels"):
        AK.bsr_spadd_cuda(ia, ib, a, b)
    with pytest.raises(ValueError, match="sentinels"):
        AK.bsr_spadd_cuda(ia, ib, a, b, sentinels=sent.long())
    with pytest.raises(ValueError, match="on"):
        AK.bsr_spadd_cuda(ia, ib, a, b, sentinels=sent.cpu())


# ------------------------------------------------ moe_gmm / flash_attention

def _assert_near(got, want, tol=1e-4):
    """max|got - want| within ``tol * max|want|`` (fp32 sums taken in
    another order)."""
    assert got.shape == want.shape and got.dtype == torch.float32
    assert bool(got.isfinite().all())
    d, m = float((got - want).abs().max()), float(want.abs().max())
    assert d <= tol * m, (d, m)


@pytest.mark.parametrize("tile_m", [32, 64, 128, 256])
@pytest.mark.parametrize("k,n,tile_k,tile_n", [(64, 96, 32, 32),
                                               (72, 200, 8, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_kernel_matches_plain(card, tile_m, k, n, tile_k, tile_n,
                                  dtype):
    """N and K edges the CTA tile (128 columns, 32-deep K chunks) does not
    divide; an empty expert still owns one tile."""
    rng = np.random.default_rng(tile_m + k)
    t, e = 300, 4
    eot = rng.integers(0, e - 1, t)          # expert e-1 gets no tokens
    x, te, _ = route_and_pad(
        rng.standard_normal((t, k)).astype(np.float32), eot, e, tile_m)
    w = rng.standard_normal((e, k, n)).astype(np.float32)
    xd = torch.as_tensor(x, device=card).to(dtype)
    wd = torch.as_tensor(w, device=card).to(dtype)
    ted = torch.as_tensor(te, device=card)
    before = MK.LAUNCHES["moe_gmm"]
    out = MK.moe_gmm_cuda(ted, xd, wd, tile_m=tile_m, tile_n=tile_n,
                          tile_k=tile_k)
    torch.cuda.synchronize()
    assert MK.LAUNCHES["moe_gmm"] == before + 1
    _assert_near(out, MR.ref_gmm(ted, xd, wd, tile_m=tile_m))


def _moe_counts_input(counts, k, n, tile_m, dtype, device, seed=0):
    """Tokens routed by explicit per-expert counts; w from the same seed."""
    rng = np.random.default_rng(seed)
    eot = np.repeat(np.arange(len(counts)), counts)
    x, te, inv = route_and_pad(
        rng.standard_normal((len(eot), k)).astype(np.float32), eot,
        len(counts), tile_m)
    w = rng.standard_normal((len(counts), k, n)).astype(np.float32)
    return x, te, inv, w


def _moe_run(x, te, w, tile_m, dtype, device):
    xd = torch.as_tensor(x, device=device).to(dtype)
    wd = torch.as_tensor(w, device=device).to(dtype)
    ted = torch.as_tensor(te, device=device)
    out = MK.moe_gmm_cuda(ted, xd, wd, tile_m=tile_m, tile_n=8, tile_k=8)
    torch.cuda.synchronize()
    return out, MR.ref_gmm(ted, xd, wd, tile_m=tile_m), \
        MR.live_row_ends(ted, xd, tile_m)


@pytest.mark.parametrize("tile_m", [32, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_kernel_nonfinite_w_gives_plain_masks(card, tile_m, dtype):
    """NaN, +Inf and -Inf in the weights of experts with real rows (one
    with 3 tokens, CUDA-core path; one with tile_m + 40, wgmma path) and of
    an empty expert: the plain version's NaN and +-Inf masks, the pad rows
    included (0 * Inf is NaN there)."""
    x, te, _, w = _moe_counts_input([tile_m + 40, 3, 0, 2 * tile_m - 5],
                                    72, 200, tile_m, dtype, card)
    w[0, 40, 13], w[0, 41, 14], w[0, 1, 15] = np.inf, -np.inf, np.nan
    w[1, 3, 11], w[1, 60, 12] = np.inf, -np.inf
    w[2, 5, 7], w[2, 70, 9] = np.nan, -np.inf
    w[3, 33, 100] = -np.inf
    out, ref, live = _moe_run(x, te, w, tile_m, dtype, card)
    assert 0 in live.tolist() and max(live.tolist()) > 16
    assert bool(ref.isnan().any()) and bool(ref.isposinf().any())
    _near(out, ref)


@pytest.mark.parametrize("tile_m", [32, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_kernel_computes_pad_rows_that_hold_values(card, tile_m, dtype):
    """A pad row with a value (CUDA-core tile) and a pad row with a NaN
    (an empty expert's tile, now 21 live rows: wgmma) are products, not
    the zero-row product."""
    x, te, inv, w = _moe_counts_input([3, 0, 50], 64, 96, tile_m, dtype,
                                      card, seed=1)
    t1 = list(te).index(1) * tile_m
    x[6, 3] = 1.5                       # expert 0's tile, a pad row
    x[t1 + 20, 8] = np.nan              # the empty expert's tile
    assert inv[6] < 0 and inv[t1 + 20] < 0
    out, ref, live = _moe_run(x, te, w, tile_m, dtype, card)
    assert live.tolist()[0] == 7 and live.tolist()[list(te).index(1)] == 21
    assert bool(ref[t1 + 20].isnan().all()) and bool(ref[6].abs().max() > 0)
    _near(out, ref)


@pytest.mark.parametrize("tile_m,tokens", [(128, 4), (128, 64), (256, 128),
                                           (256, 64), (64, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_kernel_hot_expert_and_warpgroup_boundary(card, tile_m, tokens,
                                                      dtype):
    """Every token on expert 0 (the decode loop's hot regime), at 4 tokens
    and at live rows that end exactly on a 64-row warpgroup boundary."""
    x, te, _, w = _moe_counts_input([tokens, 0, 0], 64, 96, tile_m, dtype,
                                    card, seed=2)
    out, ref, live = _moe_run(x, te, w, tile_m, dtype, card)
    assert live.tolist()[0] == tokens
    _assert_near(out, ref)


@pytest.mark.parametrize("tile_m", [128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_kernel_prefill_sized_both_paths(card, tile_m, dtype):
    """A prefill-sized input (about 1,700 tokens) whose tiles end at live
    counts on both sides of the dispatch threshold (0, 1, 4, 16 | 17, 64,
    72, 104, full), with K = 72 and N = 200 edges."""
    counts = [1000, 129, 16, 17, 0, 200, 64, 260]
    x, te, _, w = _moe_counts_input(counts, 72, 200, tile_m, dtype, card,
                                    seed=3)
    out, ref, live = _moe_run(x, te, w, tile_m, dtype, card)
    live = live.tolist()
    assert min(live) <= MK.SKINNY_ROWS < max(live)
    assert MK.SKINNY_ROWS in live and MK.SKINNY_ROWS + 1 in live
    _assert_near(out, ref)


@pytest.mark.parametrize("tile_m", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_kernel_rows_not_16_byte_multiples(card, tile_m, dtype):
    """K = 70 and N = 33: x and w rows are not 16-byte multiples, so both
    paths copy element by element (no cp.async groups, no tensor maps)."""
    x, te, _, w = _moe_counts_input([150, 16, 0, 64], 70, 33, tile_m,
                                    dtype, card, seed=4)
    xd = torch.as_tensor(x, device=card).to(dtype)
    wd = torch.as_tensor(w, device=card).to(dtype)
    ted = torch.as_tensor(te, device=card)
    out = MK.moe_gmm_cuda(ted, xd, wd, tile_m=tile_m, tile_n=11, tile_k=10)
    torch.cuda.synchronize()
    live = MR.live_row_ends(ted, xd, tile_m).tolist()
    assert min(live) <= MK.SKINNY_ROWS < max(live)
    _assert_near(out, MR.ref_gmm(ted, xd, wd, tile_m=tile_m))


def test_moe_wrapper_never_synchronizes(card):
    """The call returns while a long sleep queued ahead of it on the stream
    still runs: the wrapper reads nothing back from the card."""
    x, te, _, w = _moe_counts_input([5, 0, 40], 64, 96, 64, torch.float32,
                                    card)
    xd, wd = torch.as_tensor(x, device=card), torch.as_tensor(w, device=card)
    ted = torch.as_tensor(te, device=card)
    MK.moe_gmm_cuda(ted, xd, wd, tile_m=64, tile_n=8, tile_k=8)  # built
    torch.cuda.synchronize()
    before = MK.LAUNCHES["moe_gmm"]
    torch.cuda._sleep(2_000_000_000)
    slept = torch.cuda.Event()
    slept.record()
    out = MK.moe_gmm_cuda(ted, xd, wd, tile_m=64, tile_n=8, tile_k=8)
    assert not slept.query()
    assert MK.LAUNCHES["moe_gmm"] == before + 1
    torch.cuda.synchronize()
    _assert_near(out, MR.ref_gmm(ted, xd, wd, tile_m=64))


@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(card, d, causal, dtype):
    rng = np.random.default_rng(d)
    q, k, v = (torch.as_tensor(rng.standard_normal((3, 192, d)),
                               dtype=torch.float32, device=card).to(dtype)
               for _ in range(3))
    before = FK.LAUNCHES["flash_attention"]
    out = FK.flash_attention_cuda(q, k, v, causal=causal, block_q=64,
                                  block_k=64)
    torch.cuda.synchronize()
    assert FK.LAUNCHES["flash_attention"] == before + 1
    _assert_near(out, FR.ref_attention(q, k, v, causal=causal))


@pytest.mark.parametrize("s,d", [(96, 36), (40, 100)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_ragged_edges(card, s, d, causal):
    """S not a multiple of the kernel's 64-row tile, D not of 64."""
    rng = np.random.default_rng(s)
    q, k, v = (torch.as_tensor(rng.standard_normal((2, s, d)),
                               dtype=torch.float32, device=card)
               for _ in range(3))
    out = FK.flash_attention_cuda(q, k, v, causal=causal, block_q=8,
                                  block_k=8)
    torch.cuda.synchronize()
    _assert_near(out, FR.ref_attention(q, k, v, causal=causal))


@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_batch_heads_past_65535(card, causal):
    """BH beyond gridDim.y's 65535, as a large prefill batch gives; S spans
    two q tiles so both grid coordinates vary."""
    g = torch.Generator(device=card).manual_seed(7)
    q, k, v = (torch.randn((70001, 80, 8), generator=g, device=card)
               for _ in range(3))
    out = FK.flash_attention_cuda(q, k, v, causal=causal, block_q=16,
                                  block_k=16)
    torch.cuda.synchronize()
    _assert_near(out, FR.ref_attention(q, k, v, causal=causal))


def test_flash_kernel_long_sequence(card):
    """S = 4096 at D = 128, the main path's first input: 32 q tiles of
    128 rows, 256 chunks of 16 kv rows in the last."""
    g = torch.Generator(device=card).manual_seed(11)
    q, k, v = (torch.randn((2, 4096, 128), generator=g, device=card)
               for _ in range(3))
    out = FK.flash_attention_cuda(q, k, v, causal=True)
    torch.cuda.synchronize()
    _assert_near(out, FR.ref_attention(q, k, v, causal=True))


@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_large_scores(card, causal):
    """q and k scaled by 8, so the scores reach +-60: the online rescale
    works on large max jumps between chunks, where single-pass TF32 is
    off by 1e-2 * max|ref|."""
    rng = np.random.default_rng(8)
    q, k, v = (torch.as_tensor(rng.standard_normal((3, 512, 128)),
                               dtype=torch.float32, device=card)
               for _ in range(3))
    q, k = q * 8, k * 8
    out = FK.flash_attention_cuda(q, k, v, causal=causal)
    torch.cuda.synchronize()
    s = (q @ k.transpose(1, 2)) / 128 ** 0.5
    assert float(s.abs().max()) > 40
    _assert_near(out, FR.ref_attention(q, k, v, causal=causal))


def test_flash_kernel_bf16_long(card):
    """bfloat16 at D = 128, S = 1024: one TF32 pass for Q K^T (exact
    operands), two for P V, against the plain version on the same bf16
    inputs."""
    g = torch.Generator(device=card).manual_seed(12)
    q, k, v = (torch.randn((4, 1024, 128), generator=g, device=card)
               .to(torch.bfloat16) for _ in range(3))
    out = FK.flash_attention_cuda(q, k, v, causal=True)
    torch.cuda.synchronize()
    _assert_near(out, FR.ref_attention(q, k, v, causal=True))


def test_moe_and_flash_wrappers_raise(card):
    q = torch.zeros((2, 128, 260), device=card)
    with pytest.raises(ValueError, match="head dim 260"):
        FK.flash_attention_cuda(q, q, q)
    q = torch.zeros((2, 96, 64), device=card)
    with pytest.raises(ValueError, match="must divide by"):
        FK.flash_attention_cuda(q, q, q, block_q=64, block_k=64)
    with pytest.raises(ValueError, match="one CUDA device"):
        FK.flash_attention_cuda(q, q.cpu(), q, block_q=32, block_k=32)
    with pytest.raises(TypeError, match="float32 or all"):
        FK.flash_attention_cuda(q, q.double(), q, block_q=32, block_k=32)
    te = torch.zeros(2, dtype=torch.int32, device=card)
    x = torch.zeros((96, 32), device=card)
    w = torch.zeros((1, 32, 32), device=card)
    with pytest.raises(ValueError, match="row sub-tile"):
        MK.moe_gmm_cuda(te, x, w, tile_m=48, tile_n=32, tile_k=32)
    with pytest.raises(ValueError, match="one CUDA device"):
        MK.moe_gmm_cuda(te[:1].cpu(), x, w, tile_m=96, tile_n=32, tile_k=32)
    with pytest.raises(TypeError, match="int32"):
        MK.moe_gmm_cuda(torch.zeros(3, dtype=torch.int64, device=card), x,
                        w, tile_m=32, tile_n=32, tile_k=32)
    # experts 1 and -1 lie outside [0, 1): their tiles read nothing and
    # come out NaN
    out = MK.moe_gmm_cuda(torch.tensor([0, 1, -1], dtype=torch.int32,
                                       device=card), x, w, tile_m=32,
                          tile_n=32, tile_k=32)
    torch.cuda.synchronize()
    assert bool((out[:32] == 0).all()) and bool(out[32:].isnan().all())


def test_decode_loop_and_flash_plan_on_card(card):
    reset_counters()
    before = MK.LAUNCHES["moe_gmm"]
    res = decode_moe_ticks(6, d_model=256, d_ff=512, device=card)
    assert launch_count("moe_gmm") == 6
    assert MK.LAUNCHES["moe_gmm"] == before + 6
    rng = np.random.default_rng(0)
    w = torch.as_tensor(rng.standard_normal((8, 256, 512)),
                        dtype=torch.float32, device=card)
    for (x, te), (tm, _), out in zip(res["routed"], res["ticks"],
                                     res["outputs"]):
        assert out.device.type == "cuda"
        _assert_near(out, MR.ref_gmm(torch.as_tensor(te, device=card),
                                     torch.as_tensor(x, device=card), w,
                                     tile_m=tm))
    q, k, v = (torch.randn((4, 256, 64), device=card) for _ in range(3))
    out = plan("flash_attention", (), causal=True).execute(q, k, v)
    assert launch_count("flash_attention") == 1
    _assert_near(out, FR.ref_attention(q, k, v))


# ------------------------------------------------ guarded execution on card

class _FirstLaunchFault:
    """Installed as the fault injector: the first ``launch`` check fires,
    every other check passes (a one-off fault on the card's rung)."""

    def __init__(self):
        from repro_torch.sparse.resilience import FaultInjector
        self.inner = FaultInjector(0.0)
        self.fired = self.inner.fired
        self.recovered = self.inner.recovered

    def maybe_raise(self, site, detail=""):
        from repro_torch.sparse.resilience import InjectedFault
        self.inner.checks[site] += 1
        if site == "launch" and not self.fired[site]:
            self.fired[site] += 1
            raise InjectedFault(site, detail)

    def fire(self, site, detail=""):
        self.inner.checks[site] += 1
        return False


@pytest.mark.parametrize("fault", ["launch", "nan", "prep"])
def test_guard_raises_on_card_and_keeps_the_kernel(card, fault):
    """On the card the guard's chain is the kernel alone: an injected launch
    fault, a NaN output or a failing build is counted, the combo
    quarantined where a launch failed, and the error raised; no answer
    comes from the plain version or the host. The next launch of the
    quarantined combo runs the kernel again (a counted override) and gives
    the oracle's answer."""
    from repro_torch.sparse import (FaultInjector, GuardedExecutor,
                                    InjectedFault, NonFiniteOutput,
                                    install_injector, reset_resilience)
    reset_resilience()
    m = gen_zipf(700, seed=3)
    s = Schedule("bsr", 64, 1.0)
    x = np.random.default_rng(2).standard_normal(700).astype(np.float32)
    ex = GuardedExecutor()
    before = K.LAUNCHES["bsr_spmv_ell"]
    try:
        if fault == "prep":
            install_injector(FaultInjector(1.0, seed=0, sites=("prep",)))
            with pytest.raises(InjectedFault):
                plan("spmv", (m,), schedule=s, executor=ex)
            tel = ex.telemetry()
            assert tel["build_retries"] == ex.max_build_retries
            assert tel["dense_builds"] == 0 and len(ex.quarantine) == 0
            assert K.LAUNCHES["bsr_spmv_ell"] == before
            return
        p = plan("spmv", (m,), schedule=s, executor=ex)
        assert p.backend == "cuda"
        if fault == "launch":
            install_injector(_FirstLaunchFault())
            with pytest.raises(InjectedFault):
                p.execute(x)
            assert K.LAUNCHES["bsr_spmv_ell"] == before  # the fault came first
        else:
            xbad = np.full_like(x, np.nan)
            with pytest.raises(NonFiniteOutput):
                p.execute(xbad)
            assert K.LAUNCHES["bsr_spmv_ell"] == before + 1
            assert ex.nan_trips == 1
        tel = ex.telemetry()
        assert tel["exhausted"] == 1 and tel["fallbacks"] == 0
        assert tel["dense_served"] == 0 and ex.fallbacks["spmv"] == 0
        assert sum(tel.values()) == 1 + (fault == "nan")
        assert p.backend == "cuda"
        assert ex.quarantine.blocked("spmv", "cuda", s)
        n = K.LAUNCHES["bsr_spmv_ell"]
        y = p.execute(x)
        assert K.LAUNCHES["bsr_spmv_ell"] == n + 1 and p.backend == "cuda"
        assert ex.quarantine_overrides == 1 and ex.quarantine_skips == 0
        assert y.device.type == "cuda"
        np.testing.assert_allclose(y.cpu().numpy(), spmv_oracle(m, x),
                                   rtol=1e-4, atol=1e-4)
    finally:
        reset_resilience()


@pytest.mark.parametrize("value", [None, np.nan, np.inf, -np.inf, -0.0])
def test_output_finite_on_card_reads_only_the_verdict(card, value):
    """The check reduces on the card: no call copies more than one element
    to the host, the temporaries stay far below the output's size, and the
    verdict is numpy's."""
    from torch.overrides import TorchFunctionMode
    from repro_torch.sparse import output_finite
    t = torch.randn(4099, 8192, device=card)
    if value is not None:
        t[4098, 8191] = float(value)
    moves = []
    copies = {"cpu", "to", "numpy", "tolist", "item", "__bool__",
              "__array__", "clone"}

    class Spy(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            name = getattr(func, "__name__", "")
            if name in copies and args and isinstance(args[0], torch.Tensor):
                moves.append((name, args[0].numel()))
            return func(*args, **(kwargs or {}))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with Spy():
        ok = output_finite(t)
    peak = torch.cuda.max_memory_allocated() - base
    assert ok == bool(np.isfinite(t.cpu().numpy()).all())
    assert moves and max(n for _, n in moves) == 1, moves
    assert peak < t.numel() * t.element_size() // 64


def test_guarded_bucket_bs256_ell_counts_no_fall(card):
    """The selector's pick at full width is bs 256 ELL: its stacked bucket
    launch runs under the guard with the NaN check on and falls nowhere."""
    from repro_torch.sparse import GuardedExecutor
    mats = [gen_zipf(n, seed=n) for n in (1500, 1200, 900)]
    s = Schedule("bsr", 256, 1.0)
    rng = np.random.default_rng(4)
    xs = [rng.standard_normal(m.shape[1]).astype(np.float32) for m in mats]
    ex = GuardedExecutor(nan_guard=True)
    before = K.LAUNCHES["bsr_spmv_ell"]
    reset_counters()
    p = plan_bucket("spmv", mats, s, store=PreparedStore(), executor=ex)
    ys = p.execute(xs)
    assert p.backend == "cuda" and launch_count("spmv") == 1
    assert K.LAUNCHES["bsr_spmv_ell"] == before + 1
    assert sum(ex.telemetry().values()) == 0 and len(ex.quarantine) == 0
    for y, m, x in zip(ys, mats, xs):
        np.testing.assert_allclose(y.cpu().numpy(), spmv_oracle(m, x),
                                   rtol=1e-4, atol=1e-4)


def _engine_stream(engine, pop, xs, clock, trace):
    """Warm every tenant, then offer ``trace`` on the fake clock with a
    tick after every third submit, then run dry."""
    for t, (name, A) in enumerate(pop):
        engine.submit(f"warm:{name}", A, xs[t], tenant=t, rid=f"warm{t}")
    engine.drain_all()
    t0 = clock[0]
    for i, tr in enumerate(trace):
        clock[0] = t0 + tr.t_s
        engine.submit(tr.name, pop[tr.tenant][1], xs[tr.tenant],
                      tenant=tr.tenant, rid=tr.name)
        if i % 3 == 2:
            engine.tick()
    engine.drain_all()


def test_engine_on_card_matches_the_cpu_engine(card):
    """One fake-clock submit stream through a ServingEngine on the card
    and one on the CPU: the same drains and ledger, every drained output
    equal to the CPU engine's within 2e-5, and the drains launched as the
    ELL kernels (alone for one request, the multi-RHS kernel for a
    content-pure slot of several)."""
    from repro_torch.core import H100_SXM, ScheduleTuner, corpus
    from repro_torch.selector import ScheduleCache, SelectorService
    from repro_torch.serving import (ServingEngine, generate_trace,
                                     tenant_population, tenant_rhs)
    tuner = ScheduleTuner("spmv", H100_SXM).fit(
        corpus(n_matrices=9, n_min=256, n_max=512, seed=0), max_mats=9)
    pop = tenant_population(4, n_min=256, n_max=1024, seed=500)
    xs = tenant_rhs(pop, seed=0)
    trace = generate_trace(40, 800.0, 4, seed=3)
    logs, tels = {}, {}
    for dev in ("cuda", "cpu"):
        clock = [100.0]
        engine = ServingEngine(
            SelectorService(tuner, cache=ScheduleCache(),
                            confidence_threshold=0.0, device=dev),
            slot_max=4, admit_max=3, clock=lambda c=clock: c[0])
        log = logs[dev] = []
        inner = engine.service.drain_bucket

        def drain(members, backend="auto", inner=inner, log=log):
            decs = inner(members, backend=backend)
            log.append([(r.name, d.y) for (r, _), d in zip(members, decs)])
            return decs

        engine.service.drain_bucket = drain
        before = dict(K.LAUNCHES)
        _engine_stream(engine, pop, xs, clock, trace)
        tels[dev] = engine.telemetry()
        if dev == "cuda":
            launched = {k: K.LAUNCHES[k] - before[k] for k in before}
            assert sum(engine.service.executor.telemetry().values()) == 0
    assert [[n for n, _ in d] for d in logs["cuda"]] == \
        [[n for n, _ in d] for d in logs["cpu"]]
    for d, dc in zip(logs["cuda"], logs["cpu"]):
        for (_, y), (_, yc) in zip(d, dc):
            np.testing.assert_allclose(y, yc, rtol=2e-5, atol=2e-5)
    for k in ("submitted", "admitted", "completed", "shed", "drains",
              "multi_request_drains", "resident_admits"):
        assert tels["cuda"][k] == tels["cpu"][k], k
    singles = sum(len(d) == 1 for d in logs["cuda"])
    assert tels["cuda"]["multi_request_drains"] > 0
    assert launched["bsr_spmv_ell"] == singles
    assert launched["bsr_spmm_ell"] == tels["cuda"]["multi_request_drains"]


def test_engine_thread_runs_on_the_services_card(card):
    """``start()``'s serving thread makes the service's card current and
    drains there: every output matches its schedule's plain version on
    the CPU (a q < 1 ELL pick truncates rows past its cap)."""
    from repro_torch.core import H100_SXM, ScheduleTuner, corpus
    from repro_torch.selector import ScheduleCache, SelectorService
    from repro_torch.serving import (ServingEngine, tenant_population,
                                     tenant_rhs)
    tuner = ScheduleTuner("spmv", H100_SXM).fit(
        corpus(n_matrices=9, n_min=256, n_max=512, seed=0), max_mats=9)
    pop = tenant_population(3, n_min=256, n_max=1024, seed=500)
    xs = tenant_rhs(pop, seed=0)
    svc = SelectorService(tuner, cache=ScheduleCache(),
                          confidence_threshold=0.0, device=card)
    engine = ServingEngine(svc, slot_max=8)
    outs = []
    inner = svc.drain_bucket

    def drain(members, backend="auto"):
        assert torch.cuda.current_device() == card.index
        decs = inner(members, backend=backend)
        outs.extend((r.csr, r.x, d) for (r, _), d in zip(members, decs))
        return decs

    svc.drain_bucket = drain
    engine.start()
    try:
        for j in range(12):
            t = j % len(pop)
            assert engine.submit(f"th{j}", pop[t][1], xs[t], tenant=t)
        deadline = time.monotonic() + 60.0
        while engine.backlog and time.monotonic() < deadline:
            time.sleep(0.005)
    finally:
        engine.stop()
    tel = engine.telemetry()
    assert tel["completed"] == 12 and len(outs) == 12
    for A, x, d in outs:
        ref = plan("spmv", (A,), schedule=d.schedule, device="cpu").execute(x)
        np.testing.assert_allclose(d.y, ref.numpy(), rtol=1e-4, atol=1e-4)


def _two_insert_row(d, bs):
    """(block-row, two block-cols) of the first block-row of ``d`` with
    two fully empty blocks."""
    n_b = -(-d.shape[0] // bs)
    for br in range(n_b):
        empty = [bc for bc in range(n_b)
                 if not d[br * bs:(br + 1) * bs, bc * bs:(bc + 1) * bs].any()]
        if len(empty) >= 2:
            return br, empty[:2]
    raise AssertionError("no block-row with two empty blocks")


@pytest.mark.parametrize("bs", [8, 32, 96])
@pytest.mark.parametrize("layout", ["ell", "sell"])
@pytest.mark.parametrize("multi", [False, True])
def test_mutated_operand_kernels_match_plain(card, bs, layout, multi):
    """A value delta and two inserts into one block-row, written into a
    slack container on the card: the kernel (which stops at
    ``valid_counts`` / ``cell_valid``) against its plain version (every
    slot or cell) and the float64 oracle of the mutated matrix."""
    from repro_torch.sparse import Delta, SparseTensor
    n = 6 * bs + 5
    d = _dense(n, 1.5 / bs ** 2, bs)
    A = CSR.from_dense(d)
    rng = np.random.default_rng(bs)
    st = SparseTensor.from_csr(A, layout=None if layout == "ell" else layout,
                               block_size=bs, slack=3, shape_bucket=True,
                               device=card)
    lens = np.diff(A.row_ptrs)
    rows = np.repeat(np.arange(n), lens)
    pick = rng.choice(rows.size, size=min(12, rows.size), replace=False)
    br, (c0, c1) = _two_insert_row(d, bs)
    r = np.r_[rows[pick], br * bs, br * bs + 1, br * bs + 2]
    c = np.r_[A.col_idxs[pick].astype(np.int64), c0 * bs, c0 * bs + 3,
              c1 * bs]
    v = rng.standard_normal(r.size).astype(np.float32)
    st.apply_delta(Delta(r, c, v, "set"))
    want = d.astype(np.float64)
    want[r, c] = v
    x = rng.standard_normal((n, 16) if multi else n).astype(np.float32)
    op = "spmm" if multi else "spmv"
    name = f"bsr_{op}_{layout}"
    before = K.LAUNCHES[name]
    y_k = plan(op, (st,), backend="cuda").execute(x).cpu().numpy()
    y_p = plan(op, (st,), backend="torch", device=card).execute(
        x).cpu().numpy()
    assert K.LAUNCHES[name] == before + 1
    np.testing.assert_allclose(y_k, y_p, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(y_k, want @ x, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("layout", ["ell", "sell"])
def test_mutable_matrix_on_card(card, layout):
    """MutableMatrix through a store on the card: value steps in place (no
    host prep), inserts within slack, then a delta past the spare pool
    swaps the epoch; every SpMV within 1e-4 of the oracle."""
    from repro_torch.core.synthetic import gen_spatial
    from repro_torch.sparse import Delta, MutableMatrix
    A = gen_spatial(4096, seed=0)
    rng = np.random.default_rng(3)
    x = rng.standard_normal(A.shape[1]).astype(np.float32)
    store = PreparedStore()
    mm = MutableMatrix(A, store=store, slack=2)
    s = (Schedule("bsr", 32, 1.0, layout="sell", slice_height=8)
         if layout == "sell" else Schedule("bsr", 32, 1.0))

    def y():
        p = plan("spmv", (A,), schedule=s, store=store, device=card)
        out = p.execute(x).cpu().numpy()
        np.testing.assert_allclose(out, spmv_oracle(A, x), rtol=1e-4,
                                   atol=1e-4 * np.abs(out).max())
        return p.operands[0]

    st = y()
    misses = store.misses
    rows = np.repeat(np.arange(A.shape[0]), np.diff(A.row_ptrs))
    for mode in ("set", "add"):
        pick = rng.choice(A.nnz, size=A.nnz // 100, replace=False)
        mm.apply_delta(Delta(rows[pick], A.col_idxs[pick].astype(np.int64),
                             rng.standard_normal(pick.size).astype(
                                 np.float32), mode))
        assert y() is st
    assert store.misses == misses
    def absent(br, k):
        """k block-cols of block-row ``br`` that hold no block yet."""
        return [bc for bc in range(128)
                if (br, bc) not in st._mut["block_map"]][:k]

    # two new blocks in each of two block-rows, within the slack
    new = [(br, bc) for br in (0, 64) for bc in absent(br, 2)]
    r = np.array([br * 32 + 1 for br, _ in new])
    c = np.array([bc * 32 + 2 for _, bc in new])
    mm.apply_delta(Delta(r, c, np.ones(r.size, np.float32)))
    assert y() is st and mm.epoch_swaps == 0
    # one new block in each of more block-rows than the pool has blocks
    past = [(br, absent(br, 1)[0])
            for br in range(1, 2 + len(st.spare_blocks))]
    mm.apply_delta(Delta(np.array([br * 32 for br, _ in past]),
                         np.array([bc * 32 for _, bc in past]),
                         np.full(len(past), 2.0, np.float32)))
    assert y() is not st and mm.epoch_swaps == 1


# ------------------------------------------------------------- sharded plans

SHARD_SCHEDS = [Schedule("bsr", 32, 1.0),
                Schedule("bsr", 16, 1.0, layout="sell", slice_height=4),
                Schedule("bsr", 64, 1.0),
                Schedule("bsr", 32, 1.0, layout="sell", slice_height=8)]


@pytest.mark.parametrize("op", ["spmv", "spmm"])
def test_sharded_heterogeneous_plan_on_card_through_streams(card, op):
    """Four shards under four schedules: one launch per shard, each on its
    own CUDA stream, joined on the caller's; the result equals the CPU
    plan's (the plain versions) and the float64 oracle."""
    from repro_torch.sparse import plan_sharded
    A = gen_zipf(2048, seed=2, a=1.6)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((A.shape[1], 8) if op == "spmm"
                            else A.shape[1]).astype(np.float32)
    K.reset_launch_counts()
    reset_counters()
    p = plan_sharded(op, (A,), n_shards=4, schedules=SHARD_SCHEDS,
                     device=card)
    y = p.execute(x).cpu().numpy()
    assert launch_count(op) == 1 and p.schedule is None
    kernel = "bsr_spmm" if op == "spmm" else "bsr_spmv"
    assert K.LAUNCHES[f"{kernel}_ell"] == 2
    assert K.LAUNCHES[f"{kernel}_sell"] == 2
    y_cpu = plan_sharded(op, (A,), n_shards=4, schedules=SHARD_SCHEDS,
                         device="cpu").execute(x).numpy()
    np.testing.assert_allclose(y, y_cpu, rtol=1e-4,
                               atol=1e-4 * np.abs(y_cpu).max())
    ref = A.to_dense().astype(np.float64) @ x
    np.testing.assert_allclose(y, ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("layout", ["ell", "sell"])
def test_sharded_uniform_plan_is_one_launch_on_card(card, layout):
    from repro_torch.sparse import plan_sharded
    A = gen_zipf(2048, seed=2, a=1.6)
    s = (Schedule("bsr", 32, 1.0, layout="sell", slice_height=8)
         if layout == "sell" else Schedule("bsr", 32, 1.0))
    x = np.random.default_rng(1).standard_normal(A.shape[1]).astype(
        np.float32)
    store = PreparedStore()
    p = plan_sharded("spmv", (A,), n_shards=4, schedule=s, store=store,
                     device=card)
    K.reset_launch_counts()
    reset_counters()
    y = p.execute(x).cpu().numpy()
    assert launch_count("spmv") == 1
    assert K.LAUNCHES[f"bsr_spmv_{layout}"] == 1
    assert sum(K.LAUNCHES.values()) == 1
    single = plan("spmv", (A,), schedule=s, device=card).execute(x)
    np.testing.assert_allclose(y, single.cpu().numpy(), rtol=1e-4,
                               atol=1e-4 * np.abs(y).max())
    np.testing.assert_allclose(y, spmv_oracle(A, x), rtol=1e-4,
                               atol=1e-4 * np.abs(y).max())


@pytest.mark.parametrize("layout", ["ell", "sell"])
@pytest.mark.parametrize("multi", [False, True])
def test_stacked_kernels_read_one_shared_x(card, layout, multi):
    """Row shards stacked as members read one x expanded over the member
    axis (stride 0, no copy per member): the launch equals the launch on a
    materialized copy bit for bit, and the plain version."""
    from repro_torch.sparse import partition_rows
    A = gen_zipf(2048, seed=2, a=1.6)
    s = (Schedule("bsr", 32, 1.0, layout="sell", slice_height=8)
         if layout == "sell" else Schedule("bsr", 32, 1.0))
    part = partition_rows(A, 4, "nnz")
    built = ops_builtin._build_matvec_bucket(
        part.slice(A), s, ops_builtin.SELL_SIGMA, True, card)
    width = built["width"]
    g = torch.Generator(device=card).manual_seed(5)
    x = torch.randn((width, 8) if multi else (width,), generator=g,
                    device=card)
    xb = x.reshape((width // 32, 32) + tuple(x.shape[1:]))
    shared = xb.unsqueeze(0).expand(4, *xb.shape)
    assert shared.stride(0) == 0
    name = f"bsr_{'spmm' if multi else 'spmv'}_{layout}"
    before = K.LAUNCHES[name]
    y = ops_builtin._run_layout(built["arrays"], layout, shared, "cuda")
    y_copy = ops_builtin._run_layout(built["arrays"], layout,
                                     shared.contiguous(), "cuda")
    assert K.LAUNCHES[name] == before + 2
    assert torch.equal(y, y_copy)
    plain = ops_builtin._run_layout(built["arrays"], layout, shared, "plain")
    torch.testing.assert_close(y, plain, rtol=1e-4,
                               atol=1e-4 * float(plain.abs().max()))


def test_sharded_prepared_tensor_plans_from_its_shards(card):
    """A prepared ShardedSparseTensor under one schedule launches from the
    shards it holds on the card, one per shard: no stack (a second device
    copy) is built or stored."""
    from repro_torch.sparse import ShardedSparseTensor, plan_sharded
    A = gen_zipf(2048, seed=2, a=1.6)
    s = Schedule("bsr", 32, 1.0)
    sst = ShardedSparseTensor.from_csr(A, 4, s, device=card)
    store = PreparedStore()
    p = plan_sharded("spmv", (sst,), store=store, device=card)
    assert p.schedule == s and p.operands[0] is sst
    assert not any(k[0] == "matvec_shards_stacked" for k in store._entries)
    x = np.random.default_rng(1).standard_normal(A.shape[1]).astype(
        np.float32)
    K.reset_launch_counts()
    y = p.execute(x).cpu().numpy()
    assert K.LAUNCHES["bsr_spmv_ell"] == 4
    np.testing.assert_allclose(y, spmv_oracle(A, x), rtol=1e-4,
                               atol=1e-4 * np.abs(y).max())


@pytest.mark.parametrize("op", ["spmv", "spmm"])
def test_sharded_plan_round_robin_over_cards(card, op):
    """Heterogeneous shards placed round-robin over every card: x reaches
    the other cards and the outputs come back by device-to-device copies,
    and the result equals the CPU plan's."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    from repro_torch.sparse import plan_sharded
    A = gen_zipf(2048, seed=2, a=1.6)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((A.shape[1], 8) if op == "spmm"
                            else A.shape[1]).astype(np.float32)
    p = plan_sharded(op, (A,), n_shards=4, schedules=SHARD_SCHEDS,
                     device=card)
    cards = {st.arrays["blocks"].device for st in p.operands[0].shards}
    assert len(cards) == min(4, torch.cuda.device_count())
    y = p.execute(x)
    assert y.device == card
    y_cpu = plan_sharded(op, (A,), n_shards=4, schedules=SHARD_SCHEDS,
                         device="cpu").execute(x).numpy()
    np.testing.assert_allclose(y.cpu().numpy(), y_cpu, rtol=1e-4,
                               atol=1e-4 * np.abs(y_cpu).max())


# ------------------------------------------------------------------ the LM

@pytest.mark.parametrize("arch", ["llama3.2-3b", "gemma2-9b",
                                  "mixtral-8x22b"])
def test_lm_prefill_and_decode_on_card_equal_the_cpu_port(card, arch):
    """A reduced config's weights drawn once on the CPU and copied to the
    card: prefill logits, the cache and three greedy decode steps equal
    the CPU port's at float32 compute (full fp32 matmuls on both)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              compute_dtype="float32")
    cpu = Model(cfg, device="cpu").init(seed=3)
    gpu = Model(cfg, device=card)
    gpu.load_state_dict(cpu.state_dict())
    toks = torch.as_tensor(np.random.default_rng(4).integers(
        1, cfg.vocab_size, (2, 64)))
    lc, cc = cpu.prefill({"tokens": toks}, attn_chunk=32, cache_len=70)
    lg, cg = gpu.prefill({"tokens": toks}, attn_chunk=32, cache_len=70)

    def close(a, b):
        a, b = a.float().cpu(), b.float()
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())

    close(lg, lc)
    for c_g, c_c in zip(cg, cc):
        close(c_g["self"]["k"], c_c["self"]["k"])
    tok = torch.argmax(lc, -1)
    for step in range(3):
        lc, cc = cpu.decode(cc, tok, 64 + step)
        lg, cg = gpu.decode(cg, tok.to(card), 64 + step)
        close(lg, lc)
        tok = torch.argmax(lc, -1)


# ------------------------------------------- the LM's training and families

def _reduced_pair(card, arch, seed=3, **kw):
    """A reduced config at float32 compute on the CPU and on the card, on
    the same weights."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              compute_dtype="float32", **kw)
    cpu = Model(cfg, device="cpu").init(seed=seed)
    gpu = Model(cfg, device=card)
    gpu.load_state_dict(cpu.state_dict())
    return cpu, gpu


def _lm_batch(cfg, b=2, s=64, seed=4):
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.as_tensor(rng.integers(1, cfg.vocab_size,
                                                    (b, s)))}
    if cfg.is_encdec:
        batch["audio_embed"] = torch.as_tensor(rng.standard_normal(
            (b, cfg.encoder_len, cfg.d_model)).astype(np.float32))
    return batch


def _close(a, b, tol=1e-4):
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    assert float((a - b).abs().max()) <= tol * max(float(b.abs().max()),
                                                   1e-30)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "mixtral-8x22b",
                                  "mamba2-780m", "recurrentgemma-9b",
                                  "whisper-large-v3", "qwen2-vl-72b"])
def test_lm_loss_and_grads_on_card_equal_the_cpu_port(card, arch):
    """``Model.loss`` and its gradients on the card against the CPU port
    at float32 compute (full fp32 matmuls on both), under remat
    ``dots_no_batch`` on the card and none on the CPU."""
    cpu, gpu = _reduced_pair(card, arch)
    batch = _lm_batch(cpu.cfg)
    lc, _ = cpu.loss(batch, remat="none", attn_chunk=32)
    lc.backward()
    lg, _ = gpu.loss(batch, remat="dots_no_batch", attn_chunk=32)
    lg.backward()
    _close(lg, lc, 1e-5)
    for (n, pc), pg in zip(cpu.named_parameters(), gpu.parameters()):
        _close(pg.grad, pc.grad)


@pytest.mark.parametrize("arch", ["mamba2-780m", "recurrentgemma-9b",
                                  "whisper-large-v3", "qwen2-vl-72b"])
def test_families_prefill_and_decode_on_card_equal_the_cpu_port(card, arch):
    """The ssm, hybrid, audio and vlm configs' prefill logits, caches
    (SSD / RG-LRU states, cross K/V) and three greedy decode steps on the
    card equal the CPU port's at float32 compute."""
    cpu, gpu = _reduced_pair(card, arch)
    batch = _lm_batch(cpu.cfg)
    lc, cc = cpu.prefill(batch, attn_chunk=32, cache_len=70)
    lg, cg = gpu.prefill(batch, attn_chunk=32, cache_len=70)
    _close(lg, lc)
    for c_g, c_c in zip(cg, cc):
        for part in c_c:
            for k in c_c[part]:
                _close(c_g[part][k], c_c[part][k])
    tok = torch.argmax(lc, -1)
    for step in range(3):
        lc, cc = cpu.decode(cc, tok, 64 + step)
        lg, cg = gpu.decode(cg, tok.to(card), 64 + step)
        _close(lg, lc)
        tok = torch.argmax(lc, -1)


def test_train_driver_on_card(card, tmp_path):
    """The reference's two system tests' properties through
    ``launch.train`` on the card: a reduced llama loses more than 0.5 in
    40 steps; a reduced mamba2 with simulated failures ends at step 12
    after 2 restarts, re-running steps 3 and 6-7 (checkpoints every 3
    steps), each loss within 1e-5 of an uninterrupted run's."""
    from repro_torch.launch import train
    res = train.main(["--arch", "llama3.2-3b", "--reduced", "--steps", "40",
                      "--batch", "8", "--seq", "64", "--lr", "3e-3",
                      "--ckpt-dir", str(tmp_path / "a"), "--save-every",
                      "100", "--attn-chunk", "32", "--device", "cuda"])
    assert res["losses"][-1] < res["losses"][0] - 0.5
    assert res["restarts"] == 0 and res["loss_steps"] == list(range(40))
    argv = ["--arch", "mamba2-780m", "--reduced", "--steps", "12",
            "--batch", "4", "--seq", "64", "--save-every", "3",
            "--attn-chunk", "32", "--device", "cuda"]
    res = train.main(argv + ["--simulate-failures", "--ckpt-dir",
                             str(tmp_path / "b")])
    clean = train.main(argv + ["--ckpt-dir", str(tmp_path / "c")])
    assert res["final_step"] == 12 and res["restarts"] == 2
    assert res["loss_steps"] == [0, 1, 2, 3, 3, 4, 5, 6, 7, 6, 7, 8, 9,
                                 10, 11]            # steps 3 and 6-7 re-run
    assert clean["restarts"] == 0 and clean["loss_steps"] == list(range(12))
    for step, loss in zip(res["loss_steps"], res["losses"]):
        assert abs(loss - clean["losses"][step]) <= \
            1e-5 * abs(clean["losses"][step])


def test_ssd_masked_decay_keeps_grads_finite_on_card(card):
    """One SSD chunk of mamba2-780m's full size at its initial decay: the
    reference's unmasked ``exp`` form gives non-finite gradients, the
    port's finite ones and the same values."""
    import chip_smoke
    out = chip_smoke.ssd_reference_form("cuda", 0)
    assert out["max_decay_sum"] > 88.8
    assert not out["reference"]["finite_grads"]
    assert out["port"]["finite_grads"] and out["values_rel_diff"] < 1e-6
