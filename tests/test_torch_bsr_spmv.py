"""The port's ELL/SELL-BSR SpMV/SpMM kernels held against the JAX package:
the plain PyTorch versions (what the wrappers compute on CPU tensors) match
the JAX ``ref_*`` oracles AND the Pallas kernels run with
``interpret=True``, on the shapes of ``tests/test_kernels.py``; the stacked
member form equals the per-member form; the wrappers' CUDA branch raises
on a failed launch and never falls back; and the package imports neither
jax nor ``repro``. The kernels themselves run on the card in
``test_torch_cuda.py``."""
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BSR as JBSR
from repro.core import CSR as JCSR
from repro.core import ELLBSR as JELLBSR
from repro.kernels.bsr_spmv import kernel as jk
from repro.kernels.bsr_spmv import ref as jref
from repro_torch.core import (BSR, CSR, ELLBSR, SELLBSR, Schedule,
                              spmm_oracle, spmv_oracle)
from repro_torch.core.synthetic import gen_zipf
from repro_torch.kernels import common
from repro_torch.kernels.bsr_spmv import kernel as K
from repro_torch.kernels.bsr_spmv import ops, ref
from repro_torch.sparse.ops_builtin import (_build_matvec_bucket,
                                           _pad_member_axis)

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
    wrapper = K.bsr_spmm_cuda if multi else K.bsr_spmv_cuda
    y = wrapper(*(_t(a) for a in args)).numpy()   # CPU -> plain version
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
    cb, cc, ptr, perm, blocks = ops.sell_device_arrays(sell, device="cpu")
    wrapper = K.bsr_spmm_sell_cuda if multi else K.bsr_spmv_sell_cuda
    y = wrapper(cb, cc, ptr, perm, blocks, _t(xb)).numpy()
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
    stacked = fn(*(arrs[n] for n in names), arrs["blocks"], _t(xs))
    for b in range(4):
        one = fn(*(arrs[n][b] for n in names), arrs["blocks"][b],
                 _t(xs[b]))
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
            (K.bsr_spmm_cuda if multi else K.bsr_spmv_cuda)(idx, cols,
                                                            blocks, x)
        else:
            cb = torch.zeros(6, dtype=torch.int32, device="meta")
            ptr = torch.zeros(5, dtype=torch.int32, device="meta")
            perm = torch.zeros(4, dtype=torch.int32, device="meta")
            (K.bsr_spmm_sell_cuda if multi else K.bsr_spmv_sell_cuda)(
                cb, cb.clone(), ptr, perm, blocks, x)
    assert K.LAUNCHES[name] == before + 1


def test_wrappers_reject_what_the_kernel_does_not_take():
    idx, cols, blocks, x = _meta_ell(False)
    with pytest.raises(TypeError):
        K.bsr_spmv_cuda(idx.long(), cols, blocks, x)
    with pytest.raises(ValueError, match="multiple of 8"):
        K.bsr_spmm_cuda(idx, cols, blocks,
                        torch.zeros((4, 8, 5), device="meta"))
    with pytest.raises(ValueError, match="block size"):
        K.bsr_spmv_cuda(idx, cols, torch.zeros((5, 6, 6), device="meta"),
                        torch.zeros((4, 6), device="meta"))
    with pytest.raises(ValueError, match="contiguous"):
        K.bsr_spmv_cuda(idx, cols, blocks, torch.zeros((8, 4),
                                                       device="meta").t())


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
