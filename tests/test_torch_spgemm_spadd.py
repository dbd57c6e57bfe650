"""The port's spgemm/spadd plan path held against the JAX package's
(``repro.sparse``, ``backend="jnp"`` and ``"interpret"``): C through the
facade, the symbolic leaves and prepared-store entries bit for bit, one
launch per bucket, the warm store path, the cell pointer that gives bucket
pad cells to no output block, the converter from JAX "bsr" leaves, the
wrappers' CUDA branch, and the import hygiene of the port. The kernels
themselves run on the card in ``test_torch_cuda.py``."""
import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import CSR as JCSR
from repro.core.autotune import Schedule as JSchedule
from repro.kernels.bsr_spgemm import ops as jgops
from repro.kernels.bsr_spadd import ops as jaops
from repro.sparse import PreparedStore as JPreparedStore
from repro.sparse import SparseTensor as JSparseTensor
from repro.sparse import ops_builtin as jops
from repro.sparse import plan as jplan
from repro.sparse import plan_bucket as jplan_bucket
from repro_torch import convert
from repro_torch.core import BSR, CSR, Schedule
from repro_torch.kernels.bsr_spadd import kernel as AK
from repro_torch.kernels.bsr_spadd import ops as aops
from repro_torch.kernels.bsr_spgemm import kernel as GK
from repro_torch.kernels.bsr_spgemm import ops as gops
from repro_torch.kernels.bsr_spgemm import ref as gref
from repro_torch.sparse import (PreparedStore, SparseTensor, content_key,
                                launch_count, ops_builtin, plan, plan_bucket,
                                reset_counters)

CPU = "cpu"
ROOT = Path(__file__).resolve().parents[1]
TOL = 2e-4            # the reference's own (tests/test_kernels.py)


def _sparse(n, m, density, seed):
    """The same random matrix as the port's CSR and the JAX package's."""
    rng = np.random.default_rng(seed)
    d = (rng.random((n, m)) < density) * rng.standard_normal((n, m))
    csr = CSR.from_dense(d.astype(np.float32))
    return csr, JCSR(csr.row_ptrs, csr.col_idxs, csr.nnz_vals, csr.shape)


def _scheds(layout, bs):
    kw = dict(layout="sell") if layout == "sell" else {}
    return Schedule("bsr", bs, 1.0, **kw), JSchedule("bsr", bs, 1.0, **kw)


def _assert_same_structure(st, jbsr):
    """The port's C (a "bsr" SparseTensor) has the JAX facade's BSR
    structure, array types included."""
    host = st.to_host()
    assert isinstance(host, BSR)
    for f in ("block_ptrs", "block_cols"):
        got, want = getattr(host, f), np.asarray(getattr(jbsr, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert host.blocks.dtype == np.asarray(jbsr.blocks).dtype
    assert host.blocks.shape == np.asarray(jbsr.blocks).shape
    assert tuple(host.shape) == tuple(jbsr.shape)
    assert host.block_size == jbsr.block_size


# ------------------------------------------------------------- spgemm


@pytest.mark.parametrize("n,bs", [(48, 8), (64, 16), (130, 32)])
@pytest.mark.parametrize("layout", ["ell", "sell"])
@pytest.mark.parametrize("jbackend", ["jnp", "interpret"])
def test_spgemm_matches_jax(n, bs, layout, jbackend):
    (a, ja), (b, jb) = _sparse(n, n, 0.08, n), _sparse(n, n, 0.08, n + 5)
    s, js = _scheds(layout, bs)
    C = plan("spgemm", (a, b), schedule=s, device=CPU).execute()
    assert C.layout == "bsr" and C.device == torch.device(CPU)
    jC = jplan("spgemm", (ja, jb), schedule=js, backend=jbackend).execute()
    _assert_same_structure(C, jC)
    np.testing.assert_allclose(C.to_host().blocks, np.asarray(jC.blocks),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(C.to_host().to_dense(),
                               a.to_dense() @ b.to_dense(), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("layout", ["ell", "sell"])
def test_spgemm_rectangular_matches_jax(layout):
    (a, ja), (b, jb) = _sparse(60, 90, 0.1, 11), _sparse(90, 40, 0.1, 12)
    s, js = _scheds(layout, 16)
    C = plan("spgemm", (a, b), schedule=s, device=CPU).execute()
    jC = jplan("spgemm", (ja, jb), schedule=js, backend="jnp").execute()
    _assert_same_structure(C, jC)
    assert C.shape == (60, 40)
    np.testing.assert_allclose(C.to_host().to_dense(), jC.to_dense(),
                               rtol=TOL, atol=TOL)


def test_spgemm_of_a_matrix_with_itself():
    """A @ A blocks its matrix once and still matches the JAX facade."""
    a, ja = _sparse(96, 96, 0.08, 3)
    for layout in ("ell", "sell"):
        s, js = _scheds(layout, 16)
        C = plan("spgemm", (a, a), schedule=s, device=CPU).execute()
        jC = jplan("spgemm", (ja, ja), schedule=js, backend="jnp").execute()
        _assert_same_structure(C, jC)
        np.testing.assert_allclose(C.to_host().blocks,
                                   np.asarray(jC.blocks), rtol=TOL, atol=TOL)


# -------------------------------------------------------------- spadd


@pytest.mark.parametrize("n,bs", [(48, 8), (100, 16), (130, 32)])
@pytest.mark.parametrize("layout", ["ell", "sell"])
def test_spadd_is_bit_identical_to_jax(n, bs, layout):
    (a, ja), (b, jb) = _sparse(n, n, 0.05, n), _sparse(n, n, 0.05, n + 1)
    s, js = _scheds(layout, bs)
    D = plan("spadd", (a, b), schedule=s, device=CPU).execute()
    jD = jplan("spadd", (ja, jb), schedule=js, backend="jnp").execute()
    _assert_same_structure(D, jD)
    np.testing.assert_array_equal(D.to_host().blocks, np.asarray(jD.blocks))
    np.testing.assert_array_equal(D.to_host().to_dense(), jD.to_dense())


def test_spadd_interpret_matches_jax_jnp():
    (a, ja), (b, jb) = _sparse(64, 64, 0.06, 7), _sparse(64, 64, 0.06, 8)
    s, js = _scheds("ell", 16)
    D = plan("spadd", (a, b), schedule=s, device=CPU).execute()
    jD = jplan("spadd", (ja, jb), schedule=js,
               backend="interpret").execute()
    np.testing.assert_array_equal(D.to_host().blocks, np.asarray(jD.blocks))


# ------------------------------------------------- symbolic leaves, bit for bit


def test_symbolic_phases_are_bit_identical():
    (a, ja), (b, jb) = _sparse(90, 70, 0.08, 21), _sparse(70, 80, 0.08, 22)
    ba, bb = BSR.from_csr(a, 16), BSR.from_csr(b, 16)
    jba = jops.BSR.from_csr(ja, 16)
    jbb = jops.BSR.from_csr(jb, 16)
    for mine, ref in ((gops.spgemm_symbolic(ba, bb),
                       jgops.spgemm_symbolic(jba, jbb)),
                      (gops.spgemm_symbolic_cells(ba, bb),
                       jgops.spgemm_symbolic_cells(jba, jbb))):
        for got, want in zip(mine, ref):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    (c, jc) = _sparse(90, 70, 0.08, 23)
    bc, jbc = BSR.from_csr(c, 16), jops.BSR.from_csr(jc, 16)
    for got, want in zip(aops.spadd_symbolic(ba, bc),
                         jaops.spadd_symbolic(jba, jbc)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("layout", ["ell", "sell"])
@pytest.mark.parametrize("shape_bucket", [False, True])
def test_prepared_leaves_equal_jax(layout, shape_bucket):
    """The device leaves a spgemm/spadd plan caches are the JAX package's,
    bucket padding included (plus the port's ``cell_ptr``)."""
    (a, ja), (b, jb) = _sparse(100, 100, 0.07, 31), _sparse(100, 100, 0.07,
                                                           32)
    s, js = _scheds(layout, 16)
    mine = ops_builtin._build_spgemm(a, b, s, shape_bucket,
                                     torch.device(CPU))
    ref = jops._build_spgemm(ja, jb, js, shape_bucket)
    names = (("cell_a", "cell_b", "cell_c", "a_blocks", "b_blocks")
             if layout == "sell" else
             ("pair_a", "pair_b", "a_blocks", "b_blocks"))
    assert mine["mode"] == ref["mode"]
    for name, want in zip(names, ref["dev"]):
        got = mine["dev"][name].numpy()
        assert got.dtype == np.asarray(want).dtype, name
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=name)
    mine = ops_builtin._build_spadd(a, b, s, shape_bucket, torch.device(CPU))
    ref = jops._build_spadd(ja, jb, js, shape_bucket)
    for name, want in zip(("ia", "ib", "a_blocks", "b_blocks"), ref["dev"]):
        np.testing.assert_array_equal(mine["dev"][name].numpy(),
                                      np.asarray(want), err_msg=name)


def _assert_pairs_lead(pa, pb, counts, zero_a, zero_b):
    """Slots ``[:counts[k]]`` of row k are real pairs, the rest the
    (A sentinel, B sentinel) pad."""
    real = np.arange(pa.shape[-1])[None, :] < counts[:, None]
    assert (pa[real] != zero_a).all() and (pb[real] != zero_b).all()
    assert (pa[~real] == zero_a).all() and (pb[~real] == zero_b).all()


@pytest.mark.parametrize("n,bs", [(48, 8), (100, 16), (130, 32)])
@pytest.mark.parametrize("shape_bucket", [False, True])
def test_pair_counts_match_jax_symbolic(n, bs, shape_bucket):
    """The port's pair counts are the non-sentinel pairs per row of JAX's
    ``spgemm_symbolic``, lead each row, and reach the plan's store entry
    (bucket pad blocks own no pair)."""
    (a, ja), (b, jb) = _sparse(n, n, 0.08, n), _sparse(n, n, 0.08, n + 1)
    ba, bb = BSR.from_csr(a, bs), BSR.from_csr(b, bs)
    s, _ = _scheds("ell", bs)
    counts = ops_builtin._spgemm_host_products(a, b, s)["pair_counts"]
    _, _, jpa, jpb = jgops.spgemm_symbolic(jops.BSR.from_csr(ja, bs),
                                           jops.BSR.from_csr(jb, bs))
    assert counts.dtype == np.int32
    np.testing.assert_array_equal(
        counts, (np.asarray(jpa) != ba.n_blocks).sum(axis=1))
    _assert_pairs_lead(np.asarray(jpa), np.asarray(jpb), counts, ba.n_blocks,
                       bb.n_blocks)
    prep = ops_builtin._build_spgemm(a, b, s, shape_bucket,
                                     torch.device(CPU))
    dev = {k: v.numpy() for k, v in prep["dev"].items()}
    got = dev["pair_counts"]
    assert got.shape == dev["pair_a"].shape[:1]
    np.testing.assert_array_equal(got[: counts.size], counts)
    assert not got[counts.size:].any() and prep["n_pairs"] == counts.sum()
    _assert_pairs_lead(dev["pair_a"], dev["pair_b"], got, prep["zero_a"],
                       prep["zero_b"])
    args, kw = ops_builtin.pairop_args(prep["dev"], "pairs", prep["n_c"])
    assert kw["pair_counts"].shape == args[0].shape[:1] == (prep["n_c"],)


def test_bucket_pair_counts_are_per_member():
    """In a stacked bucket each member's counts are its own (against its
    own sentinels), its pad blocks own no pair, and so do the padded zero
    members."""
    pairs = _pairs3("gemm")
    s, _ = _scheds("ell", 16)
    store = PreparedStore()
    plan_bucket("spgemm", [(a, b) for (a, _), (b, _) in pairs], s,
                device=CPU, store=store)
    (entry, _), = store._entries.values()
    st = {k: v.numpy() for k, v in entry["stacked"].items()}
    assert st["pair_counts"].shape == st["pair_a"].shape[:2]
    for m, ((a, _), (b, _)) in enumerate(pairs):
        ba, bb = BSR.from_csr(a, 16), BSR.from_csr(b, 16)
        _, _, pa, _ = gops.spgemm_symbolic(ba, bb)
        counts = (pa != ba.n_blocks).sum(1)
        np.testing.assert_array_equal(st["pair_counts"][m, : counts.size],
                                      counts)
        assert not st["pair_counts"][m, counts.size:].any()
        _assert_pairs_lead(st["pair_a"][m], st["pair_b"][m],
                           st["pair_counts"][m], ba.n_blocks, bb.n_blocks)
    assert not st["pair_counts"][len(pairs):].any()


def test_pairs_wrapper_needs_its_counts():
    """The count is required, on CPU tensors as on the card, and must have
    the pair rows' shape and int32."""
    (a, _), (b, _) = _sparse(64, 64, 0.1, 3), _sparse(64, 64, 0.1, 4)
    prep = ops_builtin._build_spgemm(a, b, _scheds("ell", 16)[0], False,
                                     torch.device(CPU))
    (pa, pb, ab, bb), kw = ops_builtin.pairop_args(prep["dev"], "pairs")
    with pytest.raises(TypeError, match="pair_counts"):
        GK.bsr_spgemm_pairs_cuda(pa, pb, ab, bb)
    for bad in (kw["pair_counts"].long(), kw["pair_counts"][:1]):
        with pytest.raises(ValueError, match="pair_counts"):
            GK.bsr_spgemm_pairs_cuda(pa, pb, ab, bb, pair_counts=bad)
    c = GK.bsr_spgemm_pairs_cuda(pa, pb, ab, bb, **kw)   # CPU: plain
    torch.testing.assert_close(c, gref.ref_pair_gemm(pa, pb, ab, bb))


def test_spadd_wrapper_needs_its_sentinels():
    """The sentinels are required, on CPU tensors as on the card, and must
    be int32 of shape (2,), or (B, 2) for a stacked bucket."""
    (a, _), (b, _) = _sparse(64, 64, 0.1, 3), _sparse(64, 64, 0.1, 4)
    prep = ops_builtin._build_spadd(a, b, _scheds("ell", 16)[0], False,
                                    torch.device(CPU))
    (ia, ib, ab, bb), kw = ops_builtin.pairop_args(prep["dev"], "spadd")
    assert list(kw) == ["sentinels"]
    with pytest.raises(TypeError, match="sentinels"):
        AK.bsr_spadd_cuda(ia, ib, ab, bb)
    sent = kw["sentinels"]
    for bad in (sent.long(), sent[:1], sent[None], sent.float()):
        with pytest.raises(ValueError, match="sentinels"):
            AK.bsr_spadd_cuda(ia, ib, ab, bb, sentinels=bad)
    with pytest.raises(ValueError, match="sentinels"):   # stacked: (B, 2)
        AK.bsr_spadd_cuda(ia[None], ib[None], ab[None], bb[None],
                          sentinels=sent)
    c = AK.bsr_spadd_cuda(ia, ib, ab, bb, **kw)   # CPU: plain
    assert torch.equal(c, ab[ia.long()] + bb[ib.long()])
    c = AK.bsr_spadd_cuda(ia[None], ib[None], ab[None], bb[None],
                          sentinels=sent[None])
    assert torch.equal(c[0], ab[ia.long()] + bb[ib.long()])


def _assert_sentinel_tiles_zero(ia, ib, a_blocks, b_blocks, sentinels):
    """Every index at or past a member's sentinel points at an all-+0.0
    tile (no -0.0), and so does every tile from the sentinel on; returns
    how many indices point there."""
    za, zb = (int(z) for z in sentinels)
    n_past = 0
    for idx, blocks, z in ((ia, a_blocks, za), (ib, b_blocks, zb)):
        past = idx[idx >= z]
        assert (past < blocks.shape[0]).all()
        tail = blocks[z:]
        assert tail.shape[0] >= 1
        assert (tail == 0).all() and not np.signbit(tail).any()
        n_past += past.size
    return n_past


@pytest.mark.parametrize("shape_bucket", [False, True])
def test_spadd_sentinel_leaves_match_symbolic(shape_bucket):
    """Single-plan and bucket entries carry each member's ``(zero_a,
    zero_b)`` (the real block counts of A and B, the symbolic phase's
    sentinels), on the host build and on the store's cached build."""
    pairs = _pairs3("add")
    s, _ = _scheds("ell", 16)
    dev = torch.device(CPU)
    n_past = 0
    for (a, _), (b, _) in pairs:
        ba, bb = BSR.from_csr(a, 16), BSR.from_csr(b, 16)
        built = ops_builtin._build_spadd(a, b, s, shape_bucket, dev)
        store = PreparedStore()
        plan("spadd", (a, b), schedule=s, device=CPU, store=store,
             shape_bucket=shape_bucket)
        (cached, _), = store._entries.values()
        for entry in (built, cached):
            d = {k: t.numpy() for k, t in entry["dev"].items()}
            assert d["sentinels"].dtype == np.int32
            np.testing.assert_array_equal(d["sentinels"],
                                          [ba.n_blocks, bb.n_blocks])
            assert (entry["zero_a"], entry["zero_b"]) == (ba.n_blocks,
                                                          bb.n_blocks)
            n_past += _assert_sentinel_tiles_zero(
                d["ia"], d["ib"], d["a_blocks"], d["b_blocks"],
                d["sentinels"])
    mats = [(a, b) for (a, _), (b, _) in pairs]
    store = PreparedStore()
    bucket = plan_bucket("spadd", mats, s, device=CPU, store=store,
                         shape_bucket=shape_bucket,
                         member_keys=[content_key(m) for p in mats
                                      for m in p])
    (cached, _), = store._entries.values()
    st = {k: t.numpy() for k, t in cached["stacked"].items()}
    assert bucket.operands[0] is cached
    assert st["sentinels"].shape == (3, 2)
    for m, (a, b) in enumerate(mats):
        want = [BSR.from_csr(a, 16).n_blocks, BSR.from_csr(b, 16).n_blocks]
        np.testing.assert_array_equal(st["sentinels"][m], want)
        n_past += _assert_sentinel_tiles_zero(
            st["ia"][m], st["ib"][m], st["a_blocks"][m], st["b_blocks"][m],
            st["sentinels"][m])
    assert n_past > 0


# The bucket tests below execute JAX buckets at bs=32: the JAX package's own
# bucket tests (bs=16, same shapes) assert that their stacked program is
# traced exactly once, which a same-shape compile earlier in the process
# would break.
BUCKET_BS = 32


def _pairs3(kind):
    """The member shapes of the JAX bucket tests (test_serving_path)."""
    if kind == "gemm":
        return [(_sparse(96 + 16 * i, 80, 0.08, 30 + i),
                 _sparse(80, 64 + 16 * i, 0.08, 40 + i)) for i in range(3)]
    return [(_sparse(96 + 16 * i, 96 + 16 * i, 0.06, 50 + i),
             _sparse(96 + 16 * i, 96 + 16 * i, 0.06, 60 + i))
            for i in range(3)]


@pytest.mark.parametrize("layout", ["ell", "sell"])
def test_stacked_bucket_leaves_equal_jax(layout):
    pairs = _pairs3("gemm")
    s, js = _scheds(layout, 16)
    store, jstore = PreparedStore(), JPreparedStore()
    plan_bucket("spgemm", [(a, b) for (a, _), (b, _) in pairs], s,
                device=CPU, store=store)
    jplan_bucket("spgemm", [(ja, jb) for (_, ja), (_, jb) in pairs], js,
                 backend="jnp", store=jstore)
    (mine, _), = store._entries.values()
    (ref, _), = jstore._entries.values()
    for name, want in ref["stacked"].items():
        np.testing.assert_array_equal(mine["stacked"][name].numpy(),
                                      np.asarray(want), err_msg=name)


# ------------------------------------------------------------- buckets


@pytest.mark.parametrize("layout", ["ell", "sell"])
def test_spgemm_bucket_of_3_is_one_launch(layout):
    pairs = _pairs3("gemm")
    s, js = _scheds(layout, BUCKET_BS)
    mats = [(a, b) for (a, _), (b, _) in pairs]
    singles = [plan("spgemm", m, schedule=s, device=CPU).execute()
               for m in mats]
    reset_counters()
    bucket = plan_bucket("spgemm", mats, s, device=CPU)
    assert bucket.n_members == 3
    Cs = bucket.execute()
    assert launch_count("spgemm") == 1
    jCs = jplan_bucket("spgemm", [(ja, jb) for (_, ja), (_, jb) in pairs],
                       js, backend="jnp").execute()
    for C, C1, jC in zip(Cs, singles, jCs):
        _assert_same_structure(C, jC)
        np.testing.assert_allclose(C.to_host().blocks, C1.to_host().blocks,
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(C.to_host().blocks, np.asarray(jC.blocks),
                                   rtol=TOL, atol=TOL)
    bucket.execute()
    assert launch_count("spgemm") == 2


def test_spadd_bucket_of_3_is_one_launch():
    pairs = _pairs3("add")
    s, js = _scheds("ell", BUCKET_BS)
    mats = [(a, b) for (a, _), (b, _) in pairs]
    singles = [plan("spadd", m, schedule=s, device=CPU).execute()
               for m in mats]
    reset_counters()
    Ds = plan_bucket("spadd", mats, s, device=CPU).execute()
    assert launch_count("spadd") == 1
    jDs = jplan_bucket("spadd", [(ja, jb) for (_, ja), (_, jb) in pairs],
                       js, backend="jnp").execute()
    for D, D1, jD in zip(Ds, singles, jDs):
        _assert_same_structure(D, jD)
        np.testing.assert_array_equal(D.to_host().blocks,
                                      D1.to_host().blocks)
        np.testing.assert_array_equal(D.to_host().blocks,
                                      np.asarray(jD.blocks))


def test_bucket_store_hits_and_member_validation():
    pairs = [[a, b] for (a, _), (b, _) in _pairs3("gemm")]
    s, _ = _scheds("ell", 16)
    store = PreparedStore()
    C1 = plan_bucket("spgemm", pairs, s, device=CPU, store=store).execute()
    C2 = plan_bucket("spgemm", pairs, s, device=CPU, store=store).execute()
    assert store.hits == 1 and len(store) == 1
    for c1, c2 in zip(C1, C2):
        torch.testing.assert_close(c1.arrays["blocks"], c2.arrays["blocks"])
    keys = [content_key(m) for p in pairs for m in p]
    plan_bucket("spgemm", pairs, s, device=CPU, store=store,
                member_keys=keys)
    # caller-hashed keys, one per operand, name the same entry
    assert store.hits == 2 and len(store) == 1
    sell = SparseTensor.from_csr(pairs[0][0], layout="sell", block_size=16,
                                 device=CPU)
    with pytest.raises(ValueError, match="incompatible"):
        plan_bucket("spgemm", [[sell, pairs[0][1]]], s, device=CPU)
    with pytest.raises(ValueError, match="operand pairs"):
        plan_bucket("spadd", [pairs[0][0]], s, device=CPU)


def test_bucket_accepts_prepared_bsr_members():
    pairs = _pairs3("add")
    s, _ = _scheds("ell", 16)
    prepped = [(SparseTensor.from_csr(a, layout="bsr", block_size=16,
                                      device=CPU), BSR.from_csr(b, 16))
               for (a, _), (b, _) in pairs]
    for D, ((a, _), (b, _)) in zip(plan_bucket("spadd", prepped, s,
                                               device=CPU).execute(), pairs):
        np.testing.assert_array_equal(D.to_host().to_dense(),
                                      a.to_dense() + b.to_dense())
    with pytest.raises(ValueError, match="block_size"):
        plan_bucket("spadd", prepped, Schedule("bsr", 32, 1.0), device=CPU)


# ------------------------------------------------------ warm store path


def test_warm_store_hit_skips_symbolic_phase(monkeypatch):
    (a, _), (b, _) = _sparse(96, 96, 0.08, 1), _sparse(96, 96, 0.08, 2)
    store = PreparedStore()
    C1 = plan("spgemm", (a, b), block_size=16, store=store,
              device=CPU).execute()
    D1 = plan("spadd", (a, b), block_size=16, store=store,
              device=CPU).execute()

    def boom(*args, **kw):
        raise AssertionError("symbolic phase ran on a warm plan")

    monkeypatch.setattr(ops_builtin, "spgemm_symbolic", boom)
    monkeypatch.setattr(ops_builtin, "spgemm_symbolic_cells", boom)
    monkeypatch.setattr(ops_builtin, "spadd_symbolic", boom)
    monkeypatch.setattr(ops_builtin.BSR, "from_csr", boom)
    C2 = plan("spgemm", (a, b), block_size=16, store=store,
              device=CPU).execute()
    D2 = plan("spadd", (a, b), block_size=16, store=store,
              device=CPU).execute()
    assert store.hits == 2
    torch.testing.assert_close(C2.arrays["blocks"], C1.arrays["blocks"])
    torch.testing.assert_close(D2.arrays["blocks"], D1.arrays["blocks"])
    # the layout axis matters to spgemm's prep, not to spadd's
    sell = Schedule("bsr", 16, 1.0, layout="sell")
    plan("spadd", (a, b), schedule=sell, store=store, device=CPU)
    assert store.hits == 3
    with pytest.raises(AssertionError, match="symbolic phase"):
        plan("spgemm", (a, b), schedule=sell, store=store, device=CPU)


# ------------------------------------------------- pad cells own no block


def test_cell_pointer_gives_pad_cells_to_no_block():
    """Bucket padding appends zero-product cells with cell_c = n_c - 1.
    The pointer covers the live cells only: the last block owns just its
    real cells, and padded blocks own none."""
    (a, _), (b, _) = _sparse(150, 150, 0.08, 41), _sparse(150, 150, 0.08,
                                                          42)
    s, _ = _scheds("sell", 16)
    prep = ops_builtin._build_spgemm(a, b, s, True, torch.device(CPU))
    dev = prep["dev"]
    cc, ptr = dev["cell_c"].numpy(), dev["cell_ptr"].numpy()
    n_c = prep["n_c"]
    live_c = gops.spgemm_symbolic_cells(BSR.from_csr(a, 16),
                                        BSR.from_csr(b, 16))[4]
    n_live = live_c.size
    assert cc.size > n_live                     # the bucket padded cells
    assert (cc[n_live:] == n_c - 1).all()
    assert ptr.size == ops_builtin.bucket_edge(n_c) + 1
    assert ptr[0] == 0 and ptr[-1] == n_live
    assert (np.diff(ptr) >= 0).all()
    assert ptr[n_c] - ptr[n_c - 1] == int((live_c == n_c - 1).sum())
    assert (ptr[n_c:] == n_live).all()          # pad blocks own no cells
    for c in range(n_c):
        assert (cc[ptr[c]:ptr[c + 1]] == c).all()
    # the kernel's function over this pointer is the JAX reference's
    args = (dev["cell_a"], dev["cell_b"])
    blocks = (dev["a_blocks"], dev["b_blocks"])
    got = gref.ref_cell_gemm_ptr(*args, dev["cell_ptr"], *blocks)
    want = gref.ref_cell_gemm(*args, dev["cell_c"], *blocks,
                              ops_builtin.bucket_edge(n_c))
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_plain_versions_chunk_without_changing_the_function(monkeypatch):
    (a, _), (b, _) = _sparse(120, 120, 0.1, 51), _sparse(120, 120, 0.1, 52)
    outs = {}
    for chunk in (gref.CHUNK_BYTES, 3 * 16 * 16 * 4):   # one chunk vs many
        monkeypatch.setattr(gref, "CHUNK_BYTES", chunk)
        outs[chunk] = [plan("spgemm", (a, b), schedule=_scheds(lay, 16)[0],
                            device=CPU).execute().arrays["blocks"]
                       for lay in ("ell", "sell")]
    for x, y in zip(*outs.values()):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------- converter


def test_convert_bsr_leaves_from_jax():
    a, ja = _sparse(100, 100, 0.08, 61)
    jst = JSparseTensor.from_csr(ja, layout="bsr", block_size=16)
    meta = dataclasses.asdict(jst.meta)
    arrays = {k: np.asarray(v) for k, v in jst.arrays.items()}
    st = convert.sparse_tensor_from_arrays("bsr", meta, arrays, device=CPU)
    mine, ref = st.to_host(), jst.to_host()
    for f in ("block_ptrs", "block_cols", "blocks"):
        got, want = getattr(mine, f), np.asarray(getattr(ref, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert mine.shape == ref.shape and mine.block_size == 16
    own = SparseTensor.from_csr(a, layout="bsr", block_size=16,
                                shape_bucket=True, device=CPU)
    for f in ("block_ptrs", "block_cols", "blocks"):
        np.testing.assert_array_equal(own.arrays[f].numpy(), arrays[f])
    C = plan("spgemm", (st, st), block_size=16, device=CPU).execute()
    jC = jplan("spgemm", (jst, jst), block_size=16, backend="jnp").execute()
    np.testing.assert_allclose(C.to_host().to_dense(), jC.to_dense(),
                               rtol=TOL, atol=TOL)


# ------------------------------------------ the wrappers' CUDA branch


def _meta(shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device="meta")


def _meta_args(name):
    """Arguments on the meta device: no data, but the wrappers take their
    non-CPU branch — the one CUDA tensors take."""
    i32 = torch.int32
    blocks = (_meta((5, 8, 8)), _meta((4, 8, 8)))
    if name == "bsr_spgemm_pairs":
        def pairs(pa, pb, a, b):   # the counts follow pair_a's leading axes
            return GK.bsr_spgemm_pairs_cuda(
                pa, pb, a, b, pair_counts=_meta(pa.shape[:-1], i32))
        return (pairs, GK,
                (_meta((6, 3), i32), _meta((6, 3), i32)) + blocks)
    if name == "bsr_spgemm_cells":
        return (GK.bsr_spgemm_cells_cuda, GK,
                (_meta((9,), i32), _meta((9,), i32), _meta((7,), i32))
                + blocks)
    def spadd(ia, ib, a, b):   # the sentinels follow ia's leading axes
        return AK.bsr_spadd_cuda(
            ia, ib, a, b,
            sentinels=_meta(tuple(ia.shape[:-1]) + (2,), i32))
    return (spadd, AK, (_meta((6,), i32), _meta((6,), i32)) + blocks)


@pytest.mark.parametrize("name", ["bsr_spgemm_pairs", "bsr_spgemm_cells",
                                  "bsr_spadd"])
def test_wrappers_raise_on_failed_launch_without_fallback(name, monkeypatch):
    fn, mod, args = _meta_args(name)
    monkeypatch.setattr(mod, "_fn", lambda *n: (lambda *a: 700))
    monkeypatch.setattr(mod, "launch_stream", lambda dev: None)
    for plain in ("ref_pair_gemm", "ref_cell_gemm_ptr", "ref_cell_gemm"):
        monkeypatch.setattr(gref, plain, lambda *a: pytest.fail("fell back"))
    monkeypatch.setattr(AK.ref, "ref_block_union_add",
                        lambda *a: pytest.fail("fell back"))
    before = mod.LAUNCHES[name]
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        fn(*args)
    assert mod.LAUNCHES[name] == before + 1


@pytest.mark.parametrize("name", ["bsr_spgemm_pairs", "bsr_spgemm_cells",
                                  "bsr_spadd"])
def test_wrappers_reject_what_the_kernel_does_not_take(name):
    fn, _, args = _meta_args(name)
    with pytest.raises(TypeError):
        fn(args[0].long(), *args[1:])
    with pytest.raises(ValueError, match="block size"):
        fn(*args[:-2], _meta((5, 6, 6)), _meta((4, 6, 6)))
    with pytest.raises(ValueError, match="with one bs"):
        fn(*args[:-2], _meta((5, 8, 8)), _meta((4, 16, 16)))
    with pytest.raises(ValueError, match="contiguous"):
        fn(*args[:-2], _meta((5, 8, 8)).transpose(1, 2), args[-1])
    stacked = tuple(t.unsqueeze(0).expand(2, *t.shape).contiguous()
                    for t in args)
    with pytest.raises(ValueError, match="member axes disagree"):
        fn(*stacked[:-1], stacked[-1][:1])


# ------------------------------------------------------------- guards


def test_card_is_the_default_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    (a, _), (b, _) = _sparse(32, 32, 0.1, 0), _sparse(32, 32, 0.1, 1)
    s, _ = _scheds("ell", 16)
    for op in ("spgemm", "spadd"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            plan(op, (a, b), schedule=s)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            plan_bucket(op, [(a, b)], s)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        plan("spgemm", (a, b), schedule=s, backend="cuda", device=CPU)


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_and_chip_smoke_never_import_jax_or_repro():
    """Every import statement — module level or inside a function — of the
    port's package and of chip_smoke.py."""
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    bad = {str(f.relative_to(ROOT)): r for f in files
           for r in _imported_roots(f) if r in ("jax", "jaxlib", "repro")}
    assert not bad, bad
