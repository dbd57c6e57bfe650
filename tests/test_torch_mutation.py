"""The port's mutation path (``repro_torch.sparse.mutate``,
``repro_torch.selector.drift``) held against the JAX package's.

First the twins of ``tests/test_mutation.py`` on the port (``device="cpu"``,
the kernels' plain versions): versioned content keys; a value delta keeps
a warm plan with no host prep; inserts within slack stay warm; used-up
slack swaps the epoch; a mutable container keeps a q < 1 schedule's tail
blocks; a BSR tensor refuses an insert; a mutation drops derived products
and leaves siblings resident; the property that a delta equals a rebuild
(hypothesis); ``fired == recovered`` at the ``delta-apply`` and
``slack-overflow`` sites; the drift watchdog quarantines and refits; the v3
store index drops stale generations; an engine mutated mid-replay serves no
stale result.

Then parity, on one CSR and one ``Delta`` through both packages (the JAX
facade's ``jnp`` backend): equal host and device leaves, generations,
version keys, SpMV within 2e-5; the count arrays the CUDA kernels stop at
(``valid_counts``, the port's own ``cell_valid``) equal the true count of
real slots and cells after two inserts into one row, and a counted sum
that stops there (as the kernels do) matches the oracle; a v3 store index
written by either package loads in the other with the same
``stale_drops``; a JAX slack container carried across through
``convert`` equals the port's and takes the next delta the same way.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import repro.core as J
from repro.sparse import Delta as JDelta
from repro.sparse import MutableMatrix as JMutableMatrix
from repro.sparse import PreparedStore as JPreparedStore
from repro.sparse import SparseTensor as JSparseTensor
from repro.sparse import plan as jplan
from repro.sparse import resilience as jres
from repro_torch import convert
from repro_torch import core as T
from repro_torch.core import CSR, ScheduleTuner, corpus
from repro_torch.core.autotune import Schedule, _modeled_time
from repro_torch.kernels.bsr_spmv.ops import sell_cell_valid, sell_row_ptr
from repro_torch.selector import (DriftMonitor, ScheduleCache,
                                  SelectorService, fingerprint)
from repro_torch.sparse import (Delta, FaultInjector, MutableMatrix,
                                PreparedStore, SlackOverflow, SparseTensor,
                                content_key, install_injector, plan,
                                raw_content_key, reset_counters,
                                reset_resilience, split_version_key)
from repro_torch.sparse.prepared import STORE_INDEX_VERSION
from repro_torch.sparse.resilience import (atomic_write_json,
                                           checksum_entries)

CPU = "cpu"
TOL = dict(rtol=2e-5, atol=2e-5)
# the JAX package's TPU v5e figures, carried across as data
V5E = T.Platform(**dataclasses.asdict(J.TPU_V5E))


@pytest.fixture(autouse=True)
def _clean_resilience():
    reset_resilience()
    jres.reset_resilience()
    yield
    reset_resilience()
    jres.reset_resilience()


def _dense(rng, n=96, density=0.06):
    d = (rng.random((n, n)) < density) * rng.standard_normal((n, n))
    return d.astype(np.float32)


def _random_csr(rng, n=96, density=0.06):
    return CSR.from_dense(_dense(rng, n, density))


def _existing_positions(A, rng, k):
    lens = np.diff(A.row_ptrs)
    rows = np.repeat(np.arange(A.shape[0]), lens)
    pick = rng.choice(rows.size, size=min(k, rows.size), replace=False)
    return rows[pick], A.col_idxs[pick].astype(np.int64)


def _empty_block_positions(A, bs, k):
    """One position in each of up to ``k`` fully empty blocks."""
    d = np.asarray(A.to_dense())
    n = d.shape[0]
    out = []
    for r in range(0, n, bs):
        for c in range(0, n, bs):
            if not d[r:r + bs, c:c + bs].any():
                out.append((r, c))
            if len(out) == k:
                return np.array(out)
    return np.array(out) if out else np.empty((0, 2), np.int64)


def _row_of_empty_blocks(A, bs, k):
    """(block-row, k block-cols) of the first block-row with at least
    ``k`` fully empty blocks."""
    d = np.asarray(A.to_dense())
    n_b = -(-d.shape[0] // bs)
    for br in range(n_b):
        empty = [bc for bc in range(n_b)
                 if not d[br * bs:(br + 1) * bs, bc * bs:(bc + 1) * bs].any()]
        if len(empty) >= k:
            return br, empty[:k]
    raise AssertionError(f"no block-row with {k} empty blocks")


def _y(p, x):
    return p.execute(x).cpu().numpy()


def _dense_after(d, r, c, v, mode):
    """float64 ``d`` with the delta applied."""
    out = d.astype(np.float64).copy()
    if mode == "add":
        np.add.at(out, (r, c), v)
    else:
        out[r, c] = v
    return out


# ------------------------------------------------------ versioned content keys

def test_version_key_rides_on_content_key():
    rng = np.random.default_rng(0)
    A = _random_csr(rng)
    base = content_key(A)
    mm = MutableMatrix(A, slack=2)
    assert content_key(A) == f"{base}@g0"
    assert raw_content_key(A) == base
    mm.set_values(*_existing_positions(A, rng, 2),
                  np.ones(2, np.float32))
    assert content_key(A) == f"{base}@g1"
    assert split_version_key(content_key(A)) == (base, 1)
    assert split_version_key(base) == (base, 0)


# ------------------------------------------- warm-plan fast path (machine check)

@pytest.mark.parametrize("layout", ["ell", "sell"])
def test_value_delta_skips_host_prep(layout):
    rng = np.random.default_rng(1)
    A = _random_csr(rng)
    x = rng.standard_normal(A.shape[1]).astype(np.float32)
    store = PreparedStore()
    mm = MutableMatrix(A, store=store, slack=4)
    reset_counters()
    p = plan("spmv", (A,), layout=layout, store=store, block_size=16,
             device=CPU)
    y0 = _y(p, x)
    np.testing.assert_allclose(y0, A.to_dense() @ x, **TOL)
    misses0 = store.misses
    st0 = p.operands[0]

    r, c = _existing_positions(A, rng, 8)
    mm.apply_delta(Delta(r, c, rng.standard_normal(8).astype(np.float32)))

    p2 = plan("spmv", (A,), layout=layout, store=store, block_size=16,
              device=CPU)
    y1 = _y(p2, x)
    np.testing.assert_allclose(y1, A.to_dense() @ x, **TOL)
    assert not np.allclose(y1, y0), "delta must change the result"
    # no host prep after a value delta: the same tensor, written in place
    assert store.misses == misses0
    assert p2.operands[0] is st0 and st0.generation == 1
    assert store.mutation_rekeys >= 1
    # a plan built before the delta serves the new values too
    np.testing.assert_allclose(_y(p, x), y1, rtol=0, atol=0)


@pytest.mark.parametrize("layout", ["ell", "sell"])
def test_structural_insert_within_slack_stays_warm(layout):
    rng = np.random.default_rng(2)
    A = _random_csr(rng, density=0.03)
    x = rng.standard_normal(A.shape[1]).astype(np.float32)
    store = PreparedStore()
    mm = MutableMatrix(A, store=store, slack=4)
    plan("spmv", (A,), layout=layout, store=store, block_size=8,
         device=CPU).execute(x)
    misses0 = store.misses

    pos = _empty_block_positions(A, 8, 2)
    assert len(pos), "need empty blocks for a structural insert"
    mm.apply_delta(Delta(pos[:, 0], pos[:, 1],
                         np.full(len(pos), 3.0, np.float32)))

    y = _y(plan("spmv", (A,), layout=layout, store=store, block_size=8,
                device=CPU), x)
    np.testing.assert_allclose(y, A.to_dense() @ x, **TOL)
    assert store.misses == misses0
    assert dict(mm.telemetry())["structural_inserts"] >= 1
    assert dict(mm.telemetry())["epoch_swaps"] == 0


# ---------------------------------------------------------------- epoch swap

def test_slack_exhaustion_epoch_swaps_never_fails():
    rng = np.random.default_rng(3)
    A = _random_csr(rng, n=64, density=0.03)
    x = rng.standard_normal(64).astype(np.float32)
    store = PreparedStore()
    mm = MutableMatrix(A, store=store, slack=1)    # pool of 4 spare blocks
    p_old = plan("spmv", (A,), store=store, block_size=8, device=CPU)
    y_old = _y(p_old, x)
    pos = _empty_block_positions(A, 8, 10)         # 10 new blocks >> slack
    mm.apply_delta(Delta(pos[:, 0], pos[:, 1],
                         np.ones(len(pos), np.float32)))
    y = _y(plan("spmv", (A,), store=store, block_size=8, device=CPU), x)
    np.testing.assert_allclose(y, A.to_dense() @ x, **TOL)
    tel = dict(mm.telemetry())
    assert tel["epoch_swaps"] >= 1 and tel["rebuilds"] >= 1
    # the overflowing delta left the old tensor untouched for its plan
    np.testing.assert_allclose(_y(p_old, x), y_old, rtol=0, atol=0)


def test_quantile_schedule_mutable_prep_keeps_truncated_positions():
    """A q<1 ELL schedule must not truncate a mutable container's tail
    blocks: ``from_csr(slack>0)`` forces full-quantile prep, so an "add"
    on a would-be-truncated position accumulates onto the base value."""
    rng = np.random.default_rng(6)
    n, bs = 64, 8
    d = (rng.random((n, n)) < 0.04) * rng.standard_normal((n, n))
    d[0, :] = rng.standard_normal(n)     # one long row the cap would cut
    A = CSR.from_dense(d.astype(np.float32))
    sched = Schedule("jax", bs, 0.5)
    x = rng.standard_normal(n).astype(np.float32)

    full_slots = SparseTensor.from_csr(
        A, schedule=Schedule("jax", bs, 1.0),
        device=CPU).to_host().block_cols.shape[1]
    trunc = SparseTensor.from_csr(A, schedule=sched, device=CPU)
    mutable = SparseTensor.from_csr(A, schedule=sched, slack=2, device=CPU)
    assert trunc.to_host().block_cols.shape[1] < full_slots
    assert mutable.to_host().block_cols.shape[1] == full_slots + 2

    store = PreparedStore()
    mm = MutableMatrix(A, store=store, slack=2)
    p = plan("spmv", (A,), schedule=sched, store=store, device=CPU)
    np.testing.assert_allclose(_y(p, x), A.to_dense() @ x, **TOL)
    col = int(A.col_idxs[A.row_ptrs[0]:A.row_ptrs[1]][-1])   # row 0 tail
    mm.add_values([0], [col], np.asarray([2.5], np.float32))
    y = _y(plan("spmv", (A,), schedule=sched, store=store, device=CPU), x)
    np.testing.assert_allclose(y, A.to_dense() @ x, **TOL)


def test_bsr_tensor_rejects_structural_insert():
    rng = np.random.default_rng(4)
    A = _random_csr(rng, n=32, density=0.05)
    st = SparseTensor.from_csr(A, layout="bsr", block_size=8, device=CPU)
    pos = _empty_block_positions(A, 8, 1)
    with pytest.raises(SlackOverflow):
        st.apply_delta(Delta(pos[:, 0], pos[:, 1],
                             np.ones(len(pos), np.float32)))


def test_delta_rejects_repeated_and_outside_positions():
    rng = np.random.default_rng(4)
    A = _random_csr(rng, n=32, density=0.2)
    st = SparseTensor.from_csr(A, block_size=8, slack=2, device=CPU)
    r, c = _existing_positions(A, rng, 2)
    for mode in ("set", "add"):
        with pytest.raises(ValueError, match="repeats a position"):
            st.apply_delta(Delta(np.r_[r, r[:1]], np.r_[c, c[:1]],
                                 np.ones(3, np.float32), mode))
    with pytest.raises(ValueError, match="outside"):
        st.apply_delta(Delta(np.array([32]), np.array([0]),
                             np.ones(1, np.float32)))
    with pytest.raises(ValueError, match="mode"):
        Delta(r, c, np.ones(2, np.float32), "mul")
    assert st.generation == 0


# --------------------------------------------- sub-matrix store invalidation

def test_mutation_invalidates_products_leaves_siblings_resident():
    rng = np.random.default_rng(5)
    A = _random_csr(rng, n=64, density=0.05)
    B = _random_csr(rng, n=64, density=0.05)
    C = _random_csr(rng, n=64, density=0.05)      # the sibling
    x = rng.standard_normal(64).astype(np.float32)
    store = PreparedStore()
    mm = MutableMatrix(A, store=store, slack=2)
    plan("spgemm", (A, B), store=store, block_size=8, device=CPU).execute()
    plan("spmv", (C,), store=store, block_size=8, device=CPU).execute(x)
    ck_c = content_key(C)
    n_entries = len(store)
    assert store.resident(content_key(A))
    assert store.resident(ck_c)

    r, c = _existing_positions(A, rng, 2)
    mm.apply_delta(Delta(r, c, np.ones(2, np.float32)))

    old_ck = f"{mm.base_key}@g0"
    assert not any(PreparedStore.rewrite_key(k, old_ck, "X") != k
                   for k in store._entries), "no old-generation keys remain"
    assert store.mutation_invalidated >= 1
    assert store.resident(ck_c)
    assert len(store) < n_entries
    got = plan("spgemm", (A, B), store=store, block_size=8,
               device=CPU).execute()
    want = A.to_dense() @ B.to_dense()
    host = got.to_host()
    dense = np.zeros(host.shape, np.float32)
    bs = host.block_size
    for br in range(host.n_block_rows):
        for j in range(int(host.block_ptrs[br]), int(host.block_ptrs[br + 1])):
            cb = int(host.block_cols[j])
            dense[br * bs:(br + 1) * bs, cb * bs:(cb + 1) * bs] = \
                host.blocks[j]
    np.testing.assert_allclose(dense[:64, :64], want, rtol=2e-4, atol=2e-4)


def test_mutation_drops_stacked_bucket_keeps_member_tensor():
    """A stacked bucket copies its members' blocks: a delta drops it (it
    would serve the old values) and rekeys the member's own tensor."""
    rng = np.random.default_rng(9)
    A, B = _random_csr(rng), _random_csr(rng)
    xs = [rng.standard_normal(96).astype(np.float32) for _ in range(2)]
    store = PreparedStore()
    mm = MutableMatrix(A, store=store, slack=2)
    sched = SparseTensor.default_schedule(16)
    from repro_torch.sparse import plan_bucket

    def run():
        return [y.cpu().numpy() for y in plan_bucket(
            "spmv", [A, B], sched, store=store, device=CPU,
            member_keys=[content_key(A), content_key(B)]).execute(xs)]

    run()
    r, c = _existing_positions(A, rng, 4)
    mm.apply_delta(Delta(r, c, np.full(4, 5.0, np.float32)))
    assert dict(mm.telemetry())["dropped_entries"] >= 1
    assert dict(mm.telemetry())["rekeyed_entries"] >= 1
    ys = run()
    np.testing.assert_allclose(ys[0], A.to_dense() @ xs[0], **TOL)
    np.testing.assert_allclose(ys[1], B.to_dense() @ xs[1], **TOL)


# --------------------------------------------------------- hypothesis property

try:
    from hypothesis import given, settings, strategies as st_
    HAVE_HYPOTHESIS = True
except ImportError:       # deterministic fallback below still runs the property
    HAVE_HYPOTHESIS = False


def _tensor_dense(st, n):
    """Densify a prepared container through its host form. Iterates every
    slot/cell: padding and unused slack reference all-zero blocks, so they
    contribute nothing; the generous allocation absorbs bucket padding."""
    host = st.to_host()
    if isinstance(host, np.ndarray):
        return np.asarray(host)[:n, :n]
    bs = st.meta.block_size
    if st.layout == "ell":
        bi, bc, blocks = (host.block_indices, host.block_cols, host.blocks)
        nr, nc = bi.shape[0] * bs, (int(bc.max(initial=0)) + 1) * bs
        out = np.zeros((max(nr, n), max(nc, n)), np.float32)
        for br in range(bi.shape[0]):
            for s in range(bi.shape[1]):
                c = int(bc[br, s])
                out[br * bs:(br + 1) * bs, c * bs:(c + 1) * bs] \
                    += blocks[int(bi[br, s])]
    elif st.layout == "sell":
        n_br = host.n_block_rows
        nr = n_br * bs
        nc = (int(host.cell_col.max(initial=0)) + 1) * bs
        out = np.zeros((max(nr, n), max(nc, n)), np.float32)
        for t in range(host.cell_block.shape[0]):
            p = int(host.cell_row[t])
            if p >= n_br:
                continue
            br = int(host.row_perm[p])
            c = int(host.cell_col[t])
            out[br * bs:(br + 1) * bs, c * bs:(c + 1) * bs] \
                += host.blocks[int(host.cell_block[t])]
    else:   # bsr
        nr = host.n_block_rows * bs
        nc = (int(host.block_cols.max(initial=0)) + 1) * bs
        out = np.zeros((max(nr, n), max(nc, n)), np.float32)
        for br in range(host.n_block_rows):
            for j in range(int(host.block_ptrs[br]),
                           int(host.block_ptrs[br + 1])):
                c = int(host.block_cols[j])
                out[br * bs:(br + 1) * bs, c * bs:(c + 1) * bs] \
                    += host.blocks[j]
    return out[:n, :n]


def _counted_spmv(st, x):
    """y = A x summed as the CUDA kernels sum it: per ELL row its
    ``valid_counts`` leading slots, per SELL sorted row its
    ``cell_valid`` leading cells under ``cell_ptr`` (plus the one pad slot
    or cell they fold in, the zero block here, so left out). Read from the
    device tensors, so a count that was not bumped drops an insert."""
    a = {k: v.cpu().numpy() for k, v in st.arrays.items()}
    bs = st.block_size
    n_bc = -(-st.meta.shape[1] // bs)
    xb = np.zeros(n_bc * bs, np.float64)
    xb[: x.size] = x
    xb = xb.reshape(n_bc, bs)
    blocks = a["blocks"].astype(np.float64)
    if st.layout == "ell":
        y = np.zeros((a["block_indices"].shape[0], bs))
        for br, cnt in enumerate(a["valid_counts"]):
            for s in range(int(cnt)):
                y[br] += blocks[a["block_indices"][br, s]] @ \
                    xb[a["block_cols"][br, s]]
        return y.reshape(-1)
    y = np.zeros((a["row_perm"].shape[0], bs))
    for p, cnt in enumerate(a["cell_valid"]):
        t0 = int(a["cell_ptr"][p])
        for t in range(t0, t0 + int(cnt)):
            y[a["row_perm"][p]] += blocks[a["cell_block"][t]] @ \
                xb[a["cell_col"][t]]
    return y.reshape(-1)


def _check_apply_delta_matches_rebuild(seed, layout, structural, mode):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(24, 72))
    d = ((rng.random((n, n)) < 0.08) *
         rng.standard_normal((n, n))).astype(np.float32)
    A = CSR.from_dense(d)
    bs = 8
    st = SparseTensor.from_csr(A, layout=None if layout == "ell" else layout,
                               block_size=bs, slack=2, shape_bucket=True,
                               device=CPU)
    k = int(rng.integers(1, 6))
    lens = np.diff(A.row_ptrs)
    rows = np.repeat(np.arange(n), lens)
    if rows.size == 0:
        return
    pick = rng.choice(rows.size, size=min(k, rows.size), replace=False)
    dr = list(rows[pick])
    dc = list(A.col_idxs[pick].astype(np.int64))
    if structural and layout != "bsr":
        pos = _empty_block_positions(A, bs, 1)
        if len(pos):
            dr.append(pos[0, 0])
            dc.append(pos[0, 1])
    dv = rng.standard_normal(len(dr)).astype(np.float32)
    delta = Delta(np.array(dr), np.array(dc), dv, mode)

    want = d.copy()
    if mode == "add":
        np.add.at(want, (np.array(dr), np.array(dc)), dv)
    else:
        want[np.array(dr), np.array(dc)] = dv
    st.apply_delta(delta)
    rebuilt = SparseTensor.from_csr(
        CSR.from_dense(want), layout=None if layout == "ell" else layout,
        block_size=bs, shape_bucket=True, device=CPU)
    np.testing.assert_allclose(_tensor_dense(st, n),
                               _tensor_dense(rebuilt, n),
                               rtol=1e-5, atol=1e-5)
    assert st.generation == 1
    if layout != "bsr":
        # the counts the kernels stop at cover every real slot or cell
        x = rng.standard_normal(n).astype(np.float32)
        np.testing.assert_allclose(_counted_spmv(st, x)[:n],
                                   want.astype(np.float64) @ x,
                                   rtol=1e-5, atol=1e-5)


if HAVE_HYPOTHESIS:
    @given(seed=st_.integers(0, 2**16),
           layout=st_.sampled_from(["ell", "sell", "bsr"]),
           structural=st_.booleans(), mode=st_.sampled_from(["set", "add"]))
    @settings(max_examples=20, deadline=None)
    def test_apply_delta_matches_rebuild(seed, layout, structural, mode):
        _check_apply_delta_matches_rebuild(seed, layout, structural, mode)
else:
    @pytest.mark.parametrize("mode", ["set", "add"])
    @pytest.mark.parametrize("structural", [False, True])
    @pytest.mark.parametrize("layout", ["ell", "sell", "bsr"])
    @pytest.mark.parametrize("seed", [0, 11, 42])
    def test_apply_delta_matches_rebuild(seed, layout, structural, mode):
        _check_apply_delta_matches_rebuild(seed, layout, structural, mode)


# ------------------------------------------------------------- chaos coverage

@pytest.mark.parametrize("site", ["delta-apply", "slack-overflow"])
def test_mutation_chaos_fired_equals_recovered(site):
    rng = np.random.default_rng(6)
    A = _random_csr(rng, n=64, density=0.05)
    x = rng.standard_normal(64).astype(np.float32)
    inj = FaultInjector(rate=1.0, seed=7, sites=(site,))
    install_injector(inj)
    store = PreparedStore()
    mm = MutableMatrix(A, store=store, slack=4)
    plan("spmv", (A,), store=store, block_size=8, device=CPU).execute(x)
    r, c = _existing_positions(A, rng, 4)
    mm.apply_delta(Delta(r, c, np.full(4, 2.0, np.float32)))
    y = _y(plan("spmv", (A,), store=store, block_size=8, device=CPU), x)
    np.testing.assert_allclose(y, A.to_dense() @ x, **TOL)
    t = inj.telemetry()
    assert t["fault_fired"] == t["fault_recovered"] > 0
    assert dict(mm.telemetry())["epoch_swaps"] >= 1


# ----------------------------------------------------------- drift watchdog

def test_drift_quarantines_stale_schedule_and_auto_refits():
    tuner = ScheduleTuner("spmv", V5E).fit(
        corpus(n_matrices=6, n_min=128, n_max=192, seed=3), max_mats=3)
    svc = SelectorService(tuner, cache=ScheduleCache(), device=CPU)
    mon = DriftMonitor(svc, drift_threshold=0.05, accuracy_floor=0.9,
                       window=6, min_checks=2)
    rng = np.random.default_rng(5)
    n = 128
    A = _random_csr(rng, n=n, density=0.02)
    mm = MutableMatrix(A, store=PreparedStore(), monitor=mon, slack=8)
    svc.select(A)
    base_fp = mon._baselines[mm.base_key]
    assert base_fp.key in svc.cache._entries   # schedule cached pre-drift

    def tree_near_optimal():
        fp = fingerprint(A)
        pred = svc.predictor.predict_from_features(fp.features)
        t_best = min(_modeled_time(tuner.kernel, A, tuner.platform, s)
                     for _, s in svc.predictor.rank(fp.features))
        t_pred = _modeled_time(tuner.kernel, A, tuner.platform,
                               pred.schedule)
        return t_pred <= t_best * 1.05

    pre = []
    for _ in range(10):     # drift hard toward dense, 1200 inserts a step
        empt = np.argwhere(A.to_dense() == 0)
        k = min(1200, empt.shape[0])
        pick = empt[rng.choice(empt.shape[0], k, replace=False)]
        if mon.auto_refits == 0:
            pre.append(tree_near_optimal())
        mm.apply_delta(Delta(pick[:, 0], pick[:, 1],
                             rng.standard_normal(k).astype(np.float32)))
    tel = dict(mon.telemetry())
    assert tel["drift_detections"] >= 1
    assert tel["quarantined_schedules"] >= 1
    assert base_fp.key not in svc.cache._entries   # stale entry evicted
    assert svc.cache.drift_evictions >= 1
    assert tel["auto_refits"] >= 1
    assert tree_near_optimal()
    assert np.mean(pre) < 1.0 or not pre   # it was degraded before refit
    # the watchdog's state survives a checkpoint round trip
    fresh = DriftMonitor(svc)
    assert fresh.restore_state(json.loads(json.dumps(mon.export_state()))) \
        == len(mon._baselines)
    assert fresh._baselines[mm.base_key].key == \
        mon._baselines[mm.base_key].key


def test_drift_score_like_jax():
    from repro.selector import drift_score as jdrift_score
    from repro.selector import fingerprint as jfingerprint
    from repro_torch.selector import drift_score
    rng = np.random.default_rng(12)
    d0, d1 = _dense(rng, 128, 0.02), _dense(rng, 128, 0.2)
    got = drift_score(fingerprint(CSR.from_dense(d0)),
                      fingerprint(CSR.from_dense(d1)))
    want = jdrift_score(jfingerprint(J.CSR.from_dense(d0)),
                        jfingerprint(J.CSR.from_dense(d1)))
    assert got == pytest.approx(want, rel=1e-12) and got > 0


# ------------------------------------------- store index generation (v3)

def _stale_index(store, mm, path, rng, A, x, run_plan):
    """Save ``store``'s index after one delta with a pre-mutation (gen 0)
    entry spliced back in; returns the gen-0 entry."""
    run_plan()
    assert store.save(path)
    payload = json.loads(open(path).read())
    r, c = _existing_positions(A, rng, 2)
    mm.apply_delta((r, c, np.ones(2, np.float32)))
    run_plan()
    assert store.save(path)
    stale = dict(payload["entries"][0])
    cur = json.loads(open(path).read())
    cur["entries"].append(stale)
    cur["entries"] = checksum_entries(
        [{k: v for k, v in e.items() if k != "crc32"}
         for e in cur["entries"]])
    atomic_write_json(path, cur)
    return payload


def test_store_index_persists_generations_and_drops_stale(tmp_path):
    rng = np.random.default_rng(7)
    A = _random_csr(rng, n=64)
    x = rng.standard_normal(64).astype(np.float32)
    store = PreparedStore()
    mm = MutableMatrix(A, store=store, slack=2)
    path = str(tmp_path / "index.json")
    payload = _stale_index(store, mm, path, rng, A, x, lambda: plan(
        "spmv", (A,), store=store, block_size=16, device=CPU).execute(x))
    assert payload["version"] == STORE_INDEX_VERSION == 3
    gens = [(e["base"], e["generation"]) for e in payload["entries"]]
    assert (mm.base_key, 0) in gens

    fresh = PreparedStore()
    prior = fresh.load(path)
    assert fresh.stale_drops >= 1
    kept_gens = {(e["base"], e["generation"]) for e in prior["entries"]
                 if e.get("base") == mm.base_key}
    assert kept_gens == {(mm.base_key, 1)}   # only the newest generation


def test_store_index_older_version_cold_starts(tmp_path):
    path = str(tmp_path / "index.json")
    atomic_write_json(path, {"version": 2, "entries": [{"key": "x"}],
                             "telemetry": {"hits": 9}})
    store = PreparedStore()
    assert store.load(path) == {}              # v2 index: cold start


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_store_index_reads_across_packages(tmp_path, writer):
    rng = np.random.default_rng(13)
    d = _dense(rng, 64)
    x = rng.standard_normal(64).astype(np.float32)
    path = str(tmp_path / "index.json")
    if writer == "port":
        A = CSR.from_dense(d)
        store = PreparedStore()
        mm = MutableMatrix(A, store=store, slack=2)
        _stale_index(store, mm, path, rng, A, x, lambda: plan(
            "spmv", (A,), store=store, block_size=16, device=CPU).execute(x))
    else:
        A = J.CSR.from_dense(d)
        store = JPreparedStore()
        mm = JMutableMatrix(A, store=store, slack=2)
        _stale_index(store, mm, path, rng, A, x, lambda: jplan(
            "spmv", (A,), backend="jnp", store=store,
            block_size=16).execute(x))
    readers = [PreparedStore(), JPreparedStore()]
    priors = [r.load(path) for r in readers]
    assert readers[0].stale_drops == readers[1].stale_drops >= 1
    assert priors[0]["entries"] == priors[1]["entries"]
    assert {(e["base"], e["generation"]) for e in priors[0]["entries"]} \
        == {(mm.base_key, 1)}


# ------------------------------------------- serving engine mid-replay mutation

def test_engine_mutation_mid_replay_no_stale_result():
    from repro_torch.serving import ServingEngine

    class FakeClock:
        def __init__(self):
            self.t = 100.0

        def __call__(self):
            return self.t

    tuner = ScheduleTuner("spmv", V5E).fit(
        corpus(n_matrices=6, n_min=96, n_max=160, seed=3), max_mats=3)
    store = PreparedStore()
    svc = SelectorService(tuner, cache=ScheduleCache(),
                          prepared_store=store, device=CPU)
    engine = ServingEngine(svc, clock=FakeClock())
    rng = np.random.default_rng(8)
    A = _random_csr(rng, n=96, density=0.06)
    x = rng.standard_normal(96).astype(np.float32)
    mm = MutableMatrix(A, store=store, slack=4)
    outs = []
    inner = svc.drain_bucket

    def drain_bucket(members, backend="auto"):
        decs = inner(members, backend=backend)
        outs.extend(dec.y for dec in decs)
        return decs

    svc.drain_bucket = drain_bucket
    for j in range(3):                       # warm replay
        engine.submit(f"warm{j}", A, x, tenant=0)
    engine.drain_all()
    y_old = A.to_dense() @ x

    r, c = _existing_positions(A, rng, 6)    # mutate mid-replay
    mm.apply_delta(Delta(r, c, rng.standard_normal(6).astype(np.float32)))
    y_new = A.to_dense() @ x
    assert not np.allclose(y_new, y_old)
    n_before = len(outs)

    for j in range(3):                       # post-mutation replay
        engine.submit(f"post{j}", A, x, tenant=0)
    engine.drain_all()
    for y in outs[:n_before]:
        np.testing.assert_allclose(y, y_old, **TOL)
    assert len(outs) > n_before
    for y in outs[n_before:]:                # nothing from the old values
        np.testing.assert_allclose(y, y_new, **TOL)

    svc.submit("check", A, x)
    dec = svc.run()[0]
    np.testing.assert_allclose(dec.y, y_new, **TOL)
    tel = engine.telemetry()
    assert tel["admitted"] == tel["completed"] + tel["shed"]
    assert tel["completed"] >= 6.0


# ------------------------------------------------------------------ parity

def _leaves(st):
    """Host and device leaves of a prepared container, as numpy."""
    host = st.to_host()
    names = (("block_indices", "block_cols", "valid_counts", "blocks")
             if st.layout == "ell" else ("cell_block", "cell_col", "blocks"))
    dev = {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
           for k, v in st.arrays.items() if k in names}
    return {k: np.asarray(getattr(host, k)) for k in names}, dev


def _only_entry(store):
    (value, _), = store._entries.values()
    return value


@pytest.mark.parametrize("layout", ["ell", "sell"])
@pytest.mark.parametrize("mode", ["set", "add"])
def test_mutable_matrix_like_jax(layout, mode):
    rng = np.random.default_rng(21)
    d = _dense(rng, 96, 0.04)
    A, JA = CSR.from_dense(d), J.CSR.from_dense(d)
    x = rng.standard_normal(96).astype(np.float32)
    store, jstore = PreparedStore(), JPreparedStore()
    mm = MutableMatrix(A, store=store, slack=4)
    jmm = JMutableMatrix(JA, store=jstore, slack=4)
    kw = dict(layout=layout, block_size=8)

    def both():
        y = _y(plan("spmv", (A,), store=store, device=CPU, **kw), x)
        jy = np.asarray(jplan("spmv", (JA,), backend="jnp", store=jstore,
                              **kw).execute(x))
        return y, jy

    both()
    r, c = _existing_positions(A, rng, 10)
    br, bcs = _row_of_empty_blocks(A, 8, 2)
    r = np.r_[r, br * 8, br * 8 + 3]
    c = np.r_[c, bcs[0] * 8 + 1, bcs[1] * 8 + 5]
    v = rng.standard_normal(r.size).astype(np.float32)
    for m_, dl in ((mm, Delta(r, c, v, mode)), (jmm, JDelta(r, c, v, mode))):
        m_.apply_delta(dl)
    y, jy = both()
    np.testing.assert_allclose(y, jy, **TOL)
    np.testing.assert_allclose(y, _dense_after(d, r, c, v, mode) @ x, **TOL)
    assert mm.generation == jmm.generation == 1
    assert mm.version_key == jmm.version_key == content_key(A)
    assert dict(mm.telemetry()) == dict(jmm.telemetry())
    st, jst = _only_entry(store), _only_entry(jstore)
    assert st.generation == jst.generation == 1
    assert st.spare_blocks == jst.spare_blocks
    (h, dv), (jh, jdv) = _leaves(st), _leaves(jst)
    for k in h:
        np.testing.assert_array_equal(h[k], jh[k], err_msg=k)
        np.testing.assert_array_equal(dv[k], jdv[k], err_msg=k)
        np.testing.assert_array_equal(dv[k], h[k], err_msg=k)


@pytest.mark.parametrize("layout", ["ell", "sell"])
def test_counts_cover_two_inserts_in_one_row(layout):
    """Two new blocks in one block-row: the row's count of real slots
    (ELL ``valid_counts``) or cells (SELL ``cell_valid``, the port's own)
    grows by two, equals the count of real slots or cells recomputed from
    the index arrays, and a sum that stops at it, as the CUDA kernels do,
    matches the oracle (without the SELL bump it drops the second
    insert)."""
    rng = np.random.default_rng(17)
    d = _dense(rng, 96, 0.04)
    A = CSR.from_dense(d)
    x = rng.standard_normal(96).astype(np.float32)
    bs = 8
    st = SparseTensor.from_csr(A, layout=None if layout == "ell" else layout,
                               block_size=bs, slack=3, shape_bucket=True,
                               device=CPU)
    br, bcs = _row_of_empty_blocks(A, bs, 2)
    count = "valid_counts" if layout == "ell" else "cell_valid"
    row = br if layout == "ell" else int(
        np.flatnonzero(st.to_host().row_perm == br)[0])
    before = int(st.arrays[count][row])
    r = np.array([br * bs, br * bs + 2])
    c = np.array([bcs[0] * bs + 1, bcs[1] * bs + 4])
    v = np.array([2.0, -3.0], np.float32)
    st.apply_delta(Delta(r, c, v))
    got = st.arrays[count].cpu().numpy()
    assert int(got[row]) == before + 2
    host = st.to_host()
    zero = st._zero_idx
    if layout == "ell":
        true = (host.block_indices != zero).sum(axis=1)
    else:
        ptr = st.arrays["cell_ptr"].cpu().numpy()
        true = sell_cell_valid(host.cell_block, ptr, zero)
        np.testing.assert_array_equal(
            ptr, sell_row_ptr(host.cell_row, host.n_block_rows,
                              st._live_cells))
    np.testing.assert_array_equal(got, true)
    want = _dense_after(d, r, c, v, "set") @ x
    np.testing.assert_allclose(_counted_spmv(st, x)[:96], want,
                               rtol=1e-5, atol=1e-5)
    # the plan serves the same (on the CPU the plain all-slot version)
    np.testing.assert_allclose(
        _y(plan("spmv", (st,), device=CPU), x), want, **TOL)


@pytest.mark.parametrize("layout", ["ell", "sell"])
def test_convert_carries_a_slack_container(layout):
    rng = np.random.default_rng(19)
    d = _dense(rng, 80, 0.02)
    A, JA = CSR.from_dense(d), J.CSR.from_dense(d)
    x = rng.standard_normal(80).astype(np.float32)
    lay = None if layout == "ell" else layout
    st = SparseTensor.from_csr(A, layout=lay, block_size=8, slack=2,
                               device=CPU)
    jst = JSparseTensor.from_csr(JA, layout=lay, block_size=8, slack=2)
    br, bcs = _row_of_empty_blocks(A, 8, 2)
    first = (np.array([br * 8]), np.array([bcs[0] * 8]),
             np.ones(1, np.float32))
    st.apply_delta(Delta(*first))
    jst.apply_delta(JDelta(*first))
    meta = dataclasses.asdict(jst.meta)
    meta["zero_idx"] = jst._zero_idx
    carried = convert.sparse_tensor_from_arrays(
        layout, meta, {k: np.asarray(v) for k, v in jst.arrays.items()},
        device=CPU, generation=jst.generation,
        spare_blocks=jst.spare_blocks)
    assert carried.generation == st.generation == 1
    assert carried.spare_blocks == st.spare_blocks
    for k in st.arrays:
        np.testing.assert_array_equal(carried.arrays[k].numpy(),
                                      st.arrays[k].numpy(), err_msg=k)
    # the next insert lands the same way in both
    second = (np.array([br * 8 + 1]), np.array([bcs[1] * 8 + 2]),
              np.full(1, 4.0, np.float32))
    for t in (carried, st):
        t.apply_delta(Delta(*second))
        assert t.generation == 2
    for k in st.arrays:
        np.testing.assert_array_equal(carried.arrays[k].numpy(),
                                      st.arrays[k].numpy(), err_msg=k)
    want = _dense_after(d, np.r_[first[0], second[0]], np.r_[first[1], second[1]],
                   np.r_[first[2], second[2]], "set") @ x
    for t in (carried, st):
        np.testing.assert_allclose(_counted_spmv(t, x)[:80], want,
                                   rtol=1e-5, atol=1e-5)
