"""The selector past its corpus (``repro_torch.selector.streamed``).

A ``SelectorService`` whose tuner was fitted on small matrices serves a
matrix more than twice the size of the largest of them by the bytes the
counted kernels stream, not by the cost tree: the pattern counts equal the
containers the plan builds, the route counts itself and caches its pick,
in-domain requests keep the tree's decision, and the pick keeps every
block and leaves quarantined schedules out.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from repro_torch.core import H100_SXM, ScheduleTuner, corpus
from repro_torch.core.autotune import BLOCK_SIZES, candidate_schedules
from repro_torch.core.csr import BSR, ELLBSR, SELLBSR
from repro_torch.core.dataset import DOMAINS
from repro_torch.core.synthetic import gen_spatial, gen_zipf
from repro_torch.obs import Tracer, default_registry, install_tracer
from repro_torch.selector import (SchedulePredictor, SelectorService,
                                  fingerprint)
from repro_torch.selector import streamed
from repro_torch.sparse import plan
from repro_torch.sparse.resilience import Quarantine
from repro_torch.sparse.tensor import SparseTensor

CPU = "cpu"
TRAIN = dict(n_matrices=18, n_min=256, n_max=768, seed=0)
HELD = dict(n_matrices=6, n_min=256, n_max=768, seed=91)
PROD_GAP = 2e-5   # the benchmark cells' limit on the widest row gap


def _power_law(n: int, seed: int):
    return DOMAINS["social_networks"](n, np.random.default_rng(seed))


SMALL = {
    "spatial": lambda: gen_spatial(1536, seed=4),
    "zipf": lambda: gen_zipf(1024, seed=5, a=1.6),
    "power_law": lambda: _power_law(2048, seed=6),
}


@pytest.fixture(scope="module")
def small():
    return {name: make() for name, make in SMALL.items()}


@pytest.fixture(scope="module")
def tuner():
    return ScheduleTuner("spmv", H100_SXM).fit(corpus(**TRAIN),
                                               max_mats=TRAIN["n_matrices"])


def _service(tuner, **kw):
    return SelectorService(tuner, confidence_threshold=0.0,
                           quarantine=Quarantine(), device=CPU, **kw)


def _pad_rows_ell(ell: ELLBSR) -> int:
    return int(np.count_nonzero(ell.valid_counts < ell.max_blocks))


def _pad_rows_sell(sell: SELLBSR) -> int:
    pad = sell.cell_block == sell.blocks.shape[0] - 1
    return int(np.unique(sell.cell_row[pad]).size)


# ------------------------------------------------------------ pattern counts

@pytest.mark.parametrize("kind", sorted(SMALL))
@pytest.mark.parametrize("bs", BLOCK_SIZES)
def test_pattern_equals_bsr(small, kind, bs):
    A = small[kind]
    p = streamed.block_patterns(A, BLOCK_SIZES)[bs]
    bsr = BSR.from_csr(A, bs)
    assert p.n_block_rows == bsr.n_block_rows
    assert p.n_blocks == bsr.n_blocks
    np.testing.assert_array_equal(p.blocks_per_row, bsr.blocks_per_row())


@pytest.mark.parametrize("kind", sorted(SMALL))
@pytest.mark.parametrize("sched", [s for s in candidate_schedules()
                                   if s.layout == "ell"], ids=str)
def test_ell_counts_equal_container(small, kind, sched):
    A = small[kind]
    p = streamed.block_patterns(A, [sched.block_size])[sched.block_size]
    ell = SparseTensor.build_container(A, sched)
    assert isinstance(ell, ELLBSR)
    c = streamed.layout_counts(p, sched)
    assert c.slots == ell.block_indices.size
    assert c.kept == int(ell.valid_counts.sum())
    assert c.pad_rows == _pad_rows_ell(ell)


@pytest.mark.parametrize("kind", sorted(SMALL))
@pytest.mark.parametrize("sched", [s for s in candidate_schedules()
                                   if s.layout == "sell"], ids=str)
def test_sell_counts_equal_container(small, kind, sched):
    A = small[kind]
    p = streamed.block_patterns(A, [sched.block_size])[sched.block_size]
    sell = SparseTensor.build_container(A, sched)
    assert isinstance(sell, SELLBSR)
    c = streamed.layout_counts(p, sched)
    assert c.slots == sell.n_cells
    assert c.kept == p.n_blocks == sell.blocks.shape[0] - 1
    assert c.pad_rows == _pad_rows_sell(sell)


@pytest.mark.parametrize("n_rhs, tiles, tile", [(1, 1, 1), (8, 1, 8),
                                                (64, 8, 8)])
def test_streamed_bytes_per_rhs_tile(n_rhs, tiles, tile):
    """Per RHS tile: the blocks read (kept + one pad per padded row), a
    segment of x per block read, y once per block row."""
    p = streamed.BlockPattern(32, np.array([3, 1, 0], np.int64))
    c = streamed.LayoutCounts(kept=4, pad_rows=2, slots=9)
    want = tiles * 4 * (6 * 32 * 32 + 6 * 32 * tile + 3 * 32 * tile)
    assert streamed.streamed_bytes(p, c, n_rhs) == want


def test_extent_is_the_largest_training_matrix(tuner):
    names = tuner.feature_names
    rows = np.asarray(tuner._train_rows)
    ext = streamed.training_extent(tuner)
    assert ext == (rows[:, names.index("log_rows")].max(),
                   rows[:, names.index("log_nnz")].max())
    over, under = np.log10(2.0) + 1e-3, np.log10(2.0) - 1e-3
    for d_rows, d_nnz, past in ((over, over, True), (over, under, False),
                                (under, over, False), (over, 0.0, False)):
        feats = {"log_rows": ext[0] + d_rows, "log_nnz": ext[1] + d_nnz}
        assert bool(streamed.past_extent(feats, ext)) == past, (d_rows, d_nnz)
        assert not streamed.past_extent(feats, None)


# ------------------------------------------------------------------ the route

def test_past_corpus_spatial_takes_the_bytes_route(tuner, monkeypatch):
    A = gen_spatial(32768, seed=1)
    svc = _service(tuner)
    reg = default_registry()
    before = reg.get("select_out_of_domain")

    def no_blocks(*_a, **_k):
        raise AssertionError("the bytes route built a BSR")

    tracer = install_tracer(Tracer())
    try:
        with monkeypatch.context() as m:
            m.setattr(BSR, "from_csr", classmethod(no_blocks))
            dec = svc.select(A)
    finally:
        install_tracer(None)
    assert dec.source == "bytes"
    assert dec.schedule.backend == "bsr" and dec.schedule.block_size == 32
    ranked = streamed.rank_by_bytes(A, candidate_schedules(1), 1)
    assert dec.schedule == ranked[0].schedule
    assert dec.modeled_time_s == ranked[0].bytes / H100_SXM.hbm_bw
    assert svc.telemetry()["out_of_domain"] == 1
    assert reg.get("select_out_of_domain") == before + 1
    assert svc.retraining_examples == []
    evs = tracer.events()
    (sel,) = [e for e in evs if e["type"] == "select"]
    (ev,) = [e for e in evs if e["type"] == "bytes"]
    assert ev["parent"] == sel["id"]
    assert ev["args"]["candidates"] == len(candidate_schedules(1))
    assert ev["args"]["eligible"] == len(ranked)
    assert ev["args"]["streamed_bytes"] == ranked[0].bytes
    assert ev["args"]["modeled_ms"] == pytest.approx(dec.modeled_time_s * 1e3)
    assert not [e for e in evs if e["type"] in ("tree", "verify")]

    again = svc.select(A)
    assert again.source == "cache" and again.schedule == dec.schedule
    tel = svc.telemetry()
    assert tel["out_of_domain"] == 1 and tel["cache_hits"] == 1
    assert reg.get("select_out_of_domain") == before + 1
    p = plan("spmv", A, selector=svc, device=CPU)
    assert p.source == "selector-cache"


def test_plan_reports_the_bytes_source(tuner):
    A = gen_spatial(32768, seed=2)
    p = plan("spmv", A, selector=_service(tuner), device=CPU)
    assert p.source == "selector-bytes"
    assert p.modeled_time_s > 0


@pytest.mark.parametrize("i", range(HELD["n_matrices"]))
def test_in_domain_keeps_the_tree(tuner, i):
    """A held-out matrix inside the corpus's sizes, and one below them,
    are decided by the tree exactly as before; the route never counts."""
    _, _, A = corpus(**HELD)[i]
    for M in (A, gen_spatial(64, seed=i)):
        svc = _service(tuner)
        dec = svc.select(M)
        fp = fingerprint(M)
        assert not streamed.past_extent(fp.features,
                                        streamed.training_extent(tuner))
        pred = SchedulePredictor(tuner).predict(fp)
        assert dec.source == "tree"
        assert dataclasses.asdict(dec.schedule) == dataclasses.asdict(
            pred.schedule)
        assert (dec.confidence, dec.modeled_time_s) == (
            pred.confidence, pred.tree_time_s)
        assert svc.telemetry()["out_of_domain"] == 0


def test_untrained_extent_keeps_the_tree(tuner):
    """A tuner that carries a tree but no training rows gives no extent,
    so even a large matrix goes to the tree."""
    bare = ScheduleTuner("spmv", H100_SXM)
    bare.tree, bare.feature_names = tuner.tree, tuner.feature_names
    dec = _service(bare).select(gen_spatial(32768, seed=1))
    assert dec.source == "tree"


# ------------------------------------------------- lossless and quarantined

@pytest.fixture(scope="module")
def hubs():
    return _power_law(8192, seed=3)


def test_power_law_drops_under_a_quantile_cap(hubs):
    """The premise: on this graph some q < 1 ELL cap drops blocks, so the
    route has candidates to refuse."""
    pats = streamed.block_patterns(hubs, BLOCK_SIZES)
    lossy = [s for s in candidate_schedules()
             if streamed.layout_counts(pats[s.block_size], s).kept
             < pats[s.block_size].n_blocks]
    assert lossy and all(s.layout == "ell" and s.ell_quantile < 1.0
                         for s in lossy)
    ranked = streamed.rank_by_bytes(hubs, candidate_schedules(), 1)
    assert not {c.schedule for c in ranked} & set(lossy)


def _row_gap(A, x, y):
    """Widest |y_i - ref_i| / sum_j |a_ij x_j| against the float64 CSR
    product, the benchmark's ``prod_gap``."""
    rows = np.repeat(np.arange(A.n_rows), A.row_lengths())
    v = A.nnz_vals.astype(np.float64)[:, None] * \
        np.asarray(x, np.float64).reshape(A.n_cols, -1)[A.col_idxs]
    ref = np.zeros((A.n_rows, v.shape[1]))
    mag = np.zeros_like(ref)
    np.add.at(ref, rows, v)
    np.add.at(mag, rows, np.abs(v))
    gap = np.abs(np.asarray(y, np.float64).reshape(ref.shape) - ref)
    return float((gap / np.maximum(mag, 1e-30)).max())


@pytest.mark.parametrize("n_rhs", [1, 8])
def test_power_law_pick_is_lossless_and_exact(tuner, hubs, n_rhs):
    t = ScheduleTuner("spmv", H100_SXM, n_rhs=n_rhs)
    t.tree, t.feature_names = tuner.tree, tuner.feature_names
    t._train_rows, t._train_ys = tuner._train_rows, tuner._train_ys
    svc = _service(t)
    p = plan("spmm" if n_rhs > 1 else "spmv", hubs, selector=svc, device=CPU)
    assert p.source == "selector-bytes"
    s = p.schedule
    container = SparseTensor.build_container(hubs, s)
    kept = (int(container.valid_counts.sum())
            if isinstance(container, ELLBSR)
            else container.blocks.shape[0] - 1)
    assert kept == BSR.from_csr(hubs, s.block_size).n_blocks
    rng = np.random.default_rng(7)
    x = rng.standard_normal(hubs.n_cols if n_rhs == 1
                            else (hubs.n_cols, n_rhs)).astype(np.float32)
    y = p.execute(x).numpy()
    assert _row_gap(hubs, x, y) <= PROD_GAP


def test_quarantined_block_size_is_never_picked(tuner, hubs):
    svc = _service(tuner)
    blocked = [s for s in candidate_schedules() if s.block_size == 32]
    for s in blocked:
        svc.quarantine.add("spmv", "cuda", s, reason="test")
    dec = svc.select(hubs)
    assert dec.source == "bytes"
    assert dec.schedule.block_size != 32
    ranked = streamed.rank_by_bytes(hubs, candidate_schedules(), 1)
    assert dec.schedule == next(c.schedule for c in ranked
                                if c.schedule not in blocked)
    assert svc.telemetry()["quarantine_overridden"] == 0


def test_all_lossless_quarantined_is_overridden_and_counted(tuner, hubs):
    svc = _service(tuner)
    for s in candidate_schedules():
        svc.quarantine.add("spmv", "cuda", s, reason="test")
    dec = svc.select(hubs)
    assert dec.source == "bytes"
    assert dec.schedule == streamed.rank_by_bytes(
        hubs, candidate_schedules(), 1)[0].schedule
    assert svc.telemetry()["quarantine_overridden"] == 1
