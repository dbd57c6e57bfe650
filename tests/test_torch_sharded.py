"""The port's sharded SpMV/SpMM path (``repro_torch.sparse.plan_sharded``)
held against the JAX package's (``repro.sparse.plan_sharded``,
``backend="jnp"``): one counterpart of each test in ``test_sharded.py``
(partitioner properties, bounds equal to the reference's, sharded versus
unsharded and the dense oracle over 1/2/4 shards in ELL and SELL, uniform,
heterogeneous and selector-resolved schedules, one launch per uniform
execute, per-shard provenance and ``select_shards`` telemetry beside the
JAX service's, warm plans that rebuild nothing, the sharded-tensor guards,
the partition entry's byte accounting, the store index), plus a
``ShardedSparseTensor`` carried across with ``convert``. Everything runs
on the CPU at the reference's ``rtol=atol=2e-4``."""
import dataclasses

import numpy as np
import pytest

import repro.core as J
from repro.core.autotune import Schedule as JSchedule
from repro.selector import ScheduleCache as JScheduleCache
from repro.selector import SelectorService as JSelectorService
from repro.sparse import ShardedSparseTensor as JShardedSparseTensor
from repro.sparse import plan_sharded as jplan_sharded
from repro.sparse import partition_rows as jpartition_rows
from repro.sparse import resilience as jres
from repro.sparse.partition import equal_row_bounds as jequal_row_bounds
from repro.sparse.partition import nnz_balanced_bounds as jnnz_bounds
from repro_torch import convert
from repro_torch import core as T
from repro_torch.core import CSR, Schedule, ScheduleTuner, shard_counters
from repro_torch.core.synthetic import gen_zipf
from repro_torch.selector import ScheduleCache, SelectorService
from repro_torch.sparse import (PreparedStore, ShardedSparseTensor,
                                bounds_imbalance, content_key, launch_count,
                                partition_rows, plan, plan_sharded,
                                reset_counters, reset_resilience, slice_rows)
from repro_torch.sparse import ops_builtin
from repro_torch.sparse.partition import (equal_row_bounds,
                                          nnz_balanced_bounds)

CPU = "cpu"
TOL = dict(rtol=2e-4, atol=2e-4)
# the JAX package's TPU v5e figures, carried across as data
V5E = T.Platform(**dataclasses.asdict(J.TPU_V5E))
HETERO = [Schedule("bsr", 32, 1.0),
          Schedule("bsr", 16, 1.0, layout="sell", slice_height=4),
          Schedule("bsr", 64, 1.0),
          Schedule("bsr", 32, 1.0, layout="sell", slice_height=8)]


@pytest.fixture(autouse=True)
def _fresh_resilience():
    reset_resilience()
    jres.reset_resilience()
    yield
    reset_resilience()
    jres.reset_resilience()


@pytest.fixture(scope="module")
def zipf():
    return gen_zipf(512, seed=2, a=1.6)


def _pair(csr: CSR) -> J.CSR:
    return J.CSR(csr.row_ptrs, csr.col_idxs, csr.nnz_vals, csr.shape)


def _js(s: Schedule) -> JSchedule:
    return JSchedule(**dataclasses.asdict(s))


@pytest.fixture(scope="module")
def services():
    """A port and a JAX ``SelectorService`` over tuners fit on the same
    corpus and the same platform figures."""
    kw = dict(n_matrices=9, n_min=256, n_max=384, seed=3)
    tuner = ScheduleTuner("spmv", V5E).fit(T.corpus(**kw), max_mats=9)
    jtuner = J.ScheduleTuner("spmv", J.TPU_V5E).fit(J.corpus(**kw),
                                                    max_mats=9)
    return (SelectorService(tuner, cache=ScheduleCache(), device=CPU),
            JSelectorService(jtuner, cache=JScheduleCache()))


def _x(n, k=None, seed=0):
    rng = np.random.default_rng(seed)
    shape = (n,) if k is None else (n, k)
    return rng.standard_normal(shape).astype(np.float32)


def _sched(layout: str, bs: int = 32, n_rhs: int = 1) -> Schedule:
    if layout == "sell":
        return Schedule("bsr", bs, 1.0, layout="sell", slice_height=4,
                        n_rhs=n_rhs)
    return Schedule("bsr", bs, 1.0, n_rhs=n_rhs)


# ------------------------------------------------------------- partitioner

@pytest.mark.parametrize("strategy", ["nnz", "rows"])
@pytest.mark.parametrize("n_shards", [1, 2, 4, 7])
def test_partition_covers_rows_exactly_once(zipf, strategy, n_shards):
    part = partition_rows(zipf, n_shards, strategy)
    jpart = jpartition_rows(_pair(zipf), n_shards, strategy)
    assert (part.bounds, part.shard_nnz, part.strategy) == (
        jpart.bounds, jpart.shard_nnz, jpart.strategy)
    assert part.imbalance() == jpart.imbalance()
    bounds = np.asarray(part.bounds)
    assert bounds[0] == 0 and bounds[-1] == zipf.n_rows
    assert (np.diff(bounds) >= 1).all()
    assert sum(part.shard_rows()) == zipf.n_rows
    assert sum(part.shard_nnz) == zipf.nnz
    dense = np.concatenate([slice_rows(zipf, bounds[i], bounds[i + 1])
                            .to_dense() for i in range(part.n_parts)])
    np.testing.assert_array_equal(dense, zipf.to_dense())


@pytest.mark.parametrize("seed,a", [(0, 1.09), (1, 1.5), (2, 1.6), (3, 2.0)])
@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_nnz_bounds_never_worse_than_equal_rows(seed, a, n_shards):
    A = gen_zipf(384, seed=seed, a=a)
    lengths = A.row_lengths()
    nb = nnz_balanced_bounds(lengths, n_shards)
    np.testing.assert_array_equal(nb, jnnz_bounds(lengths, n_shards))
    np.testing.assert_array_equal(equal_row_bounds(A.n_rows, n_shards),
                                  jequal_row_bounds(A.n_rows, n_shards))
    nnz_imb = bounds_imbalance(lengths, nb)
    row_imb = bounds_imbalance(lengths, equal_row_bounds(A.n_rows, n_shards))
    assert nnz_imb["mean"] <= row_imb["mean"] + 1e-12


def test_nnz_bounds_strictly_better_on_skewed(zipf):
    lengths = zipf.row_lengths()
    for n_shards in (2, 4, 8):
        nnz_imb = bounds_imbalance(lengths,
                                   nnz_balanced_bounds(lengths, n_shards))
        row_imb = bounds_imbalance(lengths,
                                   equal_row_bounds(zipf.n_rows, n_shards))
        assert nnz_imb["max"] < row_imb["max"]


def test_partition_degenerate_cases():
    A = gen_zipf(5, seed=0)
    part = partition_rows(A, 16)
    assert part.n_parts <= 5 and sum(part.shard_rows()) == 5
    assert part.bounds == jpartition_rows(_pair(A), 16).bounds
    empty = CSR(np.zeros(4, np.int64), np.zeros(0, np.uint32),
                np.zeros(0, np.float32), (3, 3))
    part = partition_rows(empty, 2)
    assert sum(part.shard_rows()) == 3
    assert part.imbalance() == {"mean": 0.0, "max": 0.0}


def test_shard_counters_features(zipf):
    part = partition_rows(zipf, 4, "nnz")
    feats = shard_counters(zipf, part.bounds)
    assert feats == J.shard_counters(_pair(zipf), part.bounds)
    assert len(feats) == 4
    assert sum(f["nnz"] for f in feats) == zipf.nnz
    assert all(f["nnz_share_dev"] < 0.05 for f in feats)
    rows_feats = shard_counters(zipf, equal_row_bounds(zipf.n_rows, 4))
    assert max(f["nnz_share_dev"] for f in rows_feats) \
        > max(f["nnz_share_dev"] for f in feats)


# ------------------------------------------------- sharded-vs-single equiv

@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("layout", ["ell", "sell"])
def test_plan_sharded_spmv_matches_single_device(zipf, n_shards, layout):
    s = _sched(layout)
    x = _x(zipf.shape[1])
    y_single = plan("spmv", (zipf,), schedule=s, device=CPU).execute(x)
    p = plan_sharded("spmv", (zipf,), n_shards=n_shards, schedule=s,
                     device=CPU)
    y = p.execute(x).numpy()
    jy = np.asarray(jplan_sharded("spmv", (_pair(zipf),), n_shards=n_shards,
                                  schedule=_js(s), backend="jnp").execute(x))
    assert p.n_shards == n_shards and p.schedule == s
    np.testing.assert_allclose(y, y_single.numpy(), **TOL)
    np.testing.assert_allclose(y, jy, **TOL)
    np.testing.assert_allclose(y, zipf.to_dense() @ x, **TOL)


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("layout", ["ell", "sell"])
def test_plan_sharded_spmm_matches_single_device(zipf, n_shards, layout):
    s = _sched(layout, n_rhs=3)
    X = _x(zipf.shape[1], k=3)
    Y_single = plan("spmm", (zipf,), schedule=s, device=CPU).execute(X)
    Y = plan_sharded("spmm", (zipf,), n_shards=n_shards, schedule=s,
                     device=CPU).execute(X).numpy()
    jY = np.asarray(jplan_sharded("spmm", (_pair(zipf),), n_shards=n_shards,
                                  schedule=_js(s), backend="jnp").execute(X))
    assert Y.shape == (zipf.shape[0], 3)
    np.testing.assert_allclose(Y, Y_single.numpy(), **TOL)
    np.testing.assert_allclose(Y, jY, **TOL)


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("op", ["spmv", "spmm"])
def test_plan_sharded_heterogeneous_schedules(zipf, n_shards, op):
    """Per-shard schedules may disagree (the skewed-matrix case the
    selector produces); each shard launches on its own, and the result
    matches the reference's round-robin path and the dense oracle."""
    scheds = HETERO[:n_shards]
    x = _x(zipf.shape[1], k=5 if op == "spmm" else None)
    reset_counters()
    p = plan_sharded(op, (zipf,), n_shards=n_shards, schedules=scheds,
                     device=CPU)
    assert p.schedule is None and "per-shard" in p.describe()
    y = p.execute(x).numpy()
    assert launch_count(op) == 1
    jy = np.asarray(jplan_sharded(
        op, (_pair(zipf),), n_shards=n_shards,
        schedules=[_js(s) for s in scheds], backend="jnp").execute(x))
    np.testing.assert_allclose(y, jy, **TOL)
    np.testing.assert_allclose(y, zipf.to_dense() @ x, **TOL)
    assert [st.layout for st in p.operands[0].shards] == \
        [s.layout for s in scheds]


def test_plan_sharded_one_logical_launch(zipf):
    reset_counters()
    p = plan_sharded("spmv", (zipf,), n_shards=4,
                     schedule=Schedule("bsr", 32, 1.0), device=CPU)
    p.execute(_x(zipf.shape[1]))
    assert launch_count("spmv") == 1


def test_plan_sharded_rejects_unknown_op_and_strategy(zipf):
    with pytest.raises(ValueError, match="no sharded execution path"):
        plan_sharded("spgemm", (zipf, zipf), n_shards=2, device=CPU)
    with pytest.raises(ValueError, match="strategy"):
        plan_sharded("spmv", (zipf,), n_shards=2, strategy="hash",
                     device=CPU)
    with pytest.raises(TypeError, match="CSR or ShardedSparseTensor"):
        plan_sharded("spmv", (zipf.to_dense(),), n_shards=2, device=CPU)


# ------------------------------------------------- selector + store paths

def test_plan_sharded_selector_provenance_per_shard(zipf, services):
    svc, jsvc = services
    n_shards = 4
    p = plan_sharded("spmv", (zipf,), n_shards=n_shards, selector=svc,
                     device=CPU)
    jp = jplan_sharded("spmv", (_pair(zipf),), n_shards=n_shards,
                       selector=jsvc, backend="jnp")
    assert p.shard_provenance is not None and len(p.shard_provenance) == 4
    for pr, jpr in zip(p.shard_provenance, jp.shard_provenance):
        assert pr["source"].startswith("selector-")
        assert pr["fingerprint_key"]
        assert (pr["source"], pr["fingerprint_key"]) == (
            jpr["source"], jpr["fingerprint_key"])
        assert dataclasses.asdict(pr["schedule"]) == dataclasses.asdict(
            jpr["schedule"])
    x = _x(zipf.shape[1])
    y = p.execute(x).numpy()
    np.testing.assert_allclose(y, np.asarray(jp.execute(x)), **TOL)
    np.testing.assert_allclose(y, zipf.to_dense() @ x, **TOL)
    tel = svc.telemetry()
    assert tel["shard_requests"] >= 4 and tel["sharded_plans"] >= 1
    jtel = jsvc.telemetry()
    assert (tel["shard_requests"], tel["sharded_plans"]) == (
        jtel["shard_requests"], jtel["sharded_plans"])


def test_plan_sharded_warm_skips_partition_and_prep(zipf, services):
    svc, _ = services
    store = svc.prepared_store
    plan_sharded("spmv", (zipf,), n_shards=4, selector=svc, device=CPU)
    h0, m0 = store.hits, store.misses
    p = plan_sharded("spmv", (zipf,), n_shards=4, selector=svc, device=CPU)
    assert store.hits >= h0 + 2        # partition entry + shard bundle
    assert store.misses == m0          # nothing rebuilt on the warm plan
    assert {pr["source"] for pr in p.shard_provenance} == {"selector-cache"}


@pytest.mark.parametrize("uniform", [True, False])
def test_uniform_and_per_shard_bundles_keep_apart(zipf, uniform):
    """The stacked launch's arrays and the per-shard containers live under
    different store keys, so a warm uniform plan never finds a per-shard
    bundle (or the reverse); the stack is the uniform plan's only device
    copy (no per-shard container is stored beside it)."""
    store = PreparedStore()
    kw = (dict(schedule=Schedule("bsr", 32, 1.0)) if uniform
          else dict(schedules=HETERO))
    x = _x(zipf.shape[1])
    y0 = plan_sharded("spmv", (zipf,), n_shards=4, store=store, device=CPU,
                      **kw).execute(x)
    kinds = sorted(k[0] for k in store._entries)
    want = "matvec_shards_stacked" if uniform else "matvec_shards"
    assert kinds == sorted(["row_partition", want])
    m0 = store.misses
    y1 = plan_sharded("spmv", (zipf,), n_shards=4, store=store, device=CPU,
                      **kw).execute(x)
    assert store.misses == m0
    np.testing.assert_array_equal(y0.numpy(), y1.numpy())


def test_plan_sharded_sst_operand_guards(zipf, services):
    svc, _ = services
    sst = ShardedSparseTensor.from_csr(zipf, 2, Schedule("bsr", 32, 1.0),
                                       device=CPU)
    with pytest.raises(TypeError, match="CSR first operand"):
        plan_sharded("spmv", (sst,), selector=svc, device=CPU)
    with pytest.raises(ValueError, match="re-partition"):
        plan_sharded("spmv", (sst,), n_shards=4, device=CPU)
    p = plan_sharded("spmv", (sst,), device=CPU)
    assert {pr["source"] for pr in p.shard_provenance} == {"prepared"}
    x = _x(zipf.shape[1])
    np.testing.assert_allclose(p.execute(x).numpy(), zipf.to_dense() @ x,
                               **TOL)


def test_prepared_sharded_tensor_builds_no_stack(zipf):
    """A prepared ShardedSparseTensor under one schedule runs from its own
    shards (one launch each): its plan stores no stacked copy of them."""
    s = Schedule("bsr", 32, 1.0)
    sst = ShardedSparseTensor.from_csr(zipf, 4, s, device=CPU)
    store = PreparedStore()
    p = plan_sharded("spmv", (sst,), store=store, device=CPU)
    assert p.schedule == s and p.operands[0] is sst
    assert "matvec_shards_stacked" not in {k[0] for k in store._entries}
    x = _x(zipf.shape[1])
    np.testing.assert_allclose(p.execute(x).numpy(), zipf.to_dense() @ x,
                               **TOL)


@pytest.mark.parametrize("op", ["spmv", "spmm"])
def test_uniform_shards_share_one_x(zipf, monkeypatch, op):
    """The stacked launch takes one x expanded over the shards (member
    stride 0), not a copy per shard."""
    seen = []
    real = ops_builtin._exec_matvec_stacked

    def spy(arrays, xs, layout, backend):
        seen.append(xs.stride(0))
        return real(arrays, xs, layout, backend)

    monkeypatch.setattr(ops_builtin, "_exec_matvec_stacked", spy)
    x = _x(zipf.shape[1], k=5 if op == "spmm" else None)
    y = plan_sharded(op, (zipf,), n_shards=4,
                     schedule=Schedule("bsr", 32, 1.0),
                     device=CPU).execute(x).numpy()
    assert seen == [0]
    np.testing.assert_allclose(y, zipf.to_dense() @ x, **TOL)


def test_partition_store_entry_bytes_accounted(zipf):
    store = PreparedStore()
    plan_sharded("spmv", (zipf,), n_shards=2,
                 schedule=Schedule("bsr", 32, 1.0), store=store, device=CPU)
    key = ("row_partition", content_key(zipf), 2, "nnz")
    assert key in store
    _, nbytes = store._entries[key]
    assert nbytes >= zipf.col_idxs.nbytes + zipf.nnz_vals.nbytes


def test_plan_sharded_with_tuner(zipf, services):
    svc, jsvc = services
    p = plan_sharded("spmv", (zipf,), n_shards=2, selector=svc.tuner,
                     device=CPU)
    jp = jplan_sharded("spmv", (_pair(zipf),), n_shards=2,
                       selector=jsvc.tuner, backend="jnp")
    assert {pr["source"] for pr in p.shard_provenance} == {"tuner"}
    assert [dataclasses.asdict(pr["schedule"]) for pr in p.shard_provenance] \
        == [dataclasses.asdict(pr["schedule"]) for pr in jp.shard_provenance]
    x = _x(zipf.shape[1])
    np.testing.assert_allclose(p.execute(x).numpy(), zipf.to_dense() @ x,
                               **TOL)


def test_select_shards_one_decision_per_shard_like_jax(zipf, services):
    svc, jsvc = services
    part = partition_rows(zipf, 4)
    t0, jt0 = svc.telemetry(), jsvc.telemetry()
    decs = svc.select_shards(part.slice(zipf), name="s")
    jdecs = jsvc.select_shards(jpartition_rows(_pair(zipf), 4)
                               .slice(_pair(zipf)), name="s")
    assert [d.name for d in decs] == ["s0", "s1", "s2", "s3"]
    for d, jd in zip(decs, jdecs):
        assert (d.name, d.source, d.fingerprint_key) == (
            jd.name, jd.source, jd.fingerprint_key)
        assert dataclasses.asdict(d.schedule) == dataclasses.asdict(
            jd.schedule)
    t1, jt1 = svc.telemetry(), jsvc.telemetry()
    for key, n in (("shard_requests", 4), ("sharded_plans", 1),
                   ("requests", 4)):
        assert t1[key] - t0[key] == jt1[key] - jt0[key] == n


# ------------------------------------------------------- sharded container

def test_sharded_tensor_roundtrip(zipf):
    """The port's container is a plain class: ``to`` keeps meta and
    schedules, and a prebuilt sharded operand plans without
    re-partitioning (the JAX test's pytree round trip)."""
    sst = ShardedSparseTensor.from_csr(zipf, 3, Schedule("bsr", 32, 1.0),
                                       device=CPU)
    sst2 = sst.to(CPU)
    assert sst2.meta == sst.meta and sst2.n_shards == 3
    assert sst2.schedules() == sst.schedules()
    assert all(a is b for a, b in zip(sst2.shards, sst.shards))
    jsst = JShardedSparseTensor.from_csr(_pair(zipf), 3,
                                         _js(Schedule("bsr", 32, 1.0)))
    assert sst.bounds == jsst.bounds and sst.shard_rows() == \
        jsst.shard_rows()
    x = _x(zipf.shape[1])
    y = plan_sharded("spmv", (sst2,), device=CPU).execute(x).numpy()
    np.testing.assert_allclose(y, zipf.to_dense() @ x, **TOL)


def test_sharded_tensor_shard_rows_match_bounds(zipf):
    sst = ShardedSparseTensor.from_csr(zipf, 4, strategy="nnz", device=CPU)
    assert sum(sst.shard_rows()) == zipf.n_rows
    for st, rows in zip(sst.shards, sst.shard_rows()):
        assert st.true_shape[0] == rows


@pytest.mark.parametrize("layout", ["ell", "sell"])
def test_sharded_tensor_carried_across_gives_jax_output(zipf, layout):
    s = _sched(layout)
    jsst = JShardedSparseTensor.from_csr(_pair(zipf), 3, _js(s))
    shards = []
    for jst in jsst.shards:
        meta = dataclasses.asdict(jst.meta)
        meta["true_shape"] = jst.true_shape
        meta["zero_idx"] = jst._zero_idx
        shards.append((meta, {k: np.asarray(v)
                              for k, v in jst.arrays.items()}))
    sst = convert.sharded_tensor_from_arrays(
        dataclasses.asdict(jsst.meta), shards, device=CPU)
    assert sst.bounds == jsst.bounds and sst.shape == jsst.shape
    assert sst.schedules() == tuple(s for _ in range(3))
    own = ShardedSparseTensor.from_csr(zipf, 3, s, device=CPU)
    for (_, leaves), st, ost in zip(shards, sst.shards, own.shards):
        assert st.true_shape == ost.true_shape
        # the JAX leaves; the SELL pointer and counts are derived, and a
        # bucketed JAX container does not say where its live cells end
        for k in leaves:
            np.testing.assert_array_equal(st.arrays[k].numpy(),
                                          ost.arrays[k].numpy())
    x = _x(zipf.shape[1])
    y = plan_sharded("spmv", (sst,), device=CPU).execute(x).numpy()
    jy = np.asarray(jplan_sharded("spmv", (jsst,),
                                  backend="jnp").execute(x))
    np.testing.assert_allclose(y, jy, **TOL)


# ----------------------------------------------------- store save / load

def test_prepared_store_save_load_roundtrip(tmp_path, zipf):
    store = PreparedStore()
    for _ in range(2):
        plan_sharded("spmv", (zipf,), n_shards=2,
                     schedule=Schedule("bsr", 32, 1.0), store=store,
                     device=CPU)
    path = str(tmp_path / "store.json")
    assert store.save(path)
    fresh = PreparedStore()
    prior = fresh.load(path)
    assert len(prior["entries"]) == len(store)
    tel = fresh.telemetry()
    assert tel["prior_entries"] == float(len(store))
    assert tel["prior_hit_rate"] == pytest.approx(
        store.telemetry()["hit_rate"])
    assert fresh.hits == 0 and len(fresh) == 0


def test_prepared_store_load_missing_and_stale(tmp_path):
    store = PreparedStore()
    assert store.load(str(tmp_path / "absent.json")) == {}
    stale = tmp_path / "stale.json"
    stale.write_text('{"version": 999, "entries": []}')
    assert store.load(str(stale)) == {}
    assert "prior_entries" not in store.telemetry()


# ------------------------------------------------------------ the device

def test_plan_sharded_defaults_to_the_card(zipf):
    """The card is the default; without one and without ``device="cpu"``
    the entry point raises, and nothing falls back to the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this checks the no-card refusal")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        plan_sharded("spmv", (zipf,), n_shards=2,
                     schedule=Schedule("bsr", 32, 1.0))
    p = plan_sharded("spmv", (zipf,), schedule=Schedule("bsr", 32, 1.0),
                     device=CPU)
    assert p.n_shards == 1            # one shard per card; the CPU is one
