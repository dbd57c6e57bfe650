"""The port's SpChar selector held against the JAX package's: the static
metrics, the schedule counters and the cost model (float64 numpy in both,
rtol 1e-12); a tree and a ``ScheduleTuner`` fit on the same corpus and
the same platform record (the JAX package's ``TPU_V5E`` figures, carried
across as data) with the same features, simulations, predictions and
picks; the fingerprint keys; one ``SelectorService`` request stream with
the same decisions and counters and outputs within 2e-5; a cache file
written by either package loading in the other; ``plan(selector=...)``
provenance; and the serve CLI on the CPU. Everything runs on the CPU at
small sizes; the JAX facade runs its ``jnp`` backend."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.core as J
from repro.core import autotune as jautotune
from repro.selector import ScheduleCache as JScheduleCache
from repro.selector import SelectorService as JSelectorService
from repro.selector import fingerprint as jfingerprint
from repro.sparse import plan as jplan
from repro.sparse import resilience as jres
from repro_torch import core as T
from repro_torch.core import autotune
from repro_torch.selector import (CACHE_FORMAT_VERSION, ScheduleCache,
                                  SchedulePredictor, SelectorService,
                                  fingerprint, routing_fingerprint)
from repro_torch.sparse import plan, reset_resilience

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
TOL = dict(rtol=2e-5, atol=2e-5)
EXACT = dict(rtol=1e-12, atol=0.0)
# the JAX package's TPU v5e figures, carried across as data
V5E = T.Platform(**dataclasses.asdict(J.TPU_V5E))
# the port's NVIDIA records, carried across to the reference as data
JH100 = J.Platform(**dataclasses.asdict(T.H100_SXM))
JA100 = J.Platform(**dataclasses.asdict(T.A100_SXM))
JL40S = J.Platform(**dataclasses.asdict(T.L40S))
GENS = sorted(T.GENERATORS) + ["zipf"]


@pytest.fixture(autouse=True)
def _fresh_resilience():
    reset_resilience()
    jres.reset_resilience()
    yield
    reset_resilience()
    jres.reset_resilience()


def _gen(pkg, name, n=384, seed=2):
    if name == "zipf":
        return pkg.gen_zipf(n, seed=seed) if pkg is T else \
            J.synthetic.gen_zipf(n, seed=seed)
    return pkg.GENERATORS[name](n, seed=seed)


def _jcsr(csr):
    return J.CSR(csr.row_ptrs, csr.col_idxs, csr.nnz_vals, csr.shape)


def _assert_dicts_close(a, b):
    assert list(a) == list(b)
    np.testing.assert_allclose([a[k] for k in a], [b[k] for k in b], **EXACT)


# ---------------------------------------------- metrics, counters, model

@pytest.mark.parametrize("name", GENS)
def test_characterize_and_fingerprint_like_jax(name):
    A, jA = _gen(T, name), _gen(J, name)
    np.testing.assert_array_equal(A.col_idxs, jA.col_idxs)
    _assert_dicts_close(T.characterize(A), J.characterize(jA))
    fp, jfp = fingerprint(A), jfingerprint(jA)
    assert (fp.key, fp.canonical, fp.shape, fp.nnz) == (
        jfp.key, jfp.canonical, jfp.shape, jfp.nnz)


@pytest.mark.parametrize("name", GENS)
@pytest.mark.parametrize("platform", ["h100", "v5e", "a100", "l40s"])
def test_counters_and_modeled_time_like_jax(name, platform):
    p, jp = {"h100": (T.H100_SXM, JH100), "v5e": (V5E, J.TPU_V5E),
             "a100": (T.A100_SXM, JA100), "l40s": (T.L40S, JL40S)}[platform]
    A, jA = _gen(T, name, n=256), _gen(J, name, n=256)
    for bs in (32, 128):
        _assert_dicts_close(T.spmv_counters(A, p, bs, 0.95),
                            J.spmv_counters(jA, jp, bs, 0.95))
        _assert_dicts_close(T.sell_spmv_counters(A, p, bs, 8),
                            J.sell_spmv_counters(jA, jp, bs, 8))
    _assert_dicts_close(T.spgemm_counters(A, A, p, 64),
                        J.spgemm_counters(jA, jA, jp, 64))
    for kernel in ("spmv", "spgemm", "spadd"):
        for s in autotune.candidate_schedules(8)[::5]:
            js = jautotune.Schedule(**dataclasses.asdict(s))
            t = autotune._modeled_time(kernel, A, p, s)
            jt = jautotune._modeled_time(kernel, jA, jp, js)
            np.testing.assert_allclose(t, jt, **EXACT)


def test_candidate_grid_and_features_like_jax():
    for n_rhs in (1, 8):
        got = [dataclasses.asdict(s)
               for s in autotune.candidate_schedules(n_rhs)]
        want = [dataclasses.asdict(s)
                for s in jautotune.candidate_schedules(n_rhs)]
        assert got == want
    assert autotune.CFG_FEATURES == jautotune.CFG_FEATURES
    assert autotune.DENSE_DENSITY_THRESHOLD == \
        jautotune.DENSE_DENSITY_THRESHOLD
    assert T.FEATURE_NAMES == J.FEATURE_NAMES
    assert list(T.PLATFORMS.items()) == [
        ("a100_sxm", T.A100_SXM), ("h100_sxm", T.H100_SXM), ("l40s", T.L40S)]


# ------------------------------------------------------- tree and tuner

TRAIN = dict(n_matrices=27, n_min=256, n_max=768, seed=3)
HELD = dict(n_matrices=9, n_min=256, n_max=768, seed=91,
            include_synthetic=False)


@pytest.fixture(scope="module")
def tuners():
    """(port tuner, JAX tuner), both fit on the same corpus and the v5e
    figures, and the held-out corpus in both packages."""
    t = T.ScheduleTuner("spmv", V5E).fit(T.corpus(**TRAIN), max_mats=27)
    j = J.ScheduleTuner("spmv", J.TPU_V5E).fit(J.corpus(**TRAIN),
                                               max_mats=27)
    return t, j, T.corpus(**HELD), J.corpus(**HELD)


def test_tuner_fit_like_jax(tuners):
    t, j, _, _ = tuners
    assert t.feature_names == j.feature_names
    assert t.fit_simulations_ == j.fit_simulations_
    np.testing.assert_array_equal(t._train_rows, j._train_rows)
    np.testing.assert_allclose(t._train_ys, j._train_ys, **EXACT)
    np.testing.assert_array_equal(t.tree.feature_importances_,
                                  j.tree.feature_importances_)


def test_tuner_predictions_and_picks_like_jax(tuners):
    t, j, held, jheld = tuners
    for (name, _, A), (_, _, jA) in zip(held, jheld):
        static, jstatic = T.characterize(A), J.characterize(jA)
        for s in autotune.candidate_schedules():
            js = jautotune.Schedule(**dataclasses.asdict(s))
            assert t.predict_time(static, s) == j.predict_time(jstatic, js)
        (s, info), (js, jinfo) = t.select(A), j.select(jA)
        assert dataclasses.asdict(s) == dataclasses.asdict(js), name
        assert info == jinfo
        pred = SchedulePredictor(t).predict(fingerprint(A))
        assert pred.schedule in autotune.candidate_schedules()
        assert 0.0 <= pred.confidence <= 1.0


def test_tree_and_kfold_like_jax():
    rng = np.random.default_rng(4)
    X = rng.standard_normal((120, 5))
    y = X[:, 0] * 2 + np.sin(X[:, 1]) + 0.1 * rng.standard_normal(120)
    tree = T.DecisionTreeRegressor(max_depth=6).fit(X, y)
    jtree = J.DecisionTreeRegressor(max_depth=6).fit(X, y)
    np.testing.assert_array_equal(tree.predict(X), jtree.predict(X))
    assert T.kfold_cv(X, y, k=5, max_depth=4) == \
        J.kfold_cv(X, y, k=5, max_depth=4)


# ------------------------------------------------------------ service

def _stream(svc, mats, rng_seed=0, n_rhs=1):
    """Two ticks of requests: every matrix, with an RHS, twice."""
    rng = np.random.default_rng(rng_seed)
    xs = []
    for rep in range(2):
        for name, _, A in mats:
            x = rng.standard_normal(
                A.shape[1] if n_rhs == 1 else (A.shape[1], n_rhs)).astype(
                np.float32)
            xs.append(x)
            svc.submit(f"{rep}:{name}", A, x)
    return xs


SERVICE_KEYS = ("requests", "cache_hits", "tree_served", "verify_fallbacks",
                "batches", "buckets", "executed", "stacked_launches",
                "ticks", "fp_memo_hits", "negative_examples", "shed_requests",
                "quarantine_blocked", "cache_entries", "cache_hit_rate",
                "fallback_fraction", "mean_bucket_size", "max_bucket_size",
                "retraining_examples", "guard_fallbacks", "guard_nan_trips",
                "guard_dense_served", "quarantine_entries", "degraded")


@pytest.mark.parametrize("threshold", [0.0, 0.02])
def test_service_stream_like_jax(tuners, threshold):
    """One request stream through both services: the same decisions per
    request (source, schedule, fingerprint key, confidence), the same
    counters (timing fields aside), outputs within 2e-5."""
    t, j, held, jheld = tuners
    svc = SelectorService(t, confidence_threshold=threshold, batch_max=6,
                          device=CPU)
    jsvc = JSelectorService(j, confidence_threshold=threshold, batch_max=6)
    xs = _stream(svc, held[:5])
    _stream(jsvc, jheld[:5])
    decs, jdecs = svc.run(), jsvc.run(backend="jnp")
    assert len(decs) == len(jdecs) == len(xs)
    for d, jd in zip(decs, jdecs):
        assert (d.name, d.source, dataclasses.asdict(d.schedule),
                d.fingerprint_key, d.confidence, d.batch_id, d.bucket) == (
            jd.name, jd.source, dataclasses.asdict(jd.schedule),
            jd.fingerprint_key, jd.confidence, jd.batch_id, jd.bucket)
        assert d.modeled_time_s == jd.modeled_time_s
        assert isinstance(d.y, np.ndarray)
        np.testing.assert_allclose(d.y, np.asarray(jd.y), **TOL)
        assert d.measured_ms is not None and d.measured_ms > 0
    tel, jtel = svc.telemetry(), jsvc.telemetry()
    for key in SERVICE_KEYS:
        assert tel[key] == jtel[key], key
    assert tel["cache_hits"] >= 5 and tel["executed"] == len(xs)


def test_service_spmm_requests_like_jax(tuners):
    t, j, held, jheld = tuners
    tt = T.ScheduleTuner("spmv", V5E, n_rhs=8)
    tt.tree, tt.feature_names = t.tree, t.feature_names
    jt = J.ScheduleTuner("spmv", J.TPU_V5E, n_rhs=8)
    jt.tree, jt.feature_names = j.tree, j.feature_names
    svc = SelectorService(tt, confidence_threshold=0.0, device=CPU)
    jsvc = JSelectorService(jt, confidence_threshold=0.0)
    _stream(svc, held[5:8], n_rhs=8)
    _stream(jsvc, jheld[5:8], n_rhs=8)
    for d, jd in zip(svc.run(), jsvc.run(backend="jnp")):
        assert d.schedule.n_rhs == 8
        assert dataclasses.asdict(d.schedule) == dataclasses.asdict(
            jd.schedule)
        assert d.y.shape == np.asarray(jd.y).shape
        np.testing.assert_allclose(d.y, np.asarray(jd.y), **TOL)


def test_service_state_round_trips_like_jax(tuners):
    t, j, held, jheld = tuners
    svc = SelectorService(t, confidence_threshold=2.0, device=CPU)
    jsvc = JSelectorService(j, confidence_threshold=2.0)
    for s, mats in ((svc, held), (jsvc, jheld)):
        s.select(mats[0][2])
        s.quarantine.add("spmv", "torch", s.select(mats[1][2]).schedule)
    state, jstate = svc.export_state(), jsvc.export_state()
    assert json.dumps(state, sort_keys=True) == json.dumps(jstate,
                                                           sort_keys=True)
    fresh = SelectorService(t, device=CPU)
    fresh.restore_state(json.loads(json.dumps(state)))
    assert fresh.export_state() == state
    assert fresh.refit(min_examples=1)["refit"] == 1.0
    decs = svc.select_shards([held[0][2]])
    jdecs = jsvc.select_shards([jheld[0][2]])
    assert [dataclasses.asdict(d.schedule) for d in decs] == \
        [dataclasses.asdict(d.schedule) for d in jdecs]
    for key in ("shard_requests", "sharded_plans"):
        assert svc.telemetry()[key] == jsvc.telemetry()[key] == 1


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_cache_file_loads_in_the_other_package(tmp_path, writer):
    path = str(tmp_path / "sched.json")
    A = _gen(T, "zipf", n=320, seed=4)
    sched = T.Schedule("bsr", 128, 1.0, layout="sell", slice_height=8,
                       n_rhs=4)
    Cw, Cr = ((ScheduleCache, JScheduleCache) if writer == "port"
              else (JScheduleCache, ScheduleCache))
    fpw = fingerprint(A) if writer == "port" else jfingerprint(_jcsr(A))
    fpr = jfingerprint(_jcsr(A)) if writer == "port" else fingerprint(A)
    sw = sched if writer == "port" else jautotune.Schedule(
        **dataclasses.asdict(sched))
    cache = Cw(path=path, context="spmv:h100_sxm:rhs4")
    cache.put(fpw, sw, "verify", 2.5e-4)
    assert cache.flush()
    with open(path) as f:
        assert json.load(f)["version"] == CACHE_FORMAT_VERSION == 2
    reread = Cr(path=path, context="spmv:h100_sxm:rhs4")
    assert dataclasses.asdict(reread.get(fpr)) == dataclasses.asdict(sched)
    assert reread.telemetry()["corrupt_entries"] == 0
    assert reread.export_state()["entries"][0]["source"] == "verify"


def test_cache_written_under_one_record_is_not_read_under_another(tmp_path):
    """A cache file carries the tuner's ``kernel:platform:rhs`` context:
    reopened under the record it was written for it serves the pick, under
    either other record a miss (counted), never another card's pick."""
    mats = T.corpus(n_matrices=9, n_min=256, n_max=384, seed=3)
    tuners = {n: T.ScheduleTuner("spmv", p).fit(mats, max_mats=6)
              for n, p in T.PLATFORMS.items()}
    A = _gen(T, "zipf", n=320, seed=4)
    for writer, wt in tuners.items():
        path = str(tmp_path / f"{writer}.json")
        svc = SelectorService(wt, cache=ScheduleCache(path=path),
                              confidence_threshold=0.0, device=CPU)
        assert [svc.select(A).source for _ in range(2)] == ["tree", "cache"]
        assert svc.cache.context == f"spmv:{writer}:rhs1"
        assert svc.cache.flush()
        for reader, rt in tuners.items():
            cache = ScheduleCache(path=path)
            dec = SelectorService(rt, cache=cache, confidence_threshold=0.0,
                                  device=CPU).select(A)
            if reader == writer:
                assert (dec.source, cache.context_misses) == ("cache", 0)
            else:
                assert (dec.source, cache.context_misses) == ("tree", 1)


def test_moe_tiles_are_cached_per_record():
    """One ``ScheduleCache`` shared by the three records: the routing
    fingerprint holds the platform's name, so each record's first lookup
    of a histogram misses and its second hits its own entry."""
    from repro_torch.sparse import moe_tile_schedule
    counts = np.array([1500.0] + [10.0] * 15)
    cache = ScheduleCache()
    keys = {n: routing_fingerprint(counts, 512, n).key for n in T.PLATFORMS}
    assert len(set(keys.values())) == len(T.PLATFORMS)
    for n, p in T.PLATFORMS.items():
        misses = cache.misses
        first = moe_tile_schedule(counts, 512, p, cache=cache)
        assert cache.misses == misses + 1
        assert moe_tile_schedule(counts, 512, p, cache=cache) == first
        assert cache.misses == misses + 1
        assert first.block_size == T.select_moe_block_size(counts, 512, p)
    assert len(cache) == len(T.PLATFORMS)


# ---------------------------------------------------- plan(selector=...)

def test_plan_selector_provenance_like_jax(tuners):
    t, j, held, jheld = tuners
    svc = SelectorService(t, confidence_threshold=0.0, device=CPU)
    jsvc = JSelectorService(j, confidence_threshold=0.0)
    A, jA = held[2][2], jheld[2][2]
    x = np.random.default_rng(5).standard_normal(A.shape[1]).astype(
        np.float32)
    for _ in range(2):                     # tree, then cache
        p = plan("spmv", A, selector=svc, device=CPU)
        jp = jplan("spmv", jA, selector=jsvc, backend="jnp")
        assert (p.source, p.fingerprint_key, p.confidence,
                p.modeled_time_s) == (jp.source, jp.fingerprint_key,
                                      jp.confidence, jp.modeled_time_s)
        assert dataclasses.asdict(p.schedule) == dataclasses.asdict(
            jp.schedule)
        np.testing.assert_allclose(p.execute(x).numpy(),
                                   np.asarray(jp.execute(x)), **TOL)
    assert p.source == "selector-cache"
    assert len(svc.prepared_store) == 1 and svc.prepared_store.hits == 1
    # the tuner path, and its requarantine
    p = plan("spmv", A, selector=t, device=CPU)
    jp = jplan("spmv", jA, selector=j, backend="jnp")
    assert (p.source, p.modeled_time_s) == ("tuner", jp.modeled_time_s)
    svc.executor.quarantine.add("spmv", "torch", p.schedule)
    jres.default_quarantine().add("spmv", "jnp", jp.schedule)
    p2 = plan("spmv", A, selector=t, device=CPU)
    jp2 = jplan("spmv", jA, selector=j, backend="jnp")
    assert p2.source == jp2.source == "tuner-requarantined"
    assert dataclasses.asdict(p2.schedule) == dataclasses.asdict(
        jp2.schedule)
    with pytest.raises(TypeError, match="needs a CSR first operand"):
        plan("spmv", p.operands[0], selector=svc, device=CPU)


def test_plan_records_the_residual(tuners):
    from repro_torch.obs import default_registry
    t, _, held, _ = tuners
    svc = SelectorService(t, confidence_threshold=0.0, device=CPU)
    A = held[3][2]
    reg = default_registry()
    before = reg.snapshot().get("residual_log10.spmv.count", 0.0)
    p = plan("spmv", A, selector=svc, device=CPU)
    p.execute(np.ones(A.shape[1], np.float32))
    after = reg.snapshot().get("residual_log10.spmv.count", 0.0)
    assert p.modeled_time_s and after == before + 1


def test_serve_cli_on_the_cpu(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.selector.serve", "--device",
         "cpu", "--execute", "--requests", "12", "--train-mats", "9",
         "--serve-mats", "5", "--n-max", "384", "--batch", "4",
         "--cache-path", str(tmp_path / "cache.json")],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr
    assert "12 checked, 0 mismatches" in out.stdout
    assert "fallbacks 0  nan trips 0" in out.stdout
    assert (tmp_path / "cache.json").exists()
