"""The port's guarded execution held against the JAX package's
(``repro.sparse.resilience``): the ladder torch -> dense under injected
launch faults gives the JAX facade's outputs for all six ops and a bucket;
a NaN or Inf in the operands raises ``NonFiniteOutput`` in both packages
with the same failure ledger; the dense rung is lazy and capped; the
quarantine's TTL, skips and last-rung overrides are counted; a failed
build degrades to the dense reference; corrupt, truncated and faulted
cache and store files are survived and counted; ``with_backoff``,
``Deadline``, ``output_finite`` and the fault injector's draws. Everything
runs on the CPU at small sizes; the JAX facade runs its ``jnp`` backend.
Tolerance against the JAX facade: rtol = atol = 2e-5
(``tests/test_kernels.py``)."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.core import CSR as JCSR
from repro.core.autotune import Schedule as JSchedule
from repro.sparse import plan as jplan
from repro.sparse import plan_bucket as jplan_bucket
from repro.sparse import resilience as jres
from repro_torch.core import CSR, Schedule
from repro_torch.selector import ScheduleCache, fingerprint
from repro_torch.sparse import (Deadline, FaultInjector, GuardedExecutor,
                                NonFiniteOutput, Plan, PreparedStore,
                                Quarantine, SparseTensor, default_executor,
                                default_quarantine, install_injector,
                                output_finite, plan, plan_bucket,
                                register_op, reset_resilience, with_backoff)
from repro_torch.sparse import ops_builtin, resilience
from repro_torch.sparse.registry import _REGISTRY

CPU = "cpu"
TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True)
def _fresh_resilience():
    """No injector and empty default executors/quarantines in either
    package, before and after every test."""
    reset_resilience()
    jres.reset_resilience()
    yield
    reset_resilience()
    jres.reset_resilience()


def _dense(n, m, density, seed):
    rng = np.random.default_rng(seed)
    d = (rng.random((n, m)) < density) * rng.standard_normal((n, m))
    return d.astype(np.float32)


def _pair(d):
    """The same matrix as a port CSR and a JAX-package CSR."""
    return CSR.from_dense(d), JCSR.from_dense(d)


def _case(name, bad=None):
    """(op, port operands, JAX operands, runtime inputs, port Schedule,
    JAX Schedule, planner kwargs) of one op at a small size. ``bad`` puts
    that value into one runtime input or operand value."""
    rng = np.random.default_rng(7)
    if name in ("spmv", "spmm"):
        a, ja = _pair(_dense(96, 80, 0.08, 0))
        x = rng.standard_normal(80 if name == "spmv" else (80, 4)).astype(
            np.float32)
        if bad is not None:
            x[(3,) if name == "spmv" else (3, 1)] = bad
        return (name, (a,), (ja,), (x,), Schedule("bsr", 32, 1.0),
                JSchedule("bsr", 32, 1.0), {})
    if name in ("spgemm", "spadd"):
        da, db = _dense(64, 64, 0.1, 3), _dense(64, 64, 0.1, 4)
        if bad is not None:
            da[np.nonzero(da)[0][5], np.nonzero(da)[1][5]] = bad
        (a, ja), (b, jb) = _pair(da), _pair(db)
        return (name, (a, b), (ja, jb), (), Schedule("bsr", 32, 1.0),
                JSchedule("bsr", 32, 1.0), {})
    if name == "moe_gmm":
        te = np.array([0, 1, 0], np.int32)
        x = rng.standard_normal((12, 8)).astype(np.float32)
        w = rng.standard_normal((2, 8, 16)).astype(np.float32)
        if bad is not None:
            w[1, 2, 3] = bad
        return (name, (te,), (te,), (x, w), None, None,
                dict(tile_m=4, tile_n=16, tile_k=8))
    q, k, v = (rng.standard_normal((2, 16, 8)).astype(np.float32)
               for _ in range(3))
    if bad is not None:
        q[1, 5, 2] = bad
    return ("flash_attention", (), (), (q, k, v), None, None,
            dict(block_q=8, block_k=8))


def _host(out):
    """An op output as host numpy: dense for spgemm/spadd results."""
    if isinstance(out, SparseTensor):
        return out.to_host().to_dense()
    if isinstance(out, torch.Tensor):
        return out.numpy()
    if hasattr(out, "to_dense"):
        return np.asarray(out.to_dense())
    return np.asarray(out)


OPS = ["spmv", "spmm", "spgemm", "spadd", "moe_gmm", "flash_attention"]


# ------------------------------------------------- the ladder torch -> dense

@pytest.mark.parametrize("name", OPS)
def test_launch_faults_fall_to_dense_like_jax(name):
    """Every launch check fires: the torch rung fails, its combo enters
    the quarantine, and the dense rung serves what the JAX facade's jnp
    backend computes, as the same type on the plan's device."""
    op, ops_t, ops_j, rt, s, js, kw = _case(name)
    want = _host(jplan(op, ops_j, schedule=js, backend="jnp",
                       **kw).execute(*rt))
    install_injector(FaultInjector(1.0, seed=0, sites=("launch",)))
    p = plan(op, ops_t, schedule=s, device=CPU, **kw)
    assert p.backend == "torch"
    out = p.execute(*rt)
    assert p.backend == "dense"
    assert isinstance(out, SparseTensor if op in ("spgemm", "spadd")
                      else torch.Tensor)
    if isinstance(out, SparseTensor):
        assert out.layout == "bsr" and out.device.type == CPU
    np.testing.assert_allclose(_host(out), want, **TOL)
    ex = default_executor()
    assert ex.fallbacks[op] == 1 and ex.dense_served == 1
    assert ex.telemetry()["exhausted"] == 0
    entry, = default_quarantine().entries()
    assert (entry["op"], entry["backend"], entry["schedule"]) == (
        op, "torch", s)
    inj = resilience.injector()
    assert inj.fired["launch"] == inj.recovered_counts["launch"] == 1
    # the plan stays on its rung: the next launch is served dense again
    np.testing.assert_allclose(_host(p.execute(*rt)), want, **TOL)
    assert ex.fallbacks[op] == 1 and ex.dense_served == 2


@pytest.mark.parametrize("op", ["spmv", "spgemm"])
def test_bucket_launch_faults_fall_to_dense_like_jax(op):
    """A bucket falls as one: every member from its own dense reference,
    equal to the JAX facade's bucket."""
    dense = [_dense(70 + 9 * i, 60 if op == "spmv" else 70 + 9 * i, 0.1,
                    10 + i) for i in range(3)]
    mats = [_pair(d) for d in dense]
    if op == "spmv":
        members, jmembers = [m for m, _ in mats], [j for _, j in mats]
        rt = ([np.random.default_rng(20 + i).standard_normal(60).astype(
            np.float32) for i in range(3)],)
    else:
        members = [(m, m) for m, _ in mats]
        jmembers = [(j, j) for _, j in mats]
        rt = ()
    want = [_host(y) for y in jplan_bucket(
        op, jmembers, JSchedule("bsr", 64, 1.0), backend="jnp").execute(*rt)]
    install_injector(FaultInjector(1.0, seed=0, sites=("launch",)))
    p = plan_bucket(op, members, Schedule("bsr", 64, 1.0), device=CPU)
    got = p.execute(*rt)
    assert p.backend == "dense" and p.n_members == 3
    for y, w in zip(got, want):
        np.testing.assert_allclose(_host(y), w, **TOL)
    assert default_executor().fallbacks[op] == 1
    assert default_executor().dense_served == 1


# ------------------------------------------------ NaN guard (Queue C note 2)

def _ledger(ex):
    tel = ex.telemetry()
    return {k: tel[k] for k in ("fallbacks", "nan_trips", "dense_served",
                                "exhausted", "quarantine_skips",
                                "quarantine_overrides")}


def _entries(q):
    return sorted((e["op"], json.dumps(dataclasses.asdict(e["schedule"])
                                       if e["schedule"] is not None else None))
                  for e in q.entries())


@pytest.mark.parametrize("name", OPS)
@pytest.mark.parametrize("bad", [np.nan, np.inf])
def test_nonfinite_operands_raise_like_jax(name, bad):
    """With NaN or Inf in the operands, the default (guarded) plan of both
    packages raises NonFiniteOutput after the same trips: the first rung
    trips, its combo is quarantined, the dense rung trips too and the
    chain is exhausted."""
    op, ops_t, ops_j, rt, s, js, kw = _case(name, bad=bad)
    with pytest.raises(jres.NonFiniteOutput):
        jplan(op, ops_j, schedule=js, backend="jnp", **kw).execute(*rt)
    with pytest.raises(NonFiniteOutput):
        plan(op, ops_t, schedule=s, device=CPU, **kw).execute(*rt)
    assert _ledger(default_executor()) == _ledger(jres.default_executor())
    assert _ledger(default_executor())["nan_trips"] == 2
    assert _ledger(default_executor())["exhausted"] == 1
    assert _entries(default_quarantine()) == _entries(
        jres.default_quarantine())
    assert [e["backend"] for e in default_quarantine().entries()] == ["torch"]


def test_nan_guard_off_returns_the_nonfinite_output():
    op, ops_t, _, rt, s, _, kw = _case("spmv", bad=np.nan)
    ex = GuardedExecutor(nan_guard=False)
    y = plan(op, ops_t, schedule=s, device=CPU, executor=ex,
             **kw).execute(*rt)
    assert torch.isnan(y).any()
    assert sum(ex.telemetry().values()) == 0


def test_nan_guard_env_opt_out(monkeypatch):
    monkeypatch.setenv("REPRO_NAN_GUARD", "0")
    assert GuardedExecutor().nan_guard is False
    monkeypatch.setenv("REPRO_NAN_GUARD", "1")
    assert GuardedExecutor().nan_guard is True
    assert GuardedExecutor(nan_guard=False).nan_guard is False


# ------------------------------------------------------ the dense rung

def test_dense_rung_is_lazy(monkeypatch):
    """plan() densifies nothing: the dense copy is built only when the
    guard falls to the dense rung, once per plan."""
    calls = []
    orig = ops_builtin._dense_of
    monkeypatch.setattr(ops_builtin, "_dense_of",
                        lambda a: (calls.append(1), orig(a))[1])
    d = _dense(64, 64, 0.1, 0)
    A = CSR.from_dense(d)
    x = np.ones(64, np.float32)
    plan("spmv", A, device=CPU).execute(x)
    assert calls == []
    install_injector(FaultInjector(1.0, seed=0, sites=("launch",)))
    p = plan("spmv", A, device=CPU)
    assert calls == []
    y = p.execute(x)
    assert len(calls) == 1
    p.execute(x)
    assert len(calls) == 1
    np.testing.assert_allclose(y.numpy(), d @ x, **TOL)


def test_dense_rung_size_cap(monkeypatch):
    """Over the cap there is no dense rung: the chain ends at torch, and a
    fault there exhausts it."""
    monkeypatch.setenv("REPRO_DENSE_REF_MAX_ELEMS", "100")
    A = CSR.from_dense(_dense(64, 64, 0.1, 1))
    assert resilience.make_dense_run("spmv", (A,), None,
                                     {"device": torch.device(CPU)}) is None
    x = np.ones(64, np.float32)
    np.testing.assert_allclose(plan("spmv", A, device=CPU).execute(x),
                               A.to_dense() @ x, **TOL)
    install_injector(FaultInjector(1.0, seed=0, sites=("launch",)))
    with pytest.raises(resilience.InjectedFault):
        plan("spmv", A, device=CPU).execute(x)
    assert default_executor().exhausted == 1


def test_chain_from_the_card_and_the_cpu():
    """On the CPU a plan walks torch -> dense; on the card the chain is
    the plan's own rung and there is no dense rung to build."""
    ex = GuardedExecutor()
    assert ex.chain_from("torch", True) == ["torch", "dense"]
    assert ex.chain_from("torch", False) == ["torch"]
    assert ex.chain_from("cuda", True, on_card=True) == ["cuda"]
    assert ex.chain_from("torch", True, on_card=True) == ["torch"]
    A = CSR.from_dense(_dense(64, 64, 0.1, 1))
    card = {"device": torch.device("cuda", 0)}
    assert resilience.make_dense_run("spmv", (A,), None, card) is None
    assert resilience.make_dense_bucket_run("spmv", [A], None, card) is None
    assert resilience.make_dense_run(
        "spmv", (A,), None, {"device": torch.device(CPU)}) is not None
    assert resilience.FALLBACK_CHAIN == ("cuda", "torch", "dense")
    assert resilience.GUARDED_EXCEPTIONS == jres.GUARDED_EXCEPTIONS


@pytest.mark.parametrize("fault", ["raise", "nan"])
def test_guard_on_card_raises_and_keeps_the_kernel(fault):
    """A plan on the card (its device is "cuda"; the stand-in run below
    takes the kernel's place, so nothing touches a card) has a chain of
    one rung: a failed or non-finite launch is counted, the combo
    quarantined and the error raised; neither the rebuild one rung down
    nor a dense rung is ever called. The next launch runs the kernel's rung
    again as a counted last-rung override."""
    s = Schedule("bsr", 64, 1.0)
    calls = []

    def kernel(x):
        calls.append("kernel")
        if len(calls) == 1:
            if fault == "raise":
                raise RuntimeError("launch failed")
            return torch.full((3,), float("nan"))
        return torch.ones(3)

    def never(*_):
        raise AssertionError("the card's chain left the kernel")

    ex = GuardedExecutor()
    p = Plan(op="spmv", schedule=s, backend="cuda", _run=kernel,
             device=torch.device("cuda", 0))
    resilience.guard_plan(p, rebuild=never, dense_run=never, executor=ex)
    with pytest.raises(NonFiniteOutput if fault == "nan" else RuntimeError):
        p._run(None)
    tel = ex.telemetry()
    assert tel["exhausted"] == 1 and tel["fallbacks"] == 0
    assert tel["nan_trips"] == (fault == "nan")
    assert ex.quarantine.blocked("spmv", "cuda", s) and p.backend == "cuda"
    assert torch.equal(p._run(None), torch.ones(3))
    assert calls == ["kernel", "kernel"]
    assert ex.quarantine_overrides == 1 and ex.quarantine_skips == 0


# ------------------------------------------------------------- quarantine

def test_quarantine_ttl_expiry_like_jax():
    qs = (Quarantine(ttl_ticks=2), jres.Quarantine(ttl_ticks=2))
    for q, s in zip(qs, (Schedule("bsr", 64, 1.0), JSchedule("bsr", 64,
                                                             1.0))):
        q.add("spmv", "torch", s)
        assert q.blocked("spmv", "torch", s)
        assert q.blocked_any_backend("spmv", s)
        q.tick()
        assert q.blocked("spmv", "torch", s)
        q.tick()
        assert not q.blocked("spmv", "torch", s)
    assert qs[0].telemetry() == qs[1].telemetry()
    assert qs[0].expired == 1 and len(qs[0]) == 0


def test_quarantine_export_restore_like_jax():
    qs = (Quarantine(ttl_ticks=5), jres.Quarantine(ttl_ticks=5))
    for q, S in zip(qs, (Schedule, JSchedule)):
        q.add("spmv", "torch", S("bsr", 64, 1.0, layout="sell",
                                 slice_height=8))
        q.tick()
    state = qs[0].export_state()
    assert state == qs[1].export_state()
    fresh = Quarantine()
    assert fresh.restore_state(state + [{"bad": 1}]) == 1
    assert fresh.export_state() == state


def test_quarantined_rung_skipped_on_next_plan():
    A = CSR.from_dense(_dense(64, 64, 0.1, 7))
    x = np.ones(64, np.float32)
    install_injector(FaultInjector(1.0, seed=0, sites=("launch",)))
    plan("spmv", A, device=CPU).execute(x)          # poisons torch
    fired = sum(resilience.injector().fired.values())
    y = plan("spmv", A, device=CPU).execute(x)
    assert default_executor().quarantine_skips == 1
    assert sum(resilience.injector().fired.values()) == fired
    np.testing.assert_allclose(y.numpy(), A.to_dense() @ x, **TOL)


def test_quarantine_override_on_last_rung_counted():
    def planner(operands, schedule, backend, **kw):
        return Plan(op="solorung", schedule=schedule, backend=backend,
                    _run=lambda: torch.ones(2))
    register_op("solorung", planner, layouts=(), overwrite=True)
    try:
        default_quarantine().add("solorung", "torch", None, reason="test")
        y = plan("solorung", (), device=CPU).execute()   # no dense ref
        assert torch.equal(y, torch.ones(2))
        assert default_executor().quarantine_overrides == 1
        assert default_executor().quarantine_skips == 0
    finally:
        _REGISTRY.pop("solorung", None)


def test_explicit_executor_isolates_quarantine():
    ex = GuardedExecutor()
    A = CSR.from_dense(_dense(64, 64, 0.1, 2))
    install_injector(FaultInjector(1.0, seed=0, sites=("launch",)))
    plan("spmv", A, device=CPU, executor=ex).execute(np.ones(64, np.float32))
    assert ex.fallbacks["spmv"] == 1 and len(ex.quarantine) == 1
    assert len(default_quarantine()) == 0
    assert default_executor().fallbacks["spmv"] == 0


# ------------------------------------------------------- guarded build

@pytest.mark.parametrize("bucket", [False, True])
def test_prep_fault_degrades_build_to_dense_like_jax(bucket):
    """Every prep check fires: one retry, then the build degrades to the
    dense reference, which serves the JAX facade's output on the plan's
    device."""
    d = _dense(64, 64, 0.1, 8)
    A, jA = _pair(d)
    x = np.random.default_rng(3).standard_normal(64).astype(np.float32)
    s, js = Schedule("bsr", 32, 1.0), JSchedule("bsr", 32, 1.0)
    if bucket:
        want = np.asarray(jplan_bucket("spmv", [jA, jA], js,
                                       backend="jnp").execute([x, x])[1])
    else:
        want = np.asarray(jplan("spmv", jA, schedule=js,
                                backend="jnp").execute(x))
    install_injector(FaultInjector(1.0, seed=0, sites=("prep",)))
    p = (plan_bucket("spmv", [A, A], s, device=CPU, store=PreparedStore())
         if bucket else plan("spmv", A, schedule=s, device=CPU))
    assert p.source == "guard-dense" and p.backend == "dense"
    assert p.device.type == CPU
    ex = default_executor()
    assert ex.build_retries == 1 and ex.dense_builds == 1
    y = p.execute([x, x])[1] if bucket else p.execute(x)
    np.testing.assert_allclose(y.numpy(), want, **TOL)
    inj = resilience.injector()
    assert inj.fired["prep"] == inj.recovered_counts["prep"] == 2


def test_build_fault_without_dense_rung_raises(monkeypatch):
    monkeypatch.setenv("REPRO_DENSE_REF_MAX_ELEMS", "10")
    install_injector(FaultInjector(1.0, seed=0, sites=("prep",)))
    with pytest.raises(resilience.InjectedFault, match="prep"):
        plan("spmv", CSR.from_dense(_dense(64, 64, 0.1, 8)), device=CPU)
    assert default_executor().build_retries == 1


# ------------------------------------------------- corrupted persistence

def _fill_cache(path, mats):
    cache = ScheduleCache(path=path, context="t")
    for i, A in enumerate(mats):
        cache.put(fingerprint(A), Schedule("bsr", 64 * (i + 1), 1.0), "test")
    assert cache.flush()
    return cache


def _mats(seeds):
    return [CSR.from_dense(_dense(64, 64, 0.1, s)) for s in seeds]


def test_corrupt_cache_entry_skipped_not_raised(tmp_path):
    path = str(tmp_path / "cache.json")
    mats = _mats((0, 1, 2))
    _fill_cache(path, mats)
    with open(path) as f:
        payload = json.load(f)
    payload["entries"][1]["schedule"]["block_size"] = 999    # bit flip
    with open(path, "w") as f:
        json.dump(payload, f)
    again = ScheduleCache(path=path, context="t")
    assert len(again) == 2 and again.corrupt_entries == 1
    assert again.get(fingerprint(mats[0])) is not None
    assert again.get(fingerprint(mats[1])) is None


def test_truncated_cache_file_cold_starts_empty(tmp_path):
    path = str(tmp_path / "cache.json")
    _fill_cache(path, _mats((0,)))
    with open(path) as f:
        raw = f.read()
    with open(path, "w") as f:
        f.write(raw[: len(raw) // 2])
    again = ScheduleCache(path=path, context="t")
    assert len(again) == 0 and again.corrupt_files == 1
    fp = fingerprint(_mats((9,))[0])
    again.put(fp, Schedule("bsr", 64, 1.0), "test")
    assert again.flush() and ScheduleCache(path=path, context="t").get(fp)


def test_cache_write_fault_preserves_previous_file(tmp_path):
    path = str(tmp_path / "cache.json")
    mats = _mats((0, 1))
    cache = _fill_cache(path, mats[:1])
    with open(path) as f:
        before = f.read()
    install_injector(FaultInjector(1.0, seed=0, sites=("cache-write",)))
    cache.put(fingerprint(mats[1]), Schedule("bsr", 32, 1.0), "test")
    assert cache.flush() is False and cache.flush_failures == 1
    with open(path) as f:
        assert f.read() == before
    inj = resilience.injector()
    assert inj.fired["cache-write"] == inj.recovered_counts["cache-write"]
    install_injector(None)
    assert cache.flush()


def test_cache_read_fault_served_as_miss(tmp_path):
    path = str(tmp_path / "cache.json")
    mats = _mats((0,))
    _fill_cache(path, mats)
    install_injector(FaultInjector(1.0, seed=0, sites=("cache-read",)))
    cold = ScheduleCache(path=path, context="t")     # the file read faults
    assert len(cold) == 0 and cold.corrupt_files == 1
    warm = ScheduleCache(context="t")
    warm.put(fingerprint(mats[0]), Schedule("bsr", 64, 1.0), "test")
    assert warm.get(fingerprint(mats[0])) is None
    assert warm.faulted_reads == 1
    install_injector(None)
    assert warm.get(fingerprint(mats[0])) is not None


def test_store_index_checksum_and_corrupt_file(tmp_path):
    path = str(tmp_path / "store.json")
    store = PreparedStore()
    store.put(("a",), torch.zeros(4))
    store.put(("b",), torch.zeros(4))
    assert store.save(path)
    with open(path) as f:
        payload = json.load(f)
    payload["entries"][0]["nbytes"] = 10 ** 9
    with open(path, "w") as f:
        json.dump(payload, f)
    fresh = PreparedStore()
    assert len(fresh.load(path)["entries"]) == 1 and fresh.corrupt_loads == 1
    with open(path, "w") as f:
        f.write("{not json")
    fresh2 = PreparedStore()
    assert fresh2.load(path) == {} and fresh2.corrupt_loads == 1
    install_injector(FaultInjector(1.0, seed=0, sites=("cache-write",)))
    assert store.save(path) is False and store.save_failures == 1


def test_store_evict_fault_serves_miss_and_rebuilds():
    store = PreparedStore()
    store.put(("k",), torch.ones(4))
    install_injector(FaultInjector(1.0, seed=0, sites=("store-evict",)))
    assert store.get(("k",)) is None
    assert store.fault_evictions == 1 and store.bytes_in_use == 0
    assert store.telemetry()["fault_evictions"] == 1.0
    install_injector(None)
    rebuilt = store.get_or_build(("k",), lambda: torch.zeros(4))
    assert rebuilt is not None and ("k",) in store


def test_store_evict_fault_rebuilds_a_plan():
    """A plan through a store whose entry is lost to a fault rebuilds it
    and still serves the right answer."""
    d = _dense(64, 64, 0.1, 5)
    A = CSR.from_dense(d)
    store = PreparedStore()
    x = np.ones(64, np.float32)
    plan("spmv", A, store=store, device=CPU).execute(x)
    install_injector(FaultInjector(1.0, seed=0, sites=("store-evict",)))
    y = plan("spmv", A, store=store, device=CPU).execute(x)
    np.testing.assert_allclose(y.numpy(), d @ x, **TOL)
    assert store.fault_evictions == 1 and store.puts == 2


# --------------------------------------------------- backoff and deadline

def test_with_backoff_retries_then_succeeds():
    calls, sleeps = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError("transient")
        return "ok"
    assert with_backoff(flaky, max_retries=3, base_s=0.01,
                        sleep=sleeps.append) == "ok"
    assert len(calls) == 3 and sleeps == [0.01, 0.02]

    def always():
        raise RuntimeError("permanent")
    with pytest.raises(RuntimeError, match="permanent"):
        with_backoff(always, max_retries=2, base_s=0.0, sleep=lambda _: None)
    with pytest.raises(ValueError):       # contract errors are never retried
        with_backoff(lambda: int("x"), max_retries=5, sleep=None)


def test_deadline():
    d = Deadline.after_ms(10.0, now=100.0)
    assert d.t_deadline == pytest.approx(100.01)
    assert not d.exceeded(now=100.005) and d.exceeded(now=100.02)
    assert d.remaining_s(now=100.0) == pytest.approx(0.01)
    assert dataclasses.asdict(d) == dataclasses.asdict(
        jres.Deadline.after_ms(10.0, now=100.0))


# --------------------------------------------------------- output_finite

def _leaf(kind):
    """A float container of each output shape the facade returns."""
    if kind == "scalar":
        return torch.tensor(1.5)
    if kind == "vector":
        return torch.arange(7, dtype=torch.float32)
    if kind == "matrix":
        return torch.ones(5, 3)
    if kind == "stacked":
        return torch.ones(3, 4, 2)
    if kind == "strided":
        return torch.ones(4, 6)[:, :4]
    if kind == "bfloat16":
        return torch.ones(6, dtype=torch.bfloat16)
    if kind == "numpy":
        return np.ones(5, np.float32)
    if kind == "bsr":
        return SparseTensor.from_csr(CSR.from_dense(_dense(32, 32, 0.2, 1)),
                                     layout="bsr", block_size=16, device=CPU)
    return [torch.ones(3), torch.ones(2, 2)]          # bucket


def _poison(out, value):
    if isinstance(out, list):
        out[-1].view(-1)[-1] = value
    elif isinstance(out, SparseTensor):
        out.arrays["blocks"].view(-1)[7] = value
    elif isinstance(out, np.ndarray):
        out[2] = value
    else:
        out[(0,) * out.dim()] = value
    return out


KINDS = ["scalar", "vector", "matrix", "stacked", "strided", "bfloat16",
         "numpy", "bsr", "bucket"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("value", [np.nan, np.inf, -np.inf, -0.0, 2.0])
def test_output_finite_on_every_output_shape(kind, value):
    out = _poison(_leaf(kind), value)
    assert output_finite(out) == bool(np.isfinite(value))


def test_output_finite_reduces_each_leaf_whole():
    t = torch.zeros(10, 3)
    assert output_finite(t)
    t[9, 2] = np.nan                    # the last element
    assert not output_finite(t)
    t[9, 2] = -np.inf
    assert not output_finite([torch.zeros(2), t])
    assert output_finite(torch.zeros(0, 3))
    assert output_finite(torch.tensor([1, 2], dtype=torch.int32))
    assert output_finite(None) and output_finite([])


# ------------------------------------------------------- fault injector

@pytest.mark.parametrize("rate,seed", [(0.3, 11), (0.05, 0), (0.5, 123)])
@pytest.mark.parametrize("site", ["launch", "prep", "cache-read"])
def test_injector_draws_equal_the_reference(rate, seed, site):
    a = FaultInjector(rate, seed=seed)
    b = jres.FaultInjector(rate, seed=seed)
    fired = [a.fire(site) for _ in range(200)]
    assert fired == [b.fire(site) for _ in range(200)]
    assert 0 < sum(fired) < 200
    assert a.telemetry() == b.telemetry()
    assert resilience.SITES == jres.SITES
    only = FaultInjector(1.0, seed=0, sites=("prep",))
    assert not only.fire("launch") and only.checks["launch"] == 1


def test_check_fault_without_injector_is_a_noop():
    resilience.check_fault("launch")
    assert not resilience.fault_fired("cache-read")
