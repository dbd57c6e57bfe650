"""The port's continuous-batching ``ServingEngine`` held against the JAX
package's: every test of ``tests/test_serving_engine.py`` on the port's
engine with ``device="cpu"`` (one launch per slot, fused content-pure
drains, deadline sheds never executed, the watermarks, trace/registry
reconciliation, content-pure slots, the per-request baseline, the Zipf
trace, the replay scorecard, ``reset_metrics``, the serving thread), then
parity: the same trace and tenant matrices bit for bit, the same
``PreparedStore.resident`` answers, and one fake-clock submit stream
through both engines with the same ledger counters, the same drained
slots and members, and outputs within 2e-5. Last, the serve CLI on the
CPU. The JAX engine runs its ``jnp`` backend; both tuners are fit on the
same corpus and the JAX package's ``TPU_V5E`` figures, carried across as
data."""
import dataclasses
import os
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as J
from repro.selector import ScheduleCache as JScheduleCache
from repro.selector import SelectorService as JSelectorService
from repro.serving import ServingEngine as JServingEngine
from repro.serving import generate_trace as jgenerate_trace
from repro.serving import tenant_population as jtenant_population
from repro.serving import tenant_rhs as jtenant_rhs
from repro.serving import zipf_weights as jzipf_weights
from repro.sparse import PreparedStore as JPreparedStore
from repro.sparse import content_key as jcontent_key
from repro.sparse import plan as jplan
from repro.sparse import plan_bucket as jplan_bucket
from repro.sparse import resilience as jres
from repro_torch import core as T
from repro_torch.obs import Tracer, default_registry, install_tracer
from repro_torch.selector import ScheduleCache, SelectorService
from repro_torch.serving import (ServingEngine, SlotTable, generate_trace,
                                 replay, tenant_population, tenant_rhs,
                                 zipf_weights)
from repro_torch.sparse import (PreparedStore, SparseTensor, content_key,
                                launch_count, plan, plan_bucket,
                                reset_counters, reset_resilience)

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
TOL = dict(rtol=2e-5, atol=2e-5)
# the JAX package's TPU v5e figures, carried across as data
V5E = T.Platform(**dataclasses.asdict(J.TPU_V5E))
TRAIN = dict(n_matrices=9, n_min=128, n_max=256, seed=3)
POP = dict(n_min=128, n_max=256, seed=17)


@pytest.fixture(autouse=True)
def _fresh_resilience():
    reset_resilience()
    jres.reset_resilience()
    yield
    reset_resilience()
    jres.reset_resilience()


class FakeClock:
    """Injectable monotonic clock: time moves only when a test says so."""

    def __init__(self, t: float = 100.0) -> None:
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt_s: float) -> None:
        self.t += float(dt_s)


@pytest.fixture(scope="module")
def tuners():
    t = T.ScheduleTuner("spmv", V5E).fit(T.corpus(**TRAIN), max_mats=6)
    j = J.ScheduleTuner("spmv", J.TPU_V5E).fit(J.corpus(**TRAIN), max_mats=6)
    return t, j


@pytest.fixture(scope="module")
def tuner(tuners):
    return tuners[0]


@pytest.fixture(scope="module")
def population():
    return tenant_population(3, **POP)


@pytest.fixture(scope="module")
def rhs(population):
    return tenant_rhs(population, seed=17)


def _engine(tuner, clock=None, **kw):
    svc = SelectorService(tuner, cache=ScheduleCache(),
                          prepared_store=kw.pop("store", None), device=CPU)
    return ServingEngine(svc, clock=clock, **kw)


def _warm(engine, population, rhs):
    for t, (name, A) in enumerate(population):
        engine.submit(f"warm:{name}", A, rhs[t], tenant=t)
    engine.drain_all()


# --------------------------------------------------- one slot == one launch

def test_same_bucket_requests_drain_in_one_stacked_launch(
        tuner, population, rhs):
    engine = _engine(tuner, slot_max=8)
    _warm(engine, population, rhs)     # selection memo + container
    name, A = population[0]
    reset_counters()
    for j in range(3):
        assert engine.submit(f"r{j}:{name}", A, rhs[0], tenant=0)
    done = engine.tick()               # admit all three, drain ONE slot
    assert done == 3
    assert launch_count("spmv") == 1   # the whole point of the slot
    tel = engine.telemetry()
    # 3 warm singleton drains + the one measured 3-request drain
    assert tel["completed"] == 6.0 and tel["multi_request_drains"] == 1.0
    assert tel["drains"] == 4.0 and tel["drained_members"] == 6.0


def test_fused_same_content_bucket_matches_per_request_results():
    rng = np.random.default_rng(5)
    d = (rng.random((96, 96)) < 0.08) * rng.standard_normal((96, 96))
    A = T.CSR.from_dense(d.astype(np.float32))
    store = PreparedStore()
    ck = content_key(A)
    xs = [rng.standard_normal(96).astype(np.float32) for _ in range(3)]
    sched = SparseTensor.default_schedule(32, None, 8)
    singles = [plan("spmv", (A,), sched, store=store, device=CPU).execute(x)
               .numpy() for x in xs]
    pb = plan_bucket("spmv", [A, A, A], sched, store=store,
                     member_keys=(ck,) * 3, device=CPU)
    reset_counters()
    ys = pb.execute(xs)
    assert launch_count("spmv") == 1
    for y, yr in zip(ys, singles):
        np.testing.assert_allclose(y.numpy(), yr, **TOL)


# ------------------------------------------------------- deadline shedding

def test_deadline_expired_requests_shed_not_executed(tuner, population, rhs):
    clock = FakeClock()
    engine = _engine(tuner, clock=clock, deadline_ms=10.0, slot_max=8)
    _warm(engine, population, rhs)
    name, A = population[0]
    reset_counters()
    for j in range(3):
        engine.submit(f"late{j}:{name}", A, rhs[0], tenant=0)
    clock.advance(0.050)               # 50ms >> the 10ms deadline
    engine.tick()
    assert launch_count("spmv") == 0   # shed means NOT executed
    tel = engine.telemetry()
    assert tel["shed"] == 3.0
    assert tel["admitted"] == tel["completed"] + tel["shed"]
    assert engine.backlog == 0


# ----------------------------------------------------------- backpressure

def test_hard_watermark_bounds_queue_depth(tuner, population, rhs):
    engine = _engine(tuner, queue_max=4)
    name, A = population[0]
    outcomes = [engine.submit(f"q{j}:{name}", A, rhs[0], tenant=0)
                for j in range(10)]
    assert outcomes == [True] * 4 + [False] * 6   # depth never exceeds 4
    tel = engine.telemetry()
    assert tel["rejected"] == 6.0 and tel["queue_depth"] == 4.0
    engine.drain_all()
    tel = engine.telemetry()
    assert tel["admitted"] == tel["completed"] + tel["shed"] == 4.0


def test_soft_watermark_sends_degrade_signal(tuner, population, rhs):
    engine = _engine(tuner, queue_max=8, soft_watermark=3)
    name, A = population[0]
    for j in range(5):
        engine.submit(f"s{j}:{name}", A, rhs[0], tenant=0)
    assert engine.telemetry()["degrade_signals"] >= 1.0
    assert engine.service.degraded
    engine.drain_all()


# -------------------------------------------------- trace reconciliation

def test_trace_counts_reconcile_with_registry(tuner, population, rhs):
    reg = default_registry()
    base = {k: reg.get(f"events.{k}") for k in ("enqueue", "admit", "drain")}
    tr = install_tracer(Tracer(registry=reg))
    try:
        engine = _engine(tuner, slot_max=4)
        for j in range(6):
            t = j % len(population)
            name, A = population[t]
            engine.submit(f"rec{j}:{name}", A, rhs[t], tenant=t)
        engine.drain_all()
    finally:
        install_tracer(None)
    counts = tr.counts()
    for k in ("enqueue", "admit", "drain"):
        assert counts.get(k, 0) > 0
        assert reg.get(f"events.{k}") - base[k] == counts.get(k, 0), k
    tel = engine.telemetry()
    assert counts["enqueue"] == tel["submitted"]
    assert counts["admit"] == tel["admitted"]
    assert tel["admitted"] == tel["completed"] + tel["shed"]
    # every drain span holds the launch span of its one stacked launch
    drains = [e for e in tr.events() if e["type"] == "drain"]
    launches = [e for e in tr.events() if e["type"] == "launch"]
    assert len(drains) == tel["drains"] and len(launches) >= len(drains)


# ------------------------------------------------------------- slot table

def test_affinity_keeps_slots_content_pure(tuner):
    sched, _ = tuner.select(T.corpus(n_matrices=1, n_min=128, n_max=192,
                                     seed=5)[0][2])
    table = SlotTable(slot_max=2)
    s1 = table.assign("m0", sched, resident=True, affinity="ckA")
    s2 = table.assign("m1", sched, resident=True, affinity="ckA")
    s3 = table.assign("m2", sched, resident=True, affinity="ckB")
    assert s1 is s2 and s1 is not s3           # same content shares a slot
    s4 = table.assign("m3", sched, resident=True, affinity="ckA")
    assert s4 is not s1                        # full slot -> sibling opens
    assert s4.affinity == "ckA" and len(table) == 3
    assert table.backlog() == 4
    picked = table.pick()
    assert picked is s1                        # full slots drain first
    table.take(picked)
    assert table.backlog() == 2


def test_slot_max_one_is_per_request_baseline(tuner):
    sched, _ = tuner.select(T.corpus(n_matrices=1, n_min=128, n_max=192,
                                     seed=5)[0][2])
    table = SlotTable(slot_max=1)
    slots = {id(table.assign(f"m{i}", sched, False, affinity="ck"))
             for i in range(4)}
    assert len(slots) == 4                     # every request its own slot


# ----------------------------------------------------------- trace replay

def test_zipf_trace_deterministic_and_skewed():
    a = generate_trace(500, 200.0, 6, seed=9)
    b = generate_trace(500, 200.0, 6, seed=9)
    assert a == b                              # byte-for-byte replayable
    c = generate_trace(500, 200.0, 6, seed=10)
    assert a != c
    ts = [r.t_s for r in a]
    assert ts == sorted(ts) and ts[0] > 0.0
    counts = np.bincount([r.tenant for r in a], minlength=6)
    assert counts[0] > counts[-1]              # Zipf head beats the tail
    w = zipf_weights(6)
    assert w[0] > w[-1] and abs(w.sum() - 1.0) < 1e-12
    with pytest.raises(ValueError, match="positive"):
        generate_trace(4, 0.0, 2)
    assert generate_trace(0, 10.0, 2) == []


def test_replay_ledger_and_scorecard(tuner, population, rhs):
    engine = _engine(tuner, slot_max=8, deadline_ms=250.0, slo_ms=100.0)
    _warm(engine, population, rhs)
    engine.reset_metrics()
    trace = generate_trace(24, 400.0, len(population), seed=17)
    rep = replay(engine, trace, population, rhs_seed=17)
    assert rep["n_offered"] == 24.0
    assert rep["admitted"] == rep["completed"] + rep["shed"]
    assert rep["completed"] + rep["shed"] + rep["rejected"] == 24.0
    assert rep["achieved_qps"] > 0.0
    for k in ("latency_p50_ms", "latency_p95_ms", "latency_p99_ms",
              "slo_attainment", "mean_drain_size", "prep_eviction_pressure"):
        assert k in rep


def test_reset_metrics_zeroes_ledger_and_refuses_in_flight(
        tuner, population, rhs):
    engine = _engine(tuner)
    name, A = population[0]
    engine.submit(f"rm0:{name}", A, rhs[0], tenant=0)
    with pytest.raises(RuntimeError):
        engine.reset_metrics()                 # request still in flight
    engine.drain_all()
    assert engine.telemetry()["completed"] == 1.0
    engine.reset_metrics()
    tel = engine.telemetry()
    assert tel["submitted"] == tel["completed"] == 0.0
    assert tel["latency_count"] == 0.0


# ------------------------------------------------------------- threading

def test_threaded_engine_start_stop(tuner, population, rhs):
    engine = _engine(tuner, slot_max=8)
    _warm(engine, population, rhs)
    engine.start(idle_s=0.0005)
    try:
        with pytest.raises(RuntimeError, match="already started"):
            engine.start()
        for j in range(8):
            t = j % len(population)
            name, A = population[t]
            assert engine.submit(f"th{j}:{name}", A, rhs[t], tenant=t)
        deadline = time.monotonic() + 30.0
        while engine.backlog and time.monotonic() < deadline:
            time.sleep(0.002)
    finally:
        engine.stop()
    tel = engine.telemetry()
    assert tel["completed"] == float(len(population) + 8)
    assert tel["admitted"] == tel["completed"] + tel["shed"]


def test_concurrent_producers_keep_the_ledger_exact(tuner, population,
                                                    rhs, tmp_path):
    """More producer threads than cores submit while the serving thread
    drains, under a shortened switch interval: every submit is counted
    once, the ledger identities hold, and the journal closes with one
    outcome per request (the engine's lock; without it ``submitted`` loses
    updates)."""
    from repro_torch.serving import RequestJournal, reconcile
    engine = _engine(tuner, slot_max=8, queue_max=100000,
                     journal=RequestJournal(tmp_path / "journal"))
    n_threads, per = 2 * (os.cpu_count() or 4), 24

    def produce(k):
        for j in range(per):
            t = (k + j) % len(population)
            engine.submit(f"p{k}.{j}", population[t][1], rhs[t], tenant=t,
                          rid=f"p{k}.{j}")

    engine.start(idle_s=0.0001)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=produce, args=(k,))
                   for k in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60.0)
        assert not any(th.is_alive() for th in threads)
        deadline = time.monotonic() + 60.0
        while engine.backlog and time.monotonic() < deadline:
            time.sleep(0.002)
    finally:
        sys.setswitchinterval(old)
        engine.stop()
    n = n_threads * per
    tel = engine.telemetry()
    assert tel["submitted"] == n == tel["admitted"] + tel["rejected"]
    assert tel["admitted"] == tel["completed"] + tel["shed"] == n
    engine.journal.close()
    led = reconcile(RequestJournal(tmp_path / "journal").scan())
    assert led["submitted"] == led["completed"] == n
    assert led["open"] == 0 and led["duplicate_outcomes"] == 0


# ------------------------------------------------------------- the card

def test_engine_runs_on_the_card_unless_asked_for_the_cpu(tuner):
    """The service's device is the card by default; without one it raises
    (no silent CPU fallback) and ``device="cpu"`` must be asked for."""
    if torch.cuda.is_available():
        svc = SelectorService(tuner)
        assert ServingEngine(svc).service.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServingEngine(SelectorService(tuner))
    engine = _engine(tuner)
    assert engine.service.device.type == "cpu" and engine.backend == "auto"


# ------------------------------------------------------- parity with JAX

def test_trace_and_population_like_jax():
    for args in ((256, 800.0, 8), (500, 50.0, 6), (33, 1e4, 3)):
        got = generate_trace(*args, a=1.1, seed=4)
        want = jgenerate_trace(*args, a=1.1, seed=4)
        assert [dataclasses.astuple(r) for r in got] == \
            [dataclasses.astuple(r) for r in want]
    np.testing.assert_array_equal(zipf_weights(8, 1.3),
                                  jzipf_weights(8, 1.3))
    pop, jpop = tenant_population(8, **POP), jtenant_population(8, **POP)
    assert [n for n, _ in pop] == [n for n, _ in jpop]
    for (_, A), (_, jA) in zip(pop, jpop):
        assert A.shape == jA.shape
        for f in ("row_ptrs", "col_idxs", "nnz_vals"):
            a, b = getattr(A, f), getattr(jA, f)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert content_key(A) == jcontent_key(jA)
    for x, jx in zip(tenant_rhs(pop, seed=3), jtenant_rhs(jpop, seed=3)):
        np.testing.assert_array_equal(x, jx)


def test_store_resident_like_jax(population):
    jpop = jtenant_population(3, **POP)
    (_, A), (_, B) = population[0], population[1]
    (_, jA), (_, jB) = jpop[0], jpop[1]
    sched = SparseTensor.default_schedule(32, None, 8)
    store, jstore = PreparedStore(), JPreparedStore()
    cks = [content_key(A), content_key(B)]
    jcks = [jcontent_key(jA), jcontent_key(jB)]
    assert cks == jcks
    got, want = [], []
    got.append([store.resident(ck) for ck in cks])
    want.append([jstore.resident(ck) for ck in jcks])
    plan("spmv", (A,), sched, store=store, device=CPU,
         operand_key=cks[0])
    jplan("spmv", (jA,), sched, store=jstore, backend="jnp",
          operand_key=jcks[0])
    got.append([store.resident(ck) for ck in cks])
    want.append([jstore.resident(ck) for ck in jcks])
    # a mixed bucket embeds both members' keys in its stacked entry
    plan_bucket("spmv", [A, B], sched, store=store, device=CPU,
                member_keys=cks)
    jplan_bucket("spmv", [jA, jB], sched, store=jstore, backend="jnp",
                 member_keys=jcks)
    got.append([store.resident(ck) for ck in cks + ["absent"]])
    want.append([jstore.resident(ck) for ck in jcks + ["absent"]])
    store.clear()
    jstore.clear()
    got.append([store.resident(ck) for ck in cks])
    want.append([jstore.resident(ck) for ck in jcks])
    assert got == want
    assert got == [[False, False], [True, False], [True, True, False],
                   [False, False]]


def _recorder(engine, pkg_y):
    """Wrap the engine's ``drain_bucket`` and ``slots.take`` to log each
    drained slot's label and each drain's member names and outputs."""
    taken, drains = [], []
    take, drain = engine.slots.take, engine.service.drain_bucket

    def take_wrapped(slot):
        taken.append(slot.label)
        return take(slot)

    def drain_wrapped(members, backend="auto"):
        decs = drain(members, backend=backend)
        drains.append([(r.name, d.schedule.block_size, pkg_y(d.y))
                       for r, d in zip([m[0] for m in members], decs)])
        return decs

    engine.slots.take = take_wrapped
    engine.service.drain_bucket = drain_wrapped
    return taken, drains


LEDGER_KEYS = ("submitted", "rejected", "admitted", "shed", "completed",
               "drains", "multi_request_drains", "drained_members",
               "resident_admits", "degrade_signals", "slo_attained",
               "slo_missed", "duplicate_submits", "drain_dedups",
               "enqueued", "queue_depth", "open_slots", "slot_backlog",
               "mean_drain_size", "shed_rate", "reject_rate",
               "slo_attainment", "latency_count", "latency_p50_ms",
               "latency_p99_ms", "prep_entries", "prep_bytes_in_use",
               "prep_evictions")


def _stream(engine, pop, xs, clock, trace):
    """One fake-clock submit stream: warm every tenant, then offer the
    trace at its arrival times with a tick after every third submit, a
    stall (past the deadline) halfway, a re-offered rid, and a drain."""
    for t, (name, A) in enumerate(pop):
        engine.submit(f"warm:{name}", A, xs[t], tenant=t, rid=f"warm{t}")
    engine.drain_all()
    t0 = clock.t
    for i, tr in enumerate(trace):
        clock.t = t0 + tr.t_s
        _, A = pop[tr.tenant]
        engine.submit(tr.name, A, xs[tr.tenant], tenant=tr.tenant,
                      rid=tr.name)
        if i == len(trace) // 2:
            clock.advance(0.050)
            engine.submit(tr.name, A, xs[tr.tenant], tenant=tr.tenant,
                          rid=tr.name)
        if i % 3 == 2:
            clock.advance(0.001)
            engine.tick()
    engine.drain_all()


@pytest.mark.parametrize("batching", [True, False])
def test_engine_stream_like_jax(tuners, batching):
    t, j = tuners
    pop, jpop = tenant_population(4, **POP), jtenant_population(4, **POP)
    xs, jxs = tenant_rhs(pop, seed=17), jtenant_rhs(jpop, seed=17)
    trace = generate_trace(40, 800.0, 4, a=1.1, seed=17)
    kw = dict(queue_max=7, soft_watermark=5, admit_max=2, slot_max=4,
              deadline_ms=20.0, slo_ms=12.0, batching=batching)
    clock, jclock = FakeClock(), FakeClock()
    engine = ServingEngine(SelectorService(t, cache=ScheduleCache(),
                                           device=CPU),
                           clock=clock, **kw)
    jengine = JServingEngine(JSelectorService(j, cache=JScheduleCache()),
                             clock=jclock, backend="jnp", **kw)
    taken, drains = _recorder(engine, lambda y: y)
    jtaken, jdrains = _recorder(jengine, np.asarray)
    _stream(engine, pop, xs, clock, trace)
    _stream(jengine, jpop, jxs, jclock, trace)
    assert taken == jtaken
    assert [[m[:2] for m in d] for d in drains] == \
        [[m[:2] for m in d] for d in jdrains]
    for d, jd in zip(drains, jdrains):
        for (_, _, y), (_, _, jy) in zip(d, jd):
            assert isinstance(y, np.ndarray)
            np.testing.assert_allclose(y, jy, **TOL)
    tel, jtel = engine.telemetry(), jengine.telemetry()
    for key in LEDGER_KEYS:
        assert tel[key] == jtel[key], key
    assert tel["admitted"] == tel["completed"] + tel["shed"]
    assert tel["submitted"] == tel["admitted"] + tel["rejected"]
    assert tel["shed"] > 0 and tel["rejected"] > 0
    assert tel["duplicate_submits"] == 1
    assert (tel["multi_request_drains"] > 0) == batching
    stel, sjtel = engine.service.telemetry(), jengine.service.telemetry()
    for key in ("requests", "cache_hits", "tree_served", "verify_fallbacks",
                "batches", "buckets", "executed", "stacked_launches",
                "degraded_ticks", "degraded_served", "fp_memo_hits"):
        assert stel[key] == sjtel[key], key


# --------------------------------------------------------------- the CLI

def _cli(*args):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.serving.serve", "--device", "cpu",
         "--requests", "24", "--qps", "400", "--tenants", "3",
         "--train-mats", "6", "--n-min", "128", "--n-max", "256",
         "--slot-max", "4", *args],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr
    return out.stdout


def _numbers(line_re, text):
    m = re.search(line_re, text)
    assert m, text
    return [float(v) for v in m.groups()]


@pytest.mark.parametrize("durable", [False, True])
def test_serve_cli_on_the_cpu(tmp_path, durable):
    stdout = _cli(*(["--checkpoint-dir", str(tmp_path / "ck"),
                     "--checkpoint-every", "4"] if durable else []))
    sub, rej, adm, comp, shed = _numbers(
        r"ledger: submitted (\d+)\s+rejected (\d+)\s+admitted (\d+)\s+"
        r"completed (\d+)\s+shed (\d+)", stdout)
    assert sub == 24 and sub == adm + rej and adm == comp + shed
    assert "achieved" in stdout and "latency ms: p50" in stdout
    if durable:
        line = re.search(r"journal ledger: (.*)", stdout).group(1)
        led = {k: float(v) for k, v in re.findall(r"(\w+) (\d+)", line)}
        assert led["open"] == 0 and led["duplicate_outcomes"] == 0
        assert led["submitted"] == 24 == (led["completed"] + led["shed"]
                                          + led["rejected"])
        assert "durable: restarts 0" in stdout
        assert any(n.startswith("ckpt-")
                   for n in os.listdir(tmp_path / "ck"))
