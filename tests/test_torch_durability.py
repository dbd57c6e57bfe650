"""Durable serving in the port (of ``tests/test_durability.py``; DESIGN.md
§15): the write-ahead request journal, engine checkpoint/restore and
crash-replay with exactly-once accounting, on the port's engine with
``device="cpu"``; then the files across packages — a journal and a
checkpoint written by either package scan, load, restore and reconcile
the same in the other — and the ``crash`` site's draws, which kill a
deterministic drive at the same tick in both packages.

The drift monitor's round trip waits for the drift slice; the eight-seed
crash matrix and the mid-checkpoint crash are ``chaos`` tests, as in the
reference."""
import dataclasses
import json
import os

import numpy as np
import pytest

import repro.core as J
from repro.core.autotune import Schedule as JSchedule
from repro.selector import ScheduleCache as JScheduleCache
from repro.selector import SelectorService as JSelectorService
from repro.serving import EngineCheckpoint as JEngineCheckpoint
from repro.serving import RequestJournal as JRequestJournal
from repro.serving import ServingEngine as JServingEngine
from repro.serving import reconcile as jreconcile
from repro.serving import run_with_restarts as jrun_with_restarts
from repro.serving import tenant_population as jtenant_population
from repro.serving import tenant_rhs as jtenant_rhs
from repro.sparse import FaultInjector as JFaultInjector
from repro.sparse import PreparedStore as JPreparedStore
from repro.sparse import Quarantine as JQuarantine
from repro.sparse import resilience as jres
from repro_torch import core as T
from repro_torch.core.autotune import Schedule
from repro_torch.selector import ScheduleCache, SelectorService
from repro_torch.serving import (CHECKPOINT_VERSION, EngineCheckpoint,
                                 RequestJournal, ServingEngine,
                                 generate_trace, reconcile, recover_engine,
                                 recovery_telemetry, replay,
                                 run_with_restarts, tenant_population,
                                 tenant_rhs)
from repro_torch.serving.checkpoint import jsonify
from repro_torch.serving.journal import JOURNAL_FORMAT_VERSION
from repro_torch.sparse import (FaultInjector, PreparedStore, Quarantine,
                                install_injector, reset_resilience)
from repro_torch.sparse.resilience import SimulatedCrash, entry_checksum

CPU = "cpu"
V5E = T.Platform(**dataclasses.asdict(J.TPU_V5E))
TRAIN = dict(n_matrices=4, n_min=96, n_max=160, seed=3)
POP = dict(n_min=96, n_max=160, seed=17)


@pytest.fixture(autouse=True)
def _clean_resilience():
    reset_resilience()
    jres.reset_resilience()
    yield
    reset_resilience()
    jres.reset_resilience()


@pytest.fixture(scope="module")
def tuners():
    t = T.ScheduleTuner("spmv", V5E).fit(T.corpus(**TRAIN), max_mats=4)
    j = J.ScheduleTuner("spmv", J.TPU_V5E).fit(J.corpus(**TRAIN), max_mats=4)
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


def _engine(tuner, journal=None, checkpointer=None, **kw):
    svc = SelectorService(tuner, cache=ScheduleCache(),
                          prepared_store=PreparedStore(),
                          quarantine=Quarantine(ttl_ticks=64), device=CPU)
    return ServingEngine(svc, journal=journal, checkpointer=checkpointer,
                         **kw)


def _jengine(tuner, journal=None, checkpointer=None, **kw):
    svc = JSelectorService(tuner, cache=JScheduleCache(),
                           prepared_store=JPreparedStore(),
                           quarantine=JQuarantine(ttl_ticks=64))
    return JServingEngine(svc, journal=journal, checkpointer=checkpointer,
                          backend="jnp", **kw)


# ------------------------------------------------------------------- journal

def test_journal_wal_scan_and_reconcile(tmp_path):
    j = RequestJournal(tmp_path, fsync_every=2)
    for i in range(5):
        assert j.append_submit(f"r{i}", f"req{i}", tenant=i % 2,
                               deadline_ms=50.0)
    j.append_outcome("r0", "completed")
    j.append_outcome("r1", "shed")
    j.append_outcome("r2", "rejected")
    s = j.scan()
    assert [r["rid"] for r in s.pending] == ["r3", "r4"]
    assert s.terminal == {"r0", "r1", "r2"}
    led = reconcile(s)
    assert led["submitted"] == 5 and led["open"] == 2
    assert led["completed"] == 1 and led["shed"] == 1 and led["rejected"] == 1
    assert led["duplicate_outcomes"] == 0 and led["dropped_corrupt"] == 0
    # records carry what recovery needs to re-submit
    assert s.pending[0]["tenant"] == 1
    assert s.pending[0]["deadline_ms"] == 50.0
    assert j.telemetry()["fsyncs"] >= 4.0
    with pytest.raises(ValueError, match="outcome"):
        j.append_outcome("r3", "lost")
    j.close()
    assert JOURNAL_FORMAT_VERSION == 1


def test_journal_rotation_and_lsn_continuity(tmp_path):
    j = RequestJournal(tmp_path, segment_max_records=16)
    for i in range(40):
        j.append_submit(f"r{i}", "req")
    j.close()
    segs = [n for n in os.listdir(tmp_path) if n.startswith("wal-")]
    assert len(segs) >= 2, "rotation must split segments"
    # a reopened journal continues lsn numbering, never reuses one
    j2 = RequestJournal(tmp_path)
    assert j2.last_lsn == 40
    j2.append_submit("r40", "req")
    s = j2.scan()
    assert s.last_lsn == 41
    assert len(s.pending) == 41
    j2.close()


def test_journal_compaction_preserves_ledger_and_pending(tmp_path):
    j = RequestJournal(tmp_path, segment_max_records=16)
    for i in range(30):
        j.append_submit(f"r{i}", "req")
    for i in range(25):
        j.append_outcome(f"r{i}", "completed" if i % 3 else "shed")
    before = reconcile(j.scan())
    assert j.compact() == 25
    after = reconcile(j.scan())
    assert after == before, "compaction must not change the ledger"
    assert [r["rid"] for r in j.scan().pending] == [f"r{i}"
                                                   for i in range(25, 30)]
    # only the compacted segment remains; appends continue past it
    assert len([n for n in os.listdir(tmp_path)
                if n.startswith("wal-")]) == 1
    j.append_outcome("r25", "completed")
    led = reconcile(j.scan())
    assert led["completed"] == before["completed"] + 1
    assert led["open"] == 4
    j.close()


def test_journal_torn_tail_skipped_counted_and_appendable(tmp_path):
    j = RequestJournal(tmp_path)
    for i in range(3):
        j.append_submit(f"r{i}", "req")
    j.close()
    seg = sorted(p for p in os.listdir(tmp_path) if p.startswith("wal-"))[-1]
    with open(tmp_path / seg, "a") as f:
        f.write('{"kind":"submit","rid":"torn')   # crash mid-append
    j2 = RequestJournal(tmp_path)
    s = j2.scan()
    assert s.dropped_corrupt == 1
    assert len(s.pending) == 3
    # the next append must terminate the torn line, not concatenate onto it
    j2.append_submit("r3", "req")
    j2.flush()
    s2 = j2.scan()
    assert [r["rid"] for r in s2.pending] == ["r0", "r1", "r2", "r3"]
    assert s2.dropped_corrupt == 1
    j2.close()


def test_journal_flipped_bit_costs_exactly_one_record(tmp_path):
    j = RequestJournal(tmp_path)
    for i in range(4):
        j.append_submit(f"r{i}", "req")
    j.close()
    seg = sorted(p for p in os.listdir(tmp_path) if p.startswith("wal-"))[-1]
    lines = (tmp_path / seg).read_text().splitlines()
    lines[1] = lines[1].replace('"rid":"r1"', '"rid":"rX"')  # checksum break
    (tmp_path / seg).write_text("\n".join(lines) + "\n")
    s = RequestJournal(tmp_path).scan()
    assert s.dropped_corrupt == 1
    assert [r["rid"] for r in s.pending] == ["r0", "r2", "r3"]


def test_journal_append_fault_degrades_never_raises(tmp_path):
    inj = install_injector(FaultInjector(1.0, sites=("journal-append",)))
    j = RequestJournal(tmp_path)
    assert j.append_submit("r0", "req") is False
    install_injector(None)
    assert j.append_submit("r1", "req") is True
    tel = j.telemetry()
    assert tel["append_failures"] == 1.0 and tel["appends"] == 1.0
    assert inj.telemetry()["fault_recovered"] == 1.0
    j.close()


def test_duplicate_outcomes_are_counted_not_double_booked(tmp_path):
    j = RequestJournal(tmp_path)
    j.append_submit("r0", "req")
    j.append_outcome("r0", "completed")
    j.append_outcome("r0", "completed")
    s = j.scan()
    assert s.duplicate_outcomes == 1
    led = reconcile(s)
    assert led["completed"] == 1 and led["open"] == 0
    j.close()


# ---------------------------------------------------------------- checkpoints

def _learned_engine(tuner, population, rhs, journal=None, checkpointer=None,
                    make=_engine, schedule=Schedule):
    """An engine with non-trivial learned state: served traffic, a
    quarantined combo, a retraining row, cache entries."""
    engine = make(tuner, journal=journal, checkpointer=checkpointer)
    for t, (name, A) in enumerate(population):
        engine.submit(f"warm:{name}", A, rhs[t], tenant=t, rid=f"warm{t}")
    engine.drain_all()
    svc = engine.service
    svc.quarantine.add("spmv", "cuda", schedule("bsr", 128, 1.0),
                       reason="test-poison")
    svc.retraining_examples.append(
        {"features": {"n_rows": 96.0}, "cfg": (0, 2, 3), "log10_time_s": -4.2})
    return engine


def test_checkpoint_round_trips_learned_state(tuner, population, rhs,
                                              tmp_path):
    ckpt = EngineCheckpoint(tmp_path)
    engine = _learned_engine(tuner, population, rhs, checkpointer=ckpt)
    cache_len = len(engine.service.cache)
    assert engine.checkpoint()
    counts = {k: int(v) for k, v in engine._counts.items()}

    fresh = _engine(tuner, checkpointer=EngineCheckpoint(tmp_path))
    payload, dropped = fresh.checkpointer.load_latest()
    assert dropped == 0 and payload is not None
    assert payload["version"] == CHECKPOINT_VERSION == 1
    fresh.restore_state(payload)
    svc = fresh.service
    assert svc.quarantine.blocked("spmv", "cuda", Schedule("bsr", 128, 1.0))
    assert len(svc.retraining_examples) == 1
    assert svc.retraining_examples[0]["cfg"] == [0, 2, 3]  # jsonified tuple
    assert len(svc.cache) == cache_len
    tel = fresh.telemetry()
    assert tel["completed"] == counts["completed"]
    # ledger identity holds inside the restored registry by construction
    assert tel["admitted"] == tel["completed"] + tel["shed"]
    assert fresh._ticks == engine._ticks
    assert jsonify({"a": (np.float32(1.5), np.int64(2)), 3: None}) == \
        {"a": [1.5, 2], "3": None}


def test_checkpoint_corrupt_falls_back_to_older_then_cold(tuner, population,
                                                          rhs, tmp_path):
    ckpt = EngineCheckpoint(tmp_path)
    engine = _learned_engine(tuner, population, rhs, checkpointer=ckpt)
    assert engine.checkpoint()
    engine.submit("one-more", population[0][1], rhs[0], tenant=0)
    engine.drain_all()
    assert engine.checkpoint()
    files = sorted(p for p in os.listdir(tmp_path) if p.startswith("ckpt-"))
    assert len(files) == 2
    # flip a byte in the NEWEST checkpoint: load falls back to the older one
    newest = tmp_path / files[-1]
    payload = json.loads(newest.read_text())
    payload["tick"] = int(payload["tick"]) + 999     # crc now mismatches
    newest.write_text(json.dumps(payload))
    got, dropped = EngineCheckpoint(tmp_path).load_latest()
    assert dropped == 1 and got is not None
    assert got["seq"] == int(files[0][len("ckpt-"):-len(".json")])
    # corrupt BOTH -> cold start, counted, never raised
    older = tmp_path / files[0]
    older.write_text(older.read_text()[:40])         # truncated JSON
    got2, dropped2 = EngineCheckpoint(tmp_path).load_latest()
    assert got2 is None and dropped2 == 2


def test_checkpoint_stale_version_cold_starts(tmp_path):
    bad = {"version": 999, "seq": 1, "tick": 0}
    bad["crc"] = entry_checksum(bad)
    (tmp_path / "ckpt-00000001.json").write_text(json.dumps(bad))
    got, dropped = EngineCheckpoint(tmp_path).load_latest()
    assert got is None and dropped == 1


def test_checkpoint_keeps_the_newest_files(tuner, population, rhs,
                                           tmp_path):
    ckpt = EngineCheckpoint(tmp_path, keep=2)
    engine = _learned_engine(tuner, population, rhs, checkpointer=ckpt)
    for _ in range(4):
        assert engine.checkpoint()
    assert sorted(os.listdir(tmp_path)) == ["ckpt-00000003.json",
                                            "ckpt-00000004.json"]
    tel = engine.telemetry()
    assert tel["checkpoints"] == 4.0 and tel["ckpt_files"] == 2.0


def test_checkpoint_write_fault_keeps_previous_snapshot(tuner, population,
                                                        rhs, tmp_path):
    ckpt = EngineCheckpoint(tmp_path)
    engine = _learned_engine(tuner, population, rhs, checkpointer=ckpt)
    assert engine.checkpoint()
    install_injector(FaultInjector(1.0, sites=("checkpoint-write",)))
    assert engine.checkpoint() is False      # absorbed, counted
    install_injector(None)
    got, dropped = EngineCheckpoint(tmp_path).load_latest()
    assert got is not None and dropped == 0
    assert ckpt.telemetry()["save_failures"] == 1.0


def test_checkpoint_newer_than_journal_skips_replay(tuner, population, rhs,
                                                    tmp_path):
    """A checkpoint whose journal_lsn exceeds the journal's last lsn means
    the WAL lost its tail: records the snapshot already counted terminal
    are gone, so replaying what's left could double-serve answered
    requests. Recovery cold-starts the journal's view: no replay, counted
    as a dropped-corrupt artifact."""
    jdir, cdir = tmp_path / "journal", tmp_path / "ckpt"
    journal = RequestJournal(jdir)
    engine = _engine(tuner, journal=journal,
                     checkpointer=EngineCheckpoint(cdir))
    for t, (name, A) in enumerate(population):
        engine.submit(f"w:{name}", A, rhs[t], tenant=t)
    engine.drain_all()
    assert engine.checkpoint()
    journal.close()
    # lose the WAL tail: wipe the journal dir (lsn 0 < checkpoint's lsn)
    for n in os.listdir(jdir):
        os.unlink(jdir / n)
    fresh = _engine(tuner, journal=RequestJournal(jdir),
                    checkpointer=EngineCheckpoint(cdir))
    rec = recover_engine(fresh)
    assert rec["replayed"] == 0
    assert rec["dropped_corrupt"] >= 1
    assert rec["from_checkpoint"] == 1.0
    tel = fresh.telemetry()
    assert tel["admitted"] == tel["completed"] + tel["shed"]


# ----------------------------------------------------------- recovery replay

def test_recover_engine_replays_exactly_the_open_suffix(tuner, population,
                                                        rhs, tmp_path):
    journal = RequestJournal(tmp_path / "journal")
    engine = _engine(tuner, journal=journal,
                     checkpointer=EngineCheckpoint(tmp_path))
    for t, (name, A) in enumerate(population):
        engine.submit(f"w{t}:{name}", A, rhs[t], tenant=t, rid=f"w{t}")
    engine.drain_all()
    # two more submits that never drain: the crash leaves them open
    engine.submit("open0", population[0][1], rhs[0], tenant=0, rid="open0")
    engine.submit("open1", population[1][1], rhs[1], tenant=1, rid="open1")
    engine.checkpoint()
    journal.flush()

    calls = []

    def resolve(rec):
        calls.append(rec["rid"])
        t = int(rec["tenant"])
        return population[t][1], rhs[t]

    fresh = _engine(tuner, journal=RequestJournal(tmp_path / "journal"),
                    checkpointer=EngineCheckpoint(tmp_path))
    rec = recover_engine(fresh, resolve=resolve)
    assert rec["replayed"] == 2 and sorted(calls) == ["open0", "open1"]
    fresh.drain_all()
    # a re-offered answered rid is dropped at submit, never re-executed
    assert fresh.submit("open0", population[0][1], rhs[0], rid="open0")
    assert fresh.telemetry()["duplicate_submits"] == 1.0
    assert fresh.backlog == 0
    fresh.close()
    led = reconcile(RequestJournal(tmp_path / "journal").scan())
    assert led["open"] == 0 and led["duplicate_outcomes"] == 0
    assert led["submitted"] == led["completed"] + led["shed"] + led["rejected"]
    tel = fresh.telemetry()
    assert tel["admitted"] == tel["completed"] + tel["shed"]
    # the already-terminal warm rids were seeded, not re-executed
    assert tel["drain_dedups"] == 0.0 and tel["duplicate_submits"] == 1.0


def test_unresolvable_record_is_closed_with_a_shed_tombstone(tuner, tmp_path):
    journal = RequestJournal(tmp_path / "journal")
    journal.append_submit("ghost", "req", tenant=99)
    journal.close()
    fresh = _engine(tuner, journal=RequestJournal(tmp_path / "journal"))
    rec = recover_engine(fresh, resolve=lambda r: None)
    assert rec["unresolvable"] == 1 and rec["replayed"] == 0
    led = reconcile(fresh.journal.scan())
    assert led["open"] == 0 and led["shed"] == 1


# ------------------------------------------------------- crash-replay harness

def _crash_trial(tuner, population, rhs, tmp_path, seed, rate=0.10,
                 sites=("crash",), n_requests=18, max_restarts=30):
    """One seeded crash trial: drive a trace under run_with_restarts with
    the crash site armed, then machine-check the exactly-once invariants.
    Returns (summary, final report, journal ledger)."""
    trace = generate_trace(n_requests, 2000.0, len(population), seed=seed)
    jdir = str(tmp_path / f"j{seed}")
    cdir = str(tmp_path / f"c{seed}")

    def build():
        return _engine(tuner, journal=RequestJournal(jdir),
                       checkpointer=EngineCheckpoint(cdir),
                       checkpoint_every=3)

    def resolve(rec):
        t = int(rec.get("tenant", -1))
        if 0 <= t < len(population):
            return population[t][1], rhs[t]
        return None

    inj = install_injector(FaultInjector(rate, sites=sites, seed=seed))
    try:
        summary = run_with_restarts(
            build,
            lambda engine, attempt: replay(engine, trace, population,
                                           rhs_seed=17),
            resolve=resolve, max_restarts=max_restarts,
            backoff_base_s=0.0001)
    finally:
        install_injector(None)
    rep = summary.pop("result")
    led = reconcile(RequestJournal(jdir).scan())
    # no journaled-admitted request lost, nothing executed twice, the
    # ledger identity holds in the final registry AND summed across
    # incarnations via the journal
    assert led["open"] == 0, (seed, led)
    assert led["duplicate_outcomes"] == 0, (seed, led)
    assert led["submitted"] == (led["completed"] + led["shed"]
                                + led["rejected"]), (seed, led)
    assert led["submitted"] == n_requests, (seed, led)
    assert rep["admitted"] == rep["completed"] + rep["shed"], (seed, rep)
    tel = inj.telemetry()
    assert tel["fault_fired"] == tel["fault_recovered"], (seed, tel)
    return summary, rep, led


def test_crash_replay_exactly_once_quick(tuner, population, rhs, tmp_path):
    """One seed known to fire early (the crc32 draw sequence for seed 2
    fires on the 4th crash check), so a mid-trace crash + restart +
    journal replay is actually exercised."""
    summary, rep, led = _crash_trial(tuner, population, rhs, tmp_path,
                                     seed=2)
    assert summary["restarts"] >= 1, "crash site never fired"
    assert summary["mttr_ms"] > 0.0
    assert recovery_telemetry()["restarts"] >= summary["restarts"]


def test_crash_gives_up_past_restart_budget(tuner, population, rhs,
                                            tmp_path):
    with pytest.raises(SimulatedCrash):
        _crash_trial(tuner, population, rhs, tmp_path, seed=2, rate=1.0,
                     max_restarts=2)


@pytest.mark.chaos
@pytest.mark.parametrize("seed", [2, 3, 4, 5, 6, 8, 14, 15])
def test_crash_replay_matrix(tuner, population, rhs, tmp_path, seed):
    """Eight seeded crash points: every seed shifts the crc32 draw
    sequence, moving the kill into a different phase of the replay. The
    ``crash`` site is checked twice per tick (tick-start, then between
    admission and drain), so even first-fire draw indices kill at a tick
    boundary and odd ones kill MID-DRAIN — these seeds cover both, and
    each is verified to actually fire within the trace."""
    summary, _, _ = _crash_trial(tuner, population, rhs, tmp_path,
                                 seed=seed, rate=0.18)
    assert summary["restarts"] >= 1, "crash site never fired for this seed"


@pytest.mark.chaos
def test_crash_replay_mid_checkpoint(tuner, population, rhs, tmp_path):
    """Crashes with the checkpoint-write site armed too: a kill adjacent
    to (or during) a snapshot must leave the previous checkpoint valid and
    the ledger exact."""
    summary, rep, led = _crash_trial(
        tuner, population, rhs, tmp_path, seed=2, rate=0.15,
        sites=("crash", "checkpoint-write"))
    assert led["duplicate_outcomes"] == 0


def test_run_with_restarts_clean_run_returns_result(tuner, population, rhs,
                                                    tmp_path):
    summary, rep, led = _crash_trial(tuner, population, rhs, tmp_path,
                                     seed=0, rate=0.0)
    assert summary["restarts"] == 0.0
    assert led["completed"] + led["shed"] + led["rejected"] == 18


# ------------------------------------------------------- across packages

def _scan_view(scan):
    return (scan.pending, sorted(scan.terminal), scan.ledger,
            scan.dropped_corrupt, scan.duplicate_outcomes, scan.last_lsn)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_journal_reads_the_same_in_the_other_package(tmp_path, writer):
    W, R = ((RequestJournal, JRequestJournal) if writer == "port"
            else (JRequestJournal, RequestJournal))
    j = W(tmp_path, segment_max_records=16, fsync_every=3)
    for i in range(30):
        j.append_submit(f"r{i}", f"req{i}", tenant=i % 3,
                        deadline_ms=(40.0 if i % 2 else None))
    for i in range(12):
        j.append_outcome(f"r{i}", ("completed", "shed", "rejected")[i % 3])
    j.append_outcome("r0", "completed")           # a duplicate
    j.compact()
    for i in range(12, 20):
        j.append_outcome(f"r{i}", "completed")
    j.close()
    seg = sorted(p for p in os.listdir(tmp_path) if p.startswith("wal-"))[-1]
    with open(tmp_path / seg, "a") as f:
        f.write('{"kind":"outcome","rid":"r2')    # a torn tail
    mine, other = W(tmp_path).scan(), R(tmp_path).scan()
    assert _scan_view(mine) == _scan_view(other)
    assert reconcile(mine) == jreconcile(other)
    assert reconcile(other)["open"] == 10 and other.dropped_corrupt == 1
    # the reader appends on after the writer's last lsn
    r = R(tmp_path)
    assert r.last_lsn == mine.last_lsn
    r.append_outcome("r20", "shed")
    r.close()
    assert W(tmp_path).scan().ledger["shed"] == mine.ledger["shed"] + 1


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_restores_the_same_in_the_other_package(
        tuners, tmp_path, writer):
    """A checkpoint written by one package's engine loads (same payload)
    and restores in the other's with the same ledger counters, schedule
    cache, retraining rows and quarantine."""
    t, jt = tuners
    pop, jpop = tenant_population(3, **POP), jtenant_population(3, **POP)
    xs, jxs = tenant_rhs(pop, seed=17), jtenant_rhs(jpop, seed=17)
    ports = (_engine, t, pop, xs, Schedule)
    jaxs = (_jengine, jt, jpop, jxs, JSchedule)
    (wmake, wt, wpop, wxs, wsched), (rmake, rt, _, _, rsched) = (
        (ports, jaxs) if writer == "port" else (jaxs, ports))
    Wck, Rck = ((EngineCheckpoint, JEngineCheckpoint) if writer == "port"
                else (JEngineCheckpoint, EngineCheckpoint))
    engine = _learned_engine(wt, wpop, wxs, checkpointer=Wck(tmp_path),
                             make=wmake, schedule=wsched)
    assert engine.checkpoint()
    mine, d1 = Wck(tmp_path).load_latest()
    other, d2 = Rck(tmp_path).load_latest()
    assert d1 == d2 == 0 and mine == other
    fresh = rmake(rt, checkpointer=Rck(tmp_path))
    fresh.restore_state(other)
    assert fresh.export_state() == json.loads(json.dumps(
        {k: other[k] for k in ("tick", "counts", "selector")}))
    assert fresh.service.quarantine.blocked("spmv", "cuda",
                                            rsched("bsr", 128, 1.0))
    tel, wtel = fresh.telemetry(), engine.telemetry()
    for k in ("completed", "shed", "rejected", "admitted", "drains"):
        assert tel[k] == wtel[k], k


def test_crash_points_like_jax(tuners, tmp_path):
    """The ``crash`` site's draws are the reference's: a deterministic
    drive (the whole trace offered, then ticks until dry) under
    ``run_with_restarts`` with the same seed restarts at the same ticks in
    both packages, with the same journal ledger."""
    t, jt = tuners
    pop, jpop = tenant_population(3, **POP), jtenant_population(3, **POP)
    xs, jxs = tenant_rhs(pop, seed=17), jtenant_rhs(jpop, seed=17)
    trace = generate_trace(24, 2000.0, 3, seed=5)
    out = {}
    for pkg, make, tuner, p, x, Jn, Ck, run, inst, Inj, rec in (
            ("port", _engine, t, pop, xs, RequestJournal, EngineCheckpoint,
             run_with_restarts, install_injector, FaultInjector, reconcile),
            ("jax", _jengine, jt, jpop, jxs, JRequestJournal,
             JEngineCheckpoint, jrun_with_restarts, jres.install_injector,
             JFaultInjector, jreconcile)):
        jdir, cdir = str(tmp_path / pkg / "j"), str(tmp_path / pkg / "c")
        ticks = []

        def drive(engine, attempt, p=p, x=x):
            for tr in trace:
                engine.submit(tr.name, p[tr.tenant][1], x[tr.tenant],
                              tenant=tr.tenant, rid=tr.name)
            while engine.backlog:
                ticks.append((attempt, engine._ticks))
                engine.tick()
            return engine.telemetry()

        def resolve(r, p=p, x=x):
            return p[int(r["tenant"])][1], x[int(r["tenant"])]

        inj = inst(Inj(0.12, sites=("crash",), seed=2))
        try:
            summary = run(lambda: make(tuner, journal=Jn(jdir),
                                       checkpointer=Ck(cdir),
                                       checkpoint_every=2, slot_max=4),
                          drive, resolve=resolve, max_restarts=30,
                          backoff_base_s=0.0)
        finally:
            inst(None)
        tel = summary.pop("result")
        out[pkg] = (ticks, summary["restarts"], summary["replayed"],
                    rec(Jn(jdir).scan()), inj.telemetry(),
                    {k: tel[k] for k in ("submitted", "admitted",
                                         "completed", "shed", "drains")})
    assert out["port"] == out["jax"]
    ticks, restarts, _, led, inj_tel, _ = out["port"]
    assert restarts >= 2 and led["open"] == 0
    assert led["duplicate_outcomes"] == 0 and led["submitted"] == 24
    assert inj_tel["fault_fired"] == inj_tel["fault_recovered"] == restarts
