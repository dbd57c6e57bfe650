"""The port's spans below ``select``, ``prep`` and ``launch`` and the counters
taken at the same boundaries: the span tree of one ``plan()`` and one
``Plan.execute`` on the CPU (types, ``id`` / ``parent`` / ``req``, children
inside their parents, self times), the ``prep_ms.*`` and
``launch_host_ms.<op>`` histograms, the ``record_function`` mirror under
``torch.profiler``, the shared no-op context without a tracer,
``Histogram.recent`` and its bucket search, and the ``compile`` span of a
CUDA library's first load (nvcc stubbed)."""
import json
import os
import math
import threading

import numpy as np
import pytest
import torch

from repro_torch.core import (GENERATORS, PLATFORMS, Schedule,
                              ScheduleTuner, corpus, gen_zipf)
from repro_torch.kernels import _build
from repro_torch.obs import (EVENT_FIELDS, HIST_BOUNDS_MS, Histogram,
                             MetricsRegistry, Tracer, default_registry,
                             install_tracer, request, span)
from repro_torch.obs import trace as obs_trace
from repro_torch.selector import SelectorService
from repro_torch.sparse import (GuardedExecutor, PreparedStore,
                                finite_verdict, output_finite, plan)

CPU = "cpu"
N = 256
ELL = Schedule("bsr", 32, 1.0)
SELL = Schedule("bsr", 32, 1.0, layout="sell", slice_height=4)
PREP_KINDS = ("container", "bucket", "upload")
LAUNCH_KINDS = ("stage", "kernel", "check", "wait", "sync")
EPS_US = 0.002          # the trace rounds times to 1e-3 us


@pytest.fixture
def traced():
    tr = install_tracer(Tracer())
    try:
        yield tr
    finally:
        install_tracer(None)


@pytest.fixture(scope="module")
def tuner():
    return ScheduleTuner("spmv", PLATFORMS["h100_sxm"]).fit(
        corpus(n_matrices=6, n_min=256, n_max=384, seed=3), max_mats=6)


def _children(events, parent):
    return [e for e in events if e["parent"] == parent["id"]]


def _check_tree(events):
    """ids unique, parents among the events, each child inside its parent
    and in its request, self times >= 0, the required fields there."""
    by_id = {e["id"]: e for e in events}
    assert len(by_id) == len(events)
    for e in events:
        for f in EVENT_FIELDS[e["type"]]:
            assert f in e["args"], (e["type"], f)
        if e["parent"] is None:
            continue
        p = by_id[e["parent"]]
        assert p["req"] == e["req"] and p["tid"] == e["tid"]
        assert e["ts_us"] >= p["ts_us"] - EPS_US
        assert e["ts_us"] + e["dur_us"] <= p["ts_us"] + p["dur_us"] + EPS_US
    for e in events:
        kids = _children(events, e)
        assert e["dur_us"] - sum(k["dur_us"] for k in kids) >= -EPS_US * (
            len(kids) + 1)


@pytest.mark.parametrize("schedule", [ELL, SELL], ids=["ell", "sell"])
def test_span_tree_of_one_plan_and_one_execute(traced, schedule):
    A = gen_zipf(N, seed=1)
    p = plan("spmv", A, schedule=schedule, store=PreparedStore(), device=CPU)
    y = p.execute(np.ones(N, np.float32))
    assert y.shape == (N,)
    events = traced.events()
    _check_tree(events)
    counts = traced.counts()
    assert counts["prep"] == 1 and counts["launch"] == 1
    (prep,) = [e for e in events if e["type"] == "prep"]
    (launch,) = [e for e in events if e["type"] == "launch"]
    assert prep["parent"] is None and launch["parent"] is None
    assert prep["req"] != launch["req"]
    assert [e["type"] for e in _children(events, prep)] == list(PREP_KINDS)
    assert [e["type"] for e in _children(events, launch)] \
        == list(LAUNCH_KINDS)
    plan_events = {e["id"] for e in events if e["req"] == prep["req"]}
    assert plan_events == {prep["id"]} | {e["id"] for e in events
                                          if e["type"] in PREP_KINDS}
    container = next(e for e in events if e["type"] == "container")
    assert container["args"]["layout"] == schedule.layout
    assert container["args"]["block_size"] == 32
    assert container["args"]["blocks"] > 0
    bucket = next(e for e in events if e["type"] == "bucket")
    assert bucket["args"]["bytes_after"] >= bucket["args"]["bytes_before"] \
        == container["args"]["bytes"]
    upload = next(e for e in events if e["type"] == "upload")
    assert upload["args"]["bytes"] > 0
    # the host time is the launch's wall time less the wait and the sync
    a = launch["args"]
    wait = next(e for e in events if e["type"] == "wait")
    assert 0 <= a["host_ms"] <= a["measured_ms"]
    assert a["wait_ms"] == pytest.approx(p.last_wait_s * 1e3)
    # the guard's clock pair wraps the wait span
    assert a["wait_ms"] >= wait["dur_us"] / 1e3 - 1e-3


def test_selector_spans_under_select(traced, tuner):
    svc = SelectorService(tuner, confidence_threshold=0,
                          prepared_store=PreparedStore(), device=CPU)
    A = gen_zipf(N, seed=2)
    plan("spmv", A, selector=svc, device=CPU)
    plan("spmv", A, selector=svc, device=CPU)
    events = traced.events()
    _check_tree(events)
    selects = [e for e in events if e["type"] == "select"]
    assert len(selects) == 2
    first, second = ([e["type"] for e in _children(events, s)]
                     for s in selects)
    assert first == ["content_key", "fingerprint", "tree"]
    assert second == ["content_key", "fingerprint"]      # a cache hit
    # the second plan's select and prep are one request, apart from the
    # first plan's
    preps = [e for e in events if e["type"] == "prep"]
    assert [s["req"] for s in selects] == [p["req"] for p in preps]
    assert selects[0]["req"] != selects[1]["req"]
    memo = [e["args"]["memo_hit"] for e in events
            if e["type"] == "fingerprint"]
    assert memo == [False, True]


def test_verify_span_under_select(traced, tuner):
    svc = SelectorService(tuner, confidence_threshold=2.0, verify_top_k=2,
                          device=CPU)
    p = plan("spmv", GENERATORS["spatial"](512, 1), selector=svc,
             device=CPU)
    assert p.source == "selector-verify"
    events = traced.events()
    _check_tree(events)
    (sel,) = [e for e in events if e["type"] == "select"]
    assert [e["type"] for e in _children(events, sel)] == [
        "content_key", "fingerprint", "tree", "verify"]
    (verify,) = [e for e in events if e["type"] == "verify"]
    assert verify["args"]["candidates"] == 2


def test_prep_histograms_count_cold_builds_and_launch_host_each_execute():
    reg = default_registry()

    def count(name):
        h = reg.histogram(name)
        return 0 if h is None else h.count

    names = [f"prep_ms.{k}" for k in PREP_KINDS] + ["launch_host_ms.spmv"]
    base = {n: count(n) for n in names}
    store = PreparedStore()
    A = gen_zipf(N, seed=5)
    p = plan("spmv", A, schedule=ELL, store=store, device=CPU)
    for n in names[:3]:
        assert count(n) == base[n] + 1, n
    warm = plan("spmv", A, schedule=ELL, store=store, device=CPU)
    assert store.telemetry()["hits"] >= 1
    for n in names[:3]:
        assert count(n) == base[n] + 1, n        # a store hit preps nothing
    for _ in range(3):
        warm.execute(np.ones(N, np.float32))
    p.execute(np.ones(N, np.float32))
    assert count("launch_host_ms.spmv") == base["launch_host_ms.spmv"] + 4
    h = reg.histogram("launch_host_ms.spmv")
    assert all(v >= 0 for v in h.recent(4))


def test_no_guard_no_check_or_wait(traced):
    p = plan("spmv", gen_zipf(N, seed=6), schedule=ELL, device=CPU,
             executor=GuardedExecutor(nan_guard=False))
    p.execute(np.ones(N, np.float32))
    kinds = {e["type"] for e in traced.events()}
    assert {"stage", "kernel", "sync"} <= kinds
    assert not {"check", "wait"} & kinds
    assert p.last_wait_s == 0.0


def test_finite_verdict_is_the_check_without_the_read():
    t = torch.ones(5, 3)
    v = finite_verdict(t)
    assert isinstance(v, torch.Tensor) and v.numel() == 1 and bool(v)
    t[2, 1] = float("nan")
    assert not bool(finite_verdict(t)) and not output_finite(t)
    assert finite_verdict([]) is True
    assert finite_verdict(np.array([1.0, np.inf])) is False
    assert output_finite([np.ones(2), torch.zeros(3)])


def test_profiler_records_the_spans_as_nested_ranges(tmp_path):
    p = plan("spmv", gen_zipf(N, seed=7), schedule=ELL, device=CPU)
    x = np.ones(N, np.float32)
    tr = install_tracer(Tracer())
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            p.execute(x)
        p.execute(x)                      # no profiler: no range
    finally:
        install_tracer(None)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ranges = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    names = [e["name"] for e in ranges]
    assert names.count("launch:spmv") == 1
    (launch,) = [e for e in ranges if e["name"] == "launch:spmv"]
    inner = [e for e in ranges if e is not launch]
    assert {e["name"].split(":")[0] for e in inner} == set(LAUNCH_KINDS)
    for e in inner:
        assert e["tid"] == launch["tid"]
        assert launch["ts"] <= e["ts"]
        assert e["ts"] + e["dur"] <= launch["ts"] + launch["dur"] + 1
    # the program's own record holds both executes
    assert tr.counts()["launch"] == 2


def test_no_profiler_no_record_function(traced, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("record_function without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    p = plan("spmv", gen_zipf(N, seed=8), schedule=ELL, device=CPU)
    p.execute(np.ones(N, np.float32))
    assert traced.counts()["launch"] == 1


def test_without_a_tracer_every_span_is_one_shared_no_op():
    assert obs_trace.tracer() is None
    a, b = span("launch", "x", op="spmv"), span("stage")
    assert a is b is request()
    with a as fields:
        fields.update(op="spmv")
        fields["memo_hit"] = True
    with request(), span("kernel") as f2:
        assert f2 is fields


def test_request_ids_and_parents():
    clock = iter(range(100)).__next__
    tr = Tracer(clock=clock, registry=MetricsRegistry())
    with tr.request():
        with tr.span("select"):
            with tr.span("tree"):
                pass
        with tr.span("prep", op="spmv"):
            tr.instant("store_evict", reason="lru")
    with tr.span("launch"):
        with tr.request():            # inside a span: the span's request
            with tr.span("stage"):
                pass
    done = threading.Event()

    def other():
        with tr.span("drain", slot="s", n_requests=1):
            pass
        done.set()

    t = threading.Thread(target=other)
    t.start()
    t.join(timeout=30)
    assert done.is_set()
    ev = {e["name"]: e for e in tr.events()}
    assert ev["select"]["req"] == ev["prep"]["req"] == ev["tree"]["req"] \
        == ev["store_evict"]["req"]
    assert ev["tree"]["parent"] == ev["select"]["id"]
    assert ev["store_evict"]["parent"] == ev["prep"]["id"]
    assert ev["select"]["parent"] is None
    assert ev["stage"]["req"] == ev["launch"]["req"] != ev["select"]["req"]
    assert ev["stage"]["parent"] == ev["launch"]["id"]
    assert ev["drain"]["parent"] is None
    assert ev["drain"]["req"] not in (ev["launch"]["req"],
                                      ev["select"]["req"])
    # both exports carry the three fields
    rows = [json.loads(line) for line in tr.jsonl().splitlines()]
    assert {(r["id"], r["parent"], r["req"]) for r in rows} == {
        (e["id"], e["parent"], e["req"]) for e in tr.events()}
    for c in tr.chrome_trace()["traceEvents"]:
        assert {"id", "parent", "req"} <= set(c["args"])


def test_spans_leave_no_span_ms_histograms():
    reg = MetricsRegistry()
    tr = Tracer(registry=reg)
    with tr.span("launch", op="spmv"):
        pass
    assert reg.get("events.launch") == 1
    assert not [k for k in reg.snapshot() if k.startswith("span_ms.")]


def test_histogram_recent_keeps_the_ring_in_order():
    h = Histogram(sample_cap=4)
    assert h.recent(3) == []
    for v in (1.0, 2.0, 3.0):
        h.observe(v)
    assert h.recent(2) == [2.0, 3.0] and h.recent(10) == [1.0, 2.0, 3.0]
    for v in (4.0, 5.0, 6.0):
        h.observe(v)
    assert h.recent(4) == [3.0, 4.0, 5.0, 6.0]
    assert h.recent(2) == [5.0, 6.0] and h.recent(0) == []
    assert h.count == 6


def test_histogram_buckets_match_a_linear_scan():
    def scan(v):
        i = 0
        while i < len(HIST_BOUNDS_MS) and v > HIST_BOUNDS_MS[i]:
            i += 1
        return i

    rng = np.random.default_rng(0)
    values = list(10.0 ** rng.uniform(-4, 6, 500)) + list(HIST_BOUNDS_MS) \
        + [0.0, -1.0, math.inf, math.nan, 1e9]
    h = Histogram()
    want = [0] * (len(HIST_BOUNDS_MS) + 1)
    for v in values:
        h.observe(v)
        want[scan(v)] += 1
    assert h.buckets == want


def test_compile_span_on_a_library_first_load(monkeypatch, tmp_path,
                                              traced):
    """nvcc stubbed: the first load builds (``built`` True), a fresh
    process finding the hashed library does not; a loaded library emits
    nothing more."""
    runs = []

    class Done:
        returncode = 0
        stderr = ""

    def fake_nvcc(cmd, **kw):
        runs.append(cmd)
        out = cmd[cmd.index("-o") + 1]
        with open(out, "wb") as f:
            f.write(b"\0")
        return Done()

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "run", fake_nvcc)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: ("lib", path))
    monkeypatch.setattr(_build, "_LIBS", {})
    lib = _build.load("bsr_spmv")
    assert _build.load("bsr_spmv") is lib and len(runs) == 1
    monkeypatch.setattr(_build, "_LIBS", {})      # as a new process
    _build.load("bsr_spmv")
    assert len(runs) == 1
    compiles = [e for e in traced.events() if e["type"] == "compile"]
    assert [e["args"]["built"] for e in compiles] == [True, False]
    for e in compiles:
        assert e["args"]["key"] == "bsr_spmv" == e["name"]
        assert e["args"]["seconds"] >= 0


def test_a_forked_child_records_its_own_pid():
    """The tracer reads the process id once; a forked child reads it
    again."""
    r, w = os.pipe()
    pid = os.fork()
    if pid == 0:                                   # the child
        try:
            tr = Tracer(registry=MetricsRegistry())
            tr.instant("store_evict", "lru", reason="lru")
            os.write(w, str(tr.events()[0]["pid"] == os.getpid()).encode())
        finally:
            os._exit(0)
    os.close(w)
    try:
        got = os.read(r, 16)
    finally:
        os.close(r)
        os.waitpid(pid, 0)
    assert got == b"True"
    tr = Tracer(registry=MetricsRegistry())
    tr.instant("store_evict", "lru", reason="lru")
    assert tr.events()[0]["pid"] == os.getpid()
