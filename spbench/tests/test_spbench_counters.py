"""The readers of the program's own counters (``spbench/counters.py``):
the plan build's phases and ``Plan.execute``'s host time, read from the
program's registry after the window; nothing off the card or from a
program without the counter. And the device timeline naming an idle gap by
the program's span that the profiler recorded."""
import importlib
import statistics

import numpy as np
import pytest

import repro_torch.obs as obs
from spbench import manifest, timeline
from spbench.drive import Window
from spbench.harness import Context
from spbench.metrics import (facade_host_ms, plan_bucket_s,
                             plan_container_s, plan_select_s, plan_upload_s)

SUMS = {plan_select_s: "select_ms", plan_container_s: "prep_ms.container",
        plan_bucket_s: "prep_ms.bucket", plan_upload_s: "prep_ms.upload"}
READERS = list(SUMS) + [facade_host_ms]


def _ctx(ops=10, traced_ops=4, on_card=True):
    win = Window(ops=ops, failed=0, wall_s=1.0, latencies_s=[],
                 execute_s=[], samples=[], traced_ops=traced_ops,
                 untraced_s=0.5)
    return Context(work={}, window=win, setup_s=60.0, plan_build_s=40.0,
                   store={}, memory_peak_bytes=2 ** 30 if on_card else None,
                   spans=[], timeline=None)


@pytest.fixture
def registry(monkeypatch):
    reg = obs.MetricsRegistry()
    monkeypatch.setattr(obs, "default_registry", lambda: reg)
    return reg


def test_the_plan_phases_read_their_seconds(registry):
    registry.observe("select_ms", 1500.0)
    registry.observe("prep_ms.container", 4000.0)
    registry.observe("prep_ms.container", 250.0)
    registry.observe("prep_ms.bucket", 3560.0)
    registry.observe("prep_ms.upload", 12000.0)
    ctx = _ctx()
    assert plan_select_s.read(ctx) == pytest.approx(1.5)
    assert plan_container_s.read(ctx) == pytest.approx(4.25)
    assert plan_bucket_s.read(ctx) == pytest.approx(3.56)
    assert plan_upload_s.read(ctx) == pytest.approx(12.0)


def test_facade_host_reads_the_untraced_ops_only(registry):
    # two warm-up ops and four traced ones under the profiler, then six
    for v in [9.0, 9.0] + [5.0] * 4 + [0.4, 0.2, 0.3, 0.6, 0.5, 0.1]:
        registry.observe("launch_host_ms.spmv", v)
    ctx = _ctx(ops=10, traced_ops=4)
    assert facade_host_ms.read(ctx) == pytest.approx(0.35)
    # traced to its end: nothing untraced to read
    assert facade_host_ms.read(_ctx(ops=10, traced_ops=10)) is None
    # more untraced ops than the histogram keeps: what it keeps
    assert facade_host_ms.read(_ctx(ops=10 ** 5, traced_ops=4)) \
        == pytest.approx(statistics.median(
            [9.0, 9.0] + [5.0] * 4 + [0.4, 0.2, 0.3, 0.6, 0.5, 0.1]))


def test_two_ops_in_one_registry_are_not_read(registry):
    registry.observe("launch_host_ms.spmv", 1.0)
    registry.observe("launch_host_ms.spmm", 1.0)
    assert facade_host_ms.read(_ctx()) is None


def test_off_the_card_nothing_is_read(registry):
    for name in SUMS.values():
        registry.observe(name, 1.0)
    registry.observe("launch_host_ms.spmv", 1.0)
    ctx = _ctx(ops=2, traced_ops=1, on_card=False)
    for reader in READERS:
        assert reader.read(ctx) is None, reader.__name__


def test_a_program_without_the_counters_reads_nothing(registry,
                                                      monkeypatch):
    ctx = _ctx()
    for reader in READERS:
        assert reader.read(ctx) is None, reader.__name__

    class Old:
        """A histogram with no ``recent`` view."""
        count, sum = 3, 3.0

    registry.observe("launch_host_ms.spmv", 1.0)
    monkeypatch.setattr(registry, "histogram", lambda name: Old())
    assert facade_host_ms.read(ctx) is None


def test_the_readers_on_the_program_itself(registry, monkeypatch):
    """One CPU plan and three executes, the program observing into the
    test's registry: each phase reader reads its histogram's seconds, and
    the facade the last two executes."""
    from repro_torch.core import Schedule, gen_zipf
    from repro_torch.sparse import PreparedStore, plan
    for mod in ("plan", "tensor"):
        monkeypatch.setattr(importlib.import_module(
            f"repro_torch.sparse.{mod}"), "default_registry",
            lambda: registry)
    p = plan("spmv", gen_zipf(256, seed=9),
             schedule=Schedule("bsr", 32, 1.0), store=PreparedStore(),
             device="cpu")
    for _ in range(3):
        p.execute(np.ones(256, np.float32))
    ctx = _ctx(ops=3, traced_ops=1)
    assert plan_select_s.read(ctx) is None           # no selector here
    for reader, name in list(SUMS.items())[1:]:
        h = registry.histogram(name)
        assert h.count == 1 and reader.read(ctx) == pytest.approx(
            h.sum / 1e3), name
    h = registry.histogram("launch_host_ms.spmv")
    assert h.count == 3
    assert facade_host_ms.read(ctx) == pytest.approx(
        statistics.median(h.recent(2)))


def test_the_manifest_names_the_new_readers():
    names = {m["name"]: m for m in manifest.load_manifest()["per_layer"]}
    for name, layer in [("facade_host_ms.spmv", "facade"),
                        ("facade_host_ms.spmm", "facade"),
                        ("plan_select_s", "selector"),
                        ("plan_container_s", "plan build"),
                        ("plan_bucket_s", "plan build"),
                        ("plan_upload_s", "store")]:
        m = names[name]
        assert m["source"] == "program_counter" and m["layer"] == layer
        reader = manifest.reader(manifest.PACKAGE, name)
        assert reader.__file__.endswith(f"{name.split('.')[0]}.py")


def _x(cat, name, ts, dur, tid=1, pid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": pid, "tid": tid, "args": args}


def test_an_idle_gap_is_named_by_the_program_span_around_it():
    """The program's spans, recorded by the profiler as ranges inside the
    step, name the gaps that the step's own range named before."""
    ev = [
        _x("user_annotation", "spbench.window", 0, 100),
        _x("user_annotation", "spbench.execute", 10, 85),
        _x("user_annotation", "launch:spmv", 11, 83),
        _x("user_annotation", "stage:spmv", 12, 18),
        _x("user_annotation", "kernel:bsr_spmv_cuda", 30, 4),
        _x("cuda_runtime", "cudaLaunchKernel", 31, 1, correlation=2),
        _x("user_annotation", "wait:spmv", 34, 46),
        _x("user_annotation", "sync:spmv", 80, 13),
        _x("kernel", "fill_kernel", 0, 14, pid=0, tid=7, correlation=1),
        _x("kernel", "void bsr_spmv_counted_kernel<false>", 36, 44, pid=0,
           tid=7, correlation=2),
    ]
    tl = timeline.parse({"traceEvents": ev})
    idle = dict(tl.breakdown()["idle_gaps"])
    # idle 14-36 (mid 25, staging) and 80-100 (mid 90, the sync)
    assert idle == {"stage:spmv": pytest.approx(22e-6),
                    "sync:spmv": pytest.approx(20e-6)}
