"""One run of one cell: set-up, the measured window, the readers, and the
check against the plain reference.

The entry the window drives is the port's plan/execute API as a solver or
a GNN layer uses it: a ``ScheduleTuner`` fitted on the configuration's
corpus behind a ``SelectorService``, ``repro_torch.sparse.plan(op, A,
selector=service)`` (the pick, host prep, the prepared store, the guard),
then ``Plan.execute`` for every op. The benchmark never names a schedule:
what the selector picks is what is measured.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import sys
import tempfile
import time
from typing import Dict, List, Optional

from . import manifest, reference, timeline
from .drive import Loop, Window, make_inputs

# top-level module names that no run may hold when it prints its result
BANNED = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def banned_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in BANNED)


@dataclasses.dataclass
class Context:
    """What the readers read."""
    work: Dict                      # n_rows, n_cols, nnz, k of the CSR
    window: Window
    setup_s: float
    plan_build_s: float
    store: Dict                     # the prepared store's telemetry
    memory_peak_bytes: Optional[int]
    spans: Optional[List[Dict]]     # the program's trace events (traced)
    timeline: Optional[timeline.Timeline]   # the device trace (traced)


@dataclasses.dataclass
class Outcome:
    pick: Dict
    correct: bool
    checks: Dict
    context: Context
    metrics: Dict


def generate(cell: manifest.Cell, seed: int) -> Dict:
    """The configuration's matrix, from ``seed``, as host arrays."""
    gen = manifest.generator(cell.package, cell.config["generator"])
    return gen.generate(cell.config["matrix"], seed)


def fit_tuner(cell: manifest.Cell):
    """The selector's cost tree, fitted on the configuration's corpus for
    the mix's right-hand-side width."""
    from repro_torch.core import PLATFORMS, ScheduleTuner, corpus
    sel = cell.config["selector"]
    train = corpus(**sel["corpus"])
    return ScheduleTuner(sel["kernel"], PLATFORMS[sel["platform"]],
                         n_rhs=int(cell.traffic["n_rhs"])).fit(
        train, max_mats=sel["corpus"]["n_matrices"])


def build_plan(cell: manifest.Cell, mat: Dict, tuner, device):
    """(plan, service, plan seconds): the service with the deployment's
    settings, and ``plan(op, A, selector=service)`` timed on the host."""
    from repro_torch.core.csr import CSR
    from repro_torch.selector import SelectorService
    from repro_torch.sparse import PreparedStore, plan
    sel = cell.config["selector"]
    A = CSR(mat["row_ptrs"].copy(), mat["col_idxs"].copy(),
            mat["vals"].copy(), tuple(mat["shape"]))
    svc = SelectorService(
        tuner, confidence_threshold=float(sel["confidence_threshold"]),
        prepared_store=PreparedStore(byte_budget=int(sel["store_bytes"])),
        device=device)
    t = time.monotonic()
    p = plan(cell.traffic["op"], A, selector=svc, device=device)
    return p, svc, time.monotonic() - t


def describe_pick(p) -> Dict:
    return {"pick": p.describe(), "source": p.source,
            "modeled_ms": (p.modeled_time_s * 1e3
                           if p.modeled_time_s else None),
            "confidence": p.confidence}


def _profiler(device):
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _read_timeline(prof) -> Optional[timeline.Timeline]:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return timeline.load(path)
    finally:
        os.unlink(path)


def _traced_window(loop: Loop, seconds: float, device):
    """The window with the profiler and the program's tracer on for its
    first ``TRACE_SECONDS`` only (``drive.py``). Returns the window, the
    program's spans and the device timeline; stderr compares the traced
    ops' host time with the rest's."""
    from repro_torch.obs import Tracer, install_tracer
    tracer = install_tracer(Tracer())
    prof = _profiler(device)
    prof.start()
    stopped = []

    def stop_trace() -> None:
        t = time.monotonic()
        prof.stop()
        install_tracer(None)
        stopped.append(time.monotonic() - t)

    win = loop.window(seconds, stop_trace=stop_trace)
    t = time.monotonic()
    tl = _read_timeline(prof)
    del prof
    n = win.traced_ops
    rest = win.execute_s[n:]
    print(f"spbench: traced {n} ops, {_mean_ms(win.execute_s[:n])} ms an "
          f"op; untraced {len(rest)} ops, {_mean_ms(rest)} ms an op; trace "
          f"stop {stopped[0]:.1f} s, export and read "
          f"{time.monotonic() - t:.1f} s", file=sys.stderr)
    return win, tracer.events(), tl


def _mean_ms(seconds: List[float]) -> str:
    return f"{1e3 * sum(seconds) / len(seconds):.4f}" if seconds else "-"


def read_metrics(cell: manifest.Cell, ctx: Context, traced: bool) -> Dict:
    """The cell's end-to-end metrics (untraced) or per-layer metrics
    (traced), each by its reader; a reader that finds nothing is left out."""
    out = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = manifest.reader(cell.package, m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def free_cuda() -> None:
    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run_cell(cell: manifest.Cell, seed: int, seconds: float, trace: bool,
             device="cuda", t0: Optional[float] = None,
             log=print) -> Outcome:
    """Set up, warm up, measure for ``seconds``, read, free the program,
    then check the kept products against the reference."""
    import torch
    t0 = time.monotonic() if t0 is None else t0
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mat = generate(cell, seed)
    n_rows, n_cols = (int(s) for s in mat["shape"])
    work = {"n_rows": n_rows, "n_cols": n_cols,
            "nnz": int(mat["row_ptrs"][-1]),
            "k": int(cell.traffic["n_rhs"])}
    tuner = fit_tuner(cell)
    p, svc, plan_build_s = build_plan(cell, mat, tuner, device)
    pick = describe_pick(p)
    log(json.dumps(pick), flush=True)
    inputs = make_inputs(cell.traffic, n_cols, seed, device)
    loop = Loop(cell.traffic, p.execute, inputs, seed, device)
    loop.warm()
    setup_s = time.monotonic() - t0

    spans = tl = None
    if trace:
        win, spans, tl = _traced_window(loop, seconds, device)
    else:
        win = loop.window(seconds)
    peak = (int(torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else None)
    ctx = Context(work=work, window=win, setup_s=setup_s,
                  plan_build_s=plan_build_s,
                  store=svc.prepared_store.telemetry(),
                  memory_peak_bytes=peak, spans=spans, timeline=tl)
    metrics = read_metrics(cell, ctx, trace)

    # the program's state goes before the reference runs on the card
    del p, svc, loop, inputs, tuner
    free_cuda()
    ref = reference.Reference(mat, device)
    correct, checks = reference.judge(ref, win.samples, cell.limits,
                                      win.ops, win.failed)
    return Outcome(pick=pick, correct=correct, checks=checks, context=ctx,
                   metrics=metrics)
