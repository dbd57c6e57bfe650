"""Trace replay: offered-QPS wall-clock replay + the serving report (port
of ``repro.serving.replay``).

``replay`` feeds a generated Zipf trace into a running engine at its
offered arrival times against the real clock: requests whose arrival time
has passed are submitted, the engine ticks whenever it has work, and the
loop ends when the trace is exhausted and the engine runs dry. When the
offered rate exceeds the engine's service rate the queue backs up and the
overload machinery (backpressure rejects, degrade, deadline sheds) engages
— which is the point: the replay measures the whole posture under load,
not the happy path.

``report`` condenses one replay into the serving scorecard the serve CLI
and the chip smoke's engine phase print: achieved throughput vs offered, batch
occupancy, p50/p95/p99 per-request latency, SLO attainment, shed/reject
rates, and PreparedStore eviction pressure — every number a view over the
MetricsRegistry counters the engine already ticks.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.csr import CSR
from ..obs import ordered
from .engine import ServingEngine
from .trace_gen import TraceRequest


def tenant_rhs(population: Sequence[Tuple[str, CSR]],
               seed: int = 0) -> List[np.ndarray]:
    """One deterministic RHS vector per tenant (requests of a tenant reuse
    it — the iterative-workload pattern)."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(A.shape[1]).astype(np.float32)
            for _, A in population]


def replay(engine: ServingEngine, trace: Sequence[TraceRequest],
           population: Sequence[Tuple[str, CSR]],
           rhs_seed: int = 0, execute: bool = True,
           max_wall_s: float = 300.0) -> Dict[str, float]:
    """Replay ``trace`` through ``engine`` at its offered arrival times
    (wall clock); returns :func:`report`. Submissions past the hard
    watermark are rejected by the engine and stay rejected — the replay
    never retries, exactly like a client that gave up."""
    xs = tenant_rhs(population, seed=rhs_seed) if execute else None
    t0 = engine.clock()
    i = 0
    while i < len(trace) or engine.backlog:
        now = engine.clock() - t0
        while i < len(trace) and trace[i].t_s <= now:
            tr = trace[i]
            name, A = population[tr.tenant]
            # rid = the trace name (unique per trace): a re-driven replay
            # after a crash re-offers the whole trace and the engine's
            # idempotency dedupe drops the already-answered suffix
            engine.submit(f"{tr.name}", A,
                          xs[tr.tenant] if xs is not None else None,
                          tenant=tr.tenant, rid=tr.name)
            i += 1
        if engine.backlog:
            engine.tick()
        elif i < len(trace):
            # idle gap before the next arrival: sleep it off (bounded so a
            # fake/frozen clock cannot wedge the loop)
            gap = trace[i].t_s - (engine.clock() - t0)
            if gap > 0:
                time.sleep(min(gap, 0.05))
        if engine.clock() - t0 > max_wall_s:
            break
    elapsed = max(engine.clock() - t0, 1e-9)
    offered = (len(trace) / max(trace[-1].t_s, 1e-9)) if trace else 0.0
    return report(engine, elapsed_s=elapsed, offered_qps=offered,
                  n_offered=len(trace))


def report(engine: ServingEngine, elapsed_s: float,
           offered_qps: Optional[float] = None,
           n_offered: int = 0) -> Dict[str, float]:
    """The serving scorecard for one replay (deterministic key order)."""
    tel = engine.telemetry()
    out = dict(tel)
    out.update({
        "elapsed_s": float(elapsed_s),
        "n_offered": float(n_offered),
        "offered_qps": float(offered_qps or 0.0),
        "achieved_qps": tel["completed"] / max(elapsed_s, 1e-9),
    })
    return ordered(out)
