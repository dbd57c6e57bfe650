"""Serving-engine CLI: train once, replay a Zipf trace under load (port
of ``repro.serving.serve``).

Trains a ScheduleTuner, builds a multi-tenant matrix population, generates
a seeded Zipf request trace at the offered QPS, and replays it through the
continuous-batching engine on ``--device`` (the card by default: the
CUDA kernels; ``--device cpu`` runs their plain PyTorch versions) —
printing the serving scorecard (throughput, occupancy, p50/p95/p99
latency, SLO attainment, shed/reject rates, store eviction pressure) and
optionally recording the full trace + metrics delta.

Usage:
  PYTHONPATH=src python -m repro_torch.serving.serve --requests 64 --qps 200
  PYTHONPATH=src python -m repro_torch.serving.serve --requests 128 \\
      --qps 800 --deadline-ms 100 --slo-ms 50 --trace-out serve_trace.json
  PYTHONPATH=src python -m repro_torch.serving.serve --device cpu \\
      --checkpoint-dir build/serve_ckpt
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

from ..core import PLATFORMS, ScheduleTuner, corpus
from ..obs import Tracer, default_registry, install_tracer
from ..selector import ScheduleCache, SelectorService
from ..sparse import PreparedStore, resilience
from .checkpoint import EngineCheckpoint
from .engine import ServingEngine
from .journal import RequestJournal, reconcile
from .replay import replay, tenant_rhs
from .supervisor import run_with_restarts
from .trace_gen import generate_trace, tenant_population


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--kernel", default="spmv", choices=("spmv",))
    ap.add_argument("--platform", default="h100_sxm",
                    choices=sorted(PLATFORMS))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the engine runs the kernels (cpu: their "
                         "plain PyTorch versions)")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--qps", type=float, default=200.0,
                    help="offered request rate of the generated trace")
    ap.add_argument("--tenants", type=int, default=8,
                    help="multi-tenant matrix population size")
    ap.add_argument("--zipf-a", type=float, default=1.1,
                    help="Zipf popularity exponent over tenants")
    ap.add_argument("--train-mats", type=int, default=9)
    ap.add_argument("--n-min", type=int, default=256)
    ap.add_argument("--n-max", type=int, default=384)
    ap.add_argument("--slot-max", type=int, default=8,
                    help="max requests one slot (= one stacked launch) holds")
    ap.add_argument("--queue-max", type=int, default=128,
                    help="hard backpressure watermark (reject past it)")
    ap.add_argument("--admit-max", type=int, default=16,
                    help="queue slice admitted into slots per tick")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request deadline; expired requests are shed "
                         "at drain, never executed")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="latency SLO for the attainment metric")
    ap.add_argument("--no-batching", action="store_true",
                    help="per-request baseline: slots drain at size 1")
    ap.add_argument("--no-execute", action="store_true",
                    help="selection-only requests (no RHS, no kernel)")
    ap.add_argument("--store-budget-mb", type=float, default=None,
                    help="PreparedStore byte budget in MB (pressure runs)")
    ap.add_argument("--fault-rate", type=float, default=0.0)
    ap.add_argument("--fault-seed", type=int, default=0)
    ap.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                    help="durable serving (DESIGN.md §15): write-ahead "
                         "request journal + engine checkpoints here and "
                         "run the replay under the run_with_restarts "
                         "supervisor")
    ap.add_argument("--checkpoint-every", type=int, default=16,
                    help="snapshot learned state every N engine ticks "
                         "(plus once on clean shutdown)")
    ap.add_argument("--max-restarts", type=int, default=3,
                    help="restart budget of the crash supervisor")
    ap.add_argument("--trace-out", default=None, metavar="TRACE_JSON",
                    help="write Chrome-trace JSON + sibling .jsonl here")
    ap.add_argument("--metrics-out", default=None, metavar="METRICS_JSON")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    registry = default_registry()
    base_snapshot = registry.snapshot()
    trace = None
    if args.trace_out:
        trace = install_tracer(Tracer(registry=registry))

    platform = PLATFORMS[args.platform]
    t0 = time.time()
    tuner = ScheduleTuner(args.kernel, platform).fit(
        corpus(n_matrices=args.train_mats, n_min=args.n_min,
               n_max=args.n_max, seed=args.seed),
        max_mats=args.train_mats)
    print(f"tuner fit: {args.train_mats} mats, "
          f"{tuner.fit_simulations_} simulations, {time.time() - t0:.1f}s")

    population = tenant_population(args.tenants, n_min=args.n_min,
                                   n_max=args.n_max, seed=args.seed + 500)
    offered = generate_trace(args.requests, args.qps, args.tenants,
                             a=args.zipf_a, seed=args.seed)

    def build_engine():
        store = (PreparedStore(byte_budget=int(args.store_budget_mb * 2**20))
                 if args.store_budget_mb else PreparedStore())
        svc = SelectorService(tuner, cache=ScheduleCache(),
                              prepared_store=store, device=args.device)
        journal = checkpointer = None
        if args.checkpoint_dir:
            journal = RequestJournal(
                os.path.join(args.checkpoint_dir, "journal"))
            checkpointer = EngineCheckpoint(args.checkpoint_dir)
        return ServingEngine(svc, queue_max=args.queue_max,
                             admit_max=args.admit_max,
                             slot_max=args.slot_max,
                             deadline_ms=args.deadline_ms,
                             slo_ms=args.slo_ms,
                             batching=not args.no_batching,
                             journal=journal, checkpointer=checkpointer,
                             checkpoint_every=args.checkpoint_every)

    inj = None
    if args.fault_rate > 0:
        inj = resilience.install_injector(
            resilience.FaultInjector(args.fault_rate, seed=args.fault_seed))
        print(f"fault injector: rate {args.fault_rate} seed {args.fault_seed}")

    if args.checkpoint_dir:
        # durable path (DESIGN.md §15): the whole replay runs under the
        # restart supervisor — crashes restore the newest checkpoint,
        # replay the journal suffix, and re-drive the (idempotent) trace
        xs = tenant_rhs(population, seed=args.seed) \
            if not args.no_execute else None

        def resolve(rec):
            t = int(rec.get("tenant", -1))
            if 0 <= t < len(population):
                return population[t][1], (xs[t] if xs is not None else None)
            return None

        summary = run_with_restarts(
            build_engine,
            lambda engine, attempt: replay(engine, offered, population,
                                           rhs_seed=args.seed,
                                           execute=not args.no_execute),
            resolve=resolve, max_restarts=args.max_restarts)
        rep = summary.pop("result")
        rep.update({f"recovery_{k}": float(v) for k, v in summary.items()})
        scan = RequestJournal(
            os.path.join(args.checkpoint_dir, "journal")).scan()
        ledger = reconcile(scan)
        print(f"durable: restarts {summary['restarts']:.0f}  replayed "
              f"{summary['replayed']:.0f}  dropped_corrupt "
              f"{summary['dropped_corrupt']:.0f}  mttr "
              f"{summary['mttr_ms']:.1f}ms")
        print("journal ledger: " + "  ".join(
            f"{k} {v:.0f}" for k, v in ledger.items()))
    else:
        rep = replay(build_engine(), offered, population, rhs_seed=args.seed,
                     execute=not args.no_execute)
    if inj is not None:
        rep.update(inj.telemetry())
        resilience.install_injector(None)

    print(f"\nreplayed {args.requests} requests over {args.tenants} tenants "
          f"(zipf a={args.zipf_a}, seed {args.seed})")
    print(f"offered {rep['offered_qps']:.0f} qps -> achieved "
          f"{rep['achieved_qps']:.0f} qps in {rep['elapsed_s'] * 1e3:.0f}ms")
    print(f"ledger: submitted {rep['submitted']:.0f}  "
          f"rejected {rep['rejected']:.0f}  admitted {rep['admitted']:.0f}  "
          f"completed {rep['completed']:.0f}  shed {rep['shed']:.0f}")
    print(f"drains {rep['drains']:.0f} (multi-request "
          f"{rep['multi_request_drains']:.0f}, mean occupancy "
          f"{rep['mean_drain_size']:.1f}, resident admits "
          f"{rep['resident_admits']:.0f})")
    print(f"latency ms: p50 {rep['latency_p50_ms']:.2f}  "
          f"p95 {rep['latency_p95_ms']:.2f}  p99 {rep['latency_p99_ms']:.2f}  "
          f"slo attainment {rep['slo_attainment']:.2f}")
    print(f"pressure: shed rate {rep['shed_rate']:.2f}  reject rate "
          f"{rep['reject_rate']:.2f}  degrade signals "
          f"{rep['degrade_signals']:.0f}  store eviction pressure "
          f"{rep['prep_eviction_pressure']:.2f} "
          f"({rep['prep_bytes_in_use'] / 1e6:.1f} MB resident)")

    if trace is not None:
        install_tracer(None)
        n_events = trace.write_chrome_trace(args.trace_out)
        stem, _ = os.path.splitext(args.trace_out)
        trace.write_jsonl(stem + ".jsonl")
        counts = trace.counts()
        rep["trace_events"] = float(n_events)
        print(f"trace: {n_events} events -> {args.trace_out} "
              f"(+ {stem}.jsonl)  "
              + "  ".join(f"{k}={v}" for k, v in sorted(counts.items())))
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(registry.delta(base_snapshot), f, indent=1,
                      sort_keys=True)
        print(f"metrics snapshot delta -> {args.metrics_out}")
    return rep


if __name__ == "__main__":
    main()
