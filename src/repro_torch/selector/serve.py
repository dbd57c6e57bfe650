"""Selector serving CLI: train once, then serve schedule requests online
(port of ``repro.selector.serve``).

Trains a ScheduleTuner on one corpus slice, then serves requests drawn from
a *held-out* slice (with repeat traffic, as production would see) through
the fingerprint -> cache -> tree -> verify-fallback pipeline, printing
per-batch bucket structure and final telemetry. With ``--execute`` each
bucket runs as one stacked launch on ``--device`` (the card by default:
the CUDA kernels; ``--device cpu`` runs their plain PyTorch versions).

Usage:
  PYTHONPATH=src python -m repro_torch.selector.serve --requests 24 --execute
  PYTHONPATH=src python -m repro_torch.selector.serve --device cpu --execute
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from ..core import PLATFORMS, ScheduleTuner, corpus
from ..obs import Tracer, default_registry, install_tracer
from ..sparse import resilience
from .cache import ScheduleCache
from .service import SelectorService


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--kernel", default="spmv",
                    choices=("spmv", "spgemm", "spadd"))
    ap.add_argument("--platform", default="h100_sxm",
                    choices=sorted(PLATFORMS))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where --execute runs the kernels (cpu: their "
                         "plain PyTorch versions)")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--train-mats", type=int, default=18)
    ap.add_argument("--serve-mats", type=int, default=9,
                    help="held-out matrices requests are drawn from")
    ap.add_argument("--n-min", type=int, default=256)
    ap.add_argument("--n-max", type=int, default=768)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--confidence-threshold", type=float, default=0.02)
    ap.add_argument("--prune-top-k", type=int, default=-1,
                    help="prune the fit() sweep with the provisional tree: "
                         "-1 = auto (prune once the grid passes the size "
                         "threshold), 0 = force the full sweep, k > 0 = "
                         "force top-k")
    ap.add_argument("--refit-every", type=int, default=0,
                    help="fold verify feedback into the tuner tree every N "
                         "serving ticks (0 = never)")
    ap.add_argument("--cache-path", default=None,
                    help="persist the schedule cache to this JSON file")
    ap.add_argument("--execute", action="store_true",
                    help="run the SpMV/SpMM kernel of each bucket, one "
                         "stacked launch per bucket")
    ap.add_argument("--fault-rate", type=float, default=0.0,
                    help="install a deterministic FaultInjector firing at "
                         "this rate across all sites (chaos mode)")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed of the fault injector's deterministic draws")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request admission deadline; requests past it "
                         "are shed, not served late")
    ap.add_argument("--trace-out", default=None, metavar="TRACE_JSON",
                    help="write a Chrome-trace/Perfetto JSON of the serve "
                         "here, plus a sibling .jsonl event log "
                         "(DESIGN.md §12)")
    ap.add_argument("--metrics-every", type=int, default=0, metavar="N",
                    help="print a metrics-registry delta snapshot every N "
                         "serving ticks (0 = never)")
    ap.add_argument("--metrics-out", default=None, metavar="METRICS_JSON",
                    help="write this run's metrics-registry snapshot delta "
                         "as JSON")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    registry = default_registry()
    base_snapshot = registry.snapshot()   # per-run delta baseline
    trace = None
    if args.trace_out:
        trace = install_tracer(Tracer(registry=registry))

    platform = PLATFORMS[args.platform]
    train = corpus(n_matrices=args.train_mats, n_min=args.n_min,
                   n_max=args.n_max, seed=args.seed)
    held = corpus(n_matrices=args.serve_mats, n_min=args.n_min,
                  n_max=args.n_max, seed=args.seed + 1000,
                  include_synthetic=False)

    t0 = time.time()
    tuner = ScheduleTuner(args.kernel, platform).fit(
        train, max_mats=args.train_mats,
        prune_top_k=("auto" if args.prune_top_k < 0
                     else args.prune_top_k or None))
    t_fit = time.time() - t0
    print(f"tuner fit: {len(train)} train mats, "
          f"{tuner.fit_simulations_} simulations, {t_fit:.1f}s")

    cache = ScheduleCache(path=args.cache_path)
    svc = SelectorService(tuner, cache=cache, batch_max=args.batch,
                          confidence_threshold=args.confidence_threshold,
                          refit_every=args.refit_every,
                          deadline_ms=args.deadline_ms, device=args.device)
    rng = np.random.default_rng(args.seed)
    expected = {}
    for r in range(args.requests):
        name, _, A = held[r % len(held)]
        x = rng.standard_normal(A.shape[1]).astype(np.float32) \
            if args.execute else None
        reqname = f"req{r}:{name}"
        svc.submit(reqname, A, x)
        if x is not None:
            expected[reqname] = (A, x)

    # chaos mode: the injector goes in AFTER fit (training has its own
    # fault-tolerance story) and stays in through cache.flush() so the
    # cache-write site is exercised too
    inj = None
    if args.fault_rate > 0:
        inj = resilience.install_injector(
            resilience.FaultInjector(args.fault_rate, seed=args.fault_seed))
        print(f"fault injector: rate {args.fault_rate} "
              f"seed {args.fault_seed} sites {', '.join(resilience.SITES)}")

    t0 = time.time()
    decisions = []
    tick = 0
    prev_snapshot = registry.snapshot()
    while svc.pending:
        decisions.extend(svc.process_pending())
        tick += 1
        if args.metrics_every and tick % args.metrics_every == 0:
            delta = registry.delta(prev_snapshot)
            prev_snapshot = registry.snapshot()
            moved = {k: v for k, v in delta.items()
                     if k.split(".")[0] in ("events", "selector",
                                            "select_ms", "launch_ms")}
            line = "  ".join(f"{k}={v:g}" for k, v in sorted(moved.items())
                             if not k.endswith(("p50_ms", "p95_ms",
                                                "p99_ms", "min_ms",
                                                "max_ms", "sum_ms")))
            print(f"[metrics tick {tick}] {line}")
    t_serve = time.time() - t0

    print(f"\n{'request':28s} {'source':7s} {'conf':>5s} "
          f"{'batch':>5s} {'bucket':>6s}  schedule")
    for d in decisions:
        s = d.schedule
        layout = (f"sell C={s.slice_height}" if s.layout == "sell"
                  else f"ell q={s.ell_quantile}")
        print(f"{d.name:28s} {d.source:7s} {d.confidence:5.2f} "
              f"{d.batch_id:5d} {d.bucket:6d}  {s.backend} bs={s.block_size} "
              f"{layout} rhs={s.n_rhs}")

    cache.flush()   # guarded: a failed flush is counted, never raised
    tel = svc.telemetry()
    if inj is not None:
        tel.update(inj.telemetry())
        resilience.install_injector(None)

    # observability exports (DESIGN.md §12): Chrome-trace JSON + JSONL event
    # log, and the run's metrics-registry delta — the per-event counts of
    # the two reconcile exactly
    if trace is not None:
        install_tracer(None)
        n_events = trace.write_chrome_trace(args.trace_out)
        stem, _ = os.path.splitext(args.trace_out)
        jsonl_path = stem + ".jsonl"
        trace.write_jsonl(jsonl_path)
        counts = trace.counts()
        tel["trace_events"] = float(n_events)
        print(f"trace: {n_events} events -> {args.trace_out} "
              f"(+ {jsonl_path})  "
              + "  ".join(f"{k}={v}" for k, v in sorted(counts.items())))
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(registry.delta(base_snapshot), f, indent=1,
                      sort_keys=True)
        print(f"metrics snapshot delta -> {args.metrics_out}")

    # Verify executed outputs — under fault injection this is the
    # acceptance check that fallback-chain results match the reference, not
    # merely that nothing crashed. A served y is correct if it matches the
    # exact dense product (what the dense rung and exact schedules compute)
    # OR the selected schedule's own unguarded reference run (lossy
    # ell-quantile schedules legitimately truncate; the injector is already
    # uninstalled so the reference build is clean). The schedule's own run
    # is its plain PyTorch version on the CPU, unguarded.
    from ..sparse.registry import get_op
    checked = mismatches = 0
    for d in decisions:
        if d.y is None or d.name not in expected:
            continue
        A, x = expected[d.name]
        checked += 1
        if np.allclose(d.y, A.to_dense().astype(np.float32) @ x,
                       rtol=2e-3, atol=2e-3):
            continue
        ref = get_op("spmv").planner((A,), d.schedule, "torch",
                                     device=torch.device("cpu")
                                     ).execute(x).numpy()
        if not np.allclose(d.y, ref, rtol=2e-3, atol=2e-3):
            mismatches += 1
    print(f"\nserved {args.requests} requests in {t_serve*1e3:.0f}ms "
          f"({t_serve / max(args.requests, 1) * 1e6:.0f}us/req)")
    print(f"cache hit rate {tel['cache_hit_rate']:.2f}  "
          f"tree served {tel['tree_served']:.0f}  "
          f"verify fallbacks {tel['verify_fallbacks']:.0f} "
          f"({tel['fallback_fraction']:.2f} of requests)")
    print(f"batches {tel['batches']:.0f}  kernel buckets {tel['buckets']:.0f} "
          f"(mean size {tel['mean_bucket_size']:.1f}, "
          f"max {tel['max_bucket_size']:.0f})  executed {tel['executed']:.0f}")
    print(f"prepared store: {tel['prep_entries']:.0f} entries, "
          f"hit rate {tel['prep_hit_rate']:.2f}, "
          f"{tel['prep_bytes_in_use'] / 1e6:.1f} MB resident  "
          f"refits {tel['refits']:.0f} (every {args.refit_every or '-'} ticks)")
    print(f"resilience: fallbacks {tel['guard_fallbacks']:.0f}  "
          f"nan trips {tel['guard_nan_trips']:.0f}  "
          f"dense served {tel['guard_dense_served']:.0f}  "
          f"quarantine {tel['quarantine_entries']:.0f} entries "
          f"(blocked {tel['quarantine_blocked']:.0f})  "
          f"shed {tel['shed_requests']:.0f}  "
          f"degraded ticks {tel['degraded_ticks']:.0f}")
    if inj is not None:
        by_site = "  ".join(f"{site}={n}" for site, n in
                            sorted(inj.fired.items()) if n)
        print(f"faults: fired {tel['fault_fired']:.0f} "
              f"recovered {tel['fault_recovered']:.0f} "
              f"(checks {tel['fault_checks']:.0f})  {by_site}")
    if args.execute:
        print(f"outputs verified vs dense reference: {checked} checked, "
              f"{mismatches} mismatches")
        n_meas = sum(1 for d in decisions if d.measured_ms is not None)
        n_resid = sum(1 for d in decisions if d.residual is not None)
        print(f"measured-latency feedback: {n_meas} decisions carry "
              f"wall-clock, {n_resid} carry model residuals "
              f"(--trace-out keeps them in the launch events)")
    if args.cache_path:
        print(f"cache persisted to {args.cache_path} "
              f"({tel['cache_entries']:.0f} entries)")
    tel["serve_s"] = t_serve
    tel["exec_checked"] = float(checked)
    tel["exec_mismatches"] = float(mismatches)
    return tel


if __name__ == "__main__":
    main()
