"""The restart supervisor: crashes become restarts, not lost traffic
(port of ``repro.serving.supervisor``; DESIGN.md §15).

``run_with_restarts`` is the serving-side sibling of the reference's
training supervisor (``repro.train.fault_tolerance``): build an engine incarnation,
restore the newest valid checkpoint, replay the journal's non-terminal
suffix, then hand the engine to the caller's ``drive``. A crash —
``SimulatedCrash`` from the ``crash`` fault site, or any guarded failure
that escaped every inner ladder — is caught HERE and only here: the
supervisor counts the restart, backs off exponentially, and brings up the
next incarnation against the same journal/checkpoint directory.

Recovery telemetry flows through the MetricsRegistry ``recovery`` scope
(``replayed``, ``dropped_corrupt``, ``restarts``, ``unresolvable``, and an
``mttr_ms`` gauge measured crash-to-recovered on the supervisor's clock)
and through the tracer's ``restart``/``recovery`` events, so a post-mortem
reads the whole restart history off one snapshot.

Invariants the crash-replay harness machine-checks across incarnations:
* no journaled-admitted request is lost (journal ``open == 0`` at the end);
* no request executes twice (idempotency rids dedupe at submit and drain);
* ``admitted == completed + shed`` holds in the final registry AND summed
  across incarnations via the journal's distinct-rid ledger.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

from ..obs import default_registry, ordered
from ..obs import trace as obs_trace
from ..sparse import resilience
from ..sparse.resilience import GUARDED_EXCEPTIONS, SimulatedCrash


def recover_engine(engine, resolve: Optional[Callable[[Dict], Any]] = None,
                   metrics=None) -> Dict[str, float]:
    """Restore one fresh incarnation: newest valid checkpoint, then the
    journal's non-terminal suffix. Corrupt artifacts (checksum-failed
    checkpoints, torn journal tails, a checkpoint newer than the journal)
    cold-start the affected component and are counted — never raised.

    ``resolve(record) -> (csr, x) | None`` maps a journal record back to
    its operands (the record carries the logical request — rid, name,
    tenant, deadline — not matrix bytes); an unresolvable record is closed
    with a ``shed`` tombstone so the cross-incarnation ledger still sums.
    """
    replayed = 0
    dropped = 0
    unresolvable = 0
    skip_replay = False
    payload = None
    if engine.checkpointer is not None:
        payload, d = engine.checkpointer.load_latest()
        dropped += d
    if engine.journal is not None and payload is not None:
        scan = engine.journal.scan()
        if int(payload.get("journal_lsn", 0) or 0) > scan.last_lsn:
            # checkpoint newer than journal: the WAL lost its tail (records
            # the snapshot already counted terminal), so replaying what's
            # left could double-serve answered requests. Cold-start the
            # journal's view instead: count it, skip the replay.
            dropped += 1
            skip_replay = True
    if payload is not None:
        engine.restore_state(payload)
    if engine.journal is not None and not skip_replay:
        scan = engine.journal.scan()
        dropped += scan.dropped_corrupt
        engine.seed_terminal(scan.terminal)
        for rec in scan.pending:
            operands = resolve(rec) if resolve is not None else None
            if operands is None:
                unresolvable += 1
                engine.journal.append_outcome(str(rec.get("rid", "")), "shed")
                continue
            csr, x = operands
            engine.submit(str(rec.get("name", "replay")), csr, x,
                          deadline_ms=rec.get("deadline_ms"),
                          tenant=int(rec.get("tenant", -1)),
                          rid=str(rec.get("rid", "")))
            replayed += 1
    if metrics is not None:
        metrics.inc("replayed", replayed)
        metrics.inc("dropped_corrupt", dropped)
        metrics.inc("unresolvable", unresolvable)
    obs_trace.emit("recovery", "restore", replayed=replayed,
                   dropped_corrupt=dropped, unresolvable=unresolvable,
                   from_checkpoint=payload is not None)
    return {"replayed": float(replayed), "dropped_corrupt": float(dropped),
            "unresolvable": float(unresolvable),
            "from_checkpoint": 1.0 if payload is not None else 0.0}


def run_with_restarts(build: Callable[[], Any],
                      drive: Callable[[Any, int], Any], *,
                      resolve: Optional[Callable[[Dict], Any]] = None,
                      max_restarts: int = 8,
                      backoff_base_s: float = 0.01,
                      sleep: Callable[[float], None] = time.sleep,
                      clock: Callable[[], float] = time.monotonic
                      ) -> Dict[str, Any]:
    """Run ``drive(engine, attempt)`` under a bounded-restart supervisor.

    ``build()`` constructs one engine incarnation (wired with the shared
    journal/checkpointer); each incarnation is recovered before it drives.
    On a crash the supervisor backs off ``backoff_base_s * 2**attempt``,
    rebuilds, re-recovers, re-drives — ``drive`` must therefore be
    idempotent under re-offering, which the engine's rid dedupe makes true
    for trace replays. Exceeding ``max_restarts`` re-raises the last crash
    (the process really is down; a supervisor that retries forever hides
    a hard fault).

    Returns ``{"result", "restarts", "replayed", "dropped_corrupt",
    "unresolvable", "mttr_ms"}``.
    """
    metrics = default_registry().scope("recovery")
    for k in ("replayed", "dropped_corrupt", "restarts", "unresolvable"):
        metrics.set(k, metrics.get(k))
    restarts = 0
    totals = {"replayed": 0.0, "dropped_corrupt": 0.0, "unresolvable": 0.0}
    mttr_ms = 0.0
    t_crash: Optional[float] = None
    while True:
        engine = build()
        rec = recover_engine(engine, resolve=resolve, metrics=metrics)
        for k in totals:
            totals[k] += rec[k]
        if t_crash is not None:
            # MTTR: crash caught -> new incarnation recovered (checkpoint
            # restored + journal suffix re-submitted, ready to drive)
            mttr_ms = (clock() - t_crash) * 1e3
            metrics.registry.set_gauge(metrics.key("mttr_ms"), mttr_ms)
            t_crash = None
        try:
            result = drive(engine, restarts)
            engine.close()
            return dict(totals, result=result, restarts=float(restarts),
                        mttr_ms=mttr_ms)
        except (SimulatedCrash,) + GUARDED_EXCEPTIONS as e:
            t_crash = clock()
            try:
                if engine.journal is not None:
                    engine.journal.close()
            except OSError:
                pass
            if isinstance(e, SimulatedCrash):
                resilience.note_recovery("crash")
            elif isinstance(e, resilience.InjectedFault):
                resilience.note_recovery(e.site)
            restarts += 1
            metrics.inc("restarts")
            obs_trace.emit("restart", type(e).__name__, attempt=restarts,
                           reason=str(e) or type(e).__name__)
            if restarts > max_restarts:
                raise
            sleep(backoff_base_s * (2 ** (restarts - 1)))


def recovery_telemetry() -> Dict[str, float]:
    """Process-wide recovery counters (all ``recovery.*`` scopes summed) —
    the smoke gate's reconciliation view."""
    reg = default_registry()
    out = {}
    for k in ("replayed", "dropped_corrupt", "restarts", "unresolvable"):
        total = 0.0
        for name, v in reg.snapshot().items():
            if name.startswith("recovery.") and name.endswith("." + k):
                total += v
        out[k] = total
    return ordered(out)
