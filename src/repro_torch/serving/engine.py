"""The continuous-batching serving engine (port of
``repro.serving.engine``; DESIGN.md §13).

One object in front of ``SelectorService``/``plan_bucket`` that turns the
port's selection + resilience + observability machinery into a
load-bearing serving loop:

    submit() --> BoundedQueue --> admission (select + slot assign)
                                        |
                                  SlotTable[(schedule, resident)]
                                        |
    tick() ----------------------> drain ONE slot == ONE stacked launch
                                        |
                              per-request latency / SLO / shed ledger

* **Admission** decides each request's Schedule through the service
  (``select``: fingerprint -> cache -> tree -> verify) and assigns it to a
  slot keyed by (schedule bucket, PreparedStore residency) — the two axes
  that determine what a drain actually costs (kernel, host prep).
* **Each tick drains one slot** through ``SelectorService.drain_bucket`` —
  one stacked launch for every request in the slot (a content-pure slot of
  several requests is one multi-RHS launch), with the service's
  retry/backoff, guard, and measured-latency feedback all engaged
  underneath. The launch runs on the service's ``device``: the card
  unless the service was built with ``device="cpu"``.
* **Overload is explicit**: the queue's hard watermark rejects, the soft
  watermark degrades selection (``enter_degraded``), and deadline-expired
  requests are shed at drain time — never executed. The ledger identity
  ``admitted == completed + shed`` holds exactly once the engine runs dry.
* **Deterministic under test**: the clock is injectable; every event
  (``enqueue`` / ``admit`` / ``drain`` / ``shed``) flows through the obs
  Tracer and reconciles with the MetricsRegistry by construction.

Threading: ``start()`` runs the tick loop on a dedicated serving thread —
the ONE thread that touches the service/plan stack (which is
single-threaded), with the service's CUDA device made current in it.
Producers on any thread may call ``submit``: one lock serializes each
submit with the others and with the serving thread's tombstones, so the
ledger counters (read-modify-write), the idempotency sets (check then
act) and the journal's appends stay exact; the Tracer locks internally.
(The reference engine takes no lock, and several producer threads lose
``submitted`` updates there.)
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..core.csr import CSR
from ..obs import CounterDict, default_registry, ordered
from ..obs import trace as obs_trace
from ..selector.service import Decision, Request, SelectorService
from ..sparse import resilience
from ..sparse.resilience import Deadline
from .admission import BoundedQueue, EngineRequest
from .slots import SlotTable


class ServingEngine:
    """Slot-based continuous batching in front of a SelectorService."""

    def __init__(self, service: SelectorService, *,
                 queue_max: int = 256,
                 soft_watermark: Optional[int] = None,
                 admit_max: int = 32,
                 slot_max: int = 16,
                 deadline_ms: Optional[float] = None,
                 slo_ms: Optional[float] = None,
                 backend: str = "auto",
                 batching: bool = True,
                 clock: Optional[Callable[[], float]] = None,
                 journal=None,
                 checkpointer=None,
                 checkpoint_every: int = 0) -> None:
        self.service = service
        self.clock = clock if clock is not None else time.monotonic
        self.queue = BoundedQueue(queue_max, soft_watermark)
        # batching=False is the per-request baseline: every slot drains at
        # size 1, so each request pays its own dispatch — same selection,
        # same guard, no stacking.
        self.batching = bool(batching)
        self.slots = SlotTable(slot_max if self.batching else 1)
        self.admit_max = max(int(admit_max), 1)
        self.deadline_ms = deadline_ms
        self.slo_ms = slo_ms
        self.backend = backend
        # durability (DESIGN.md §15): WAL every submit/outcome through the
        # journal, snapshot learned state every ``checkpoint_every`` ticks
        # (and on clean shutdown) through the checkpointer
        self.journal = journal
        self.checkpointer = checkpointer
        self.checkpoint_every = max(int(checkpoint_every), 0)
        self._ticks = 0
        # idempotency sets: rids currently inside the engine, and rids with
        # a terminal outcome (seeded from the journal scan on recovery) —
        # a duplicate submit of either is dropped, so no request can ever
        # execute twice across incarnations
        self._inflight: set = set()
        self._terminal: set = set()
        self._metrics = default_registry().scope("engine")
        self._counts = CounterDict(self._metrics, (
            "submitted", "rejected", "admitted", "shed", "completed",
            "drains", "multi_request_drains", "drained_members",
            "resident_admits", "degrade_signals", "slo_attained",
            "slo_missed", "duplicate_submits", "drain_dedups",
            "checkpoints"))
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._lock = threading.Lock()

    # -------------------------------------------------------------- ingress
    @property
    def backlog(self) -> int:
        """Requests inside the engine (queued + slotted, not yet drained)."""
        return len(self.queue) + self.slots.backlog()

    def submit(self, name: str, csr: CSR, x: Optional[np.ndarray] = None,
               deadline_ms: Optional[float] = None,
               tenant: int = -1, rid: Optional[str] = None) -> bool:
        """Offer one request. Returns False when the hard watermark
        rejects it (backpressure) — the caller's signal to back off.

        ``rid`` is the idempotency key (DESIGN.md §15): callers that may
        re-offer after a crash (journal replay, a re-driven trace) pass a
        stable one; a rid already in flight or already terminal is dropped
        as a duplicate (returns True — the request IS accounted for) so no
        request can execute twice across incarnations."""
        with self._lock:
            return self._submit(name, csr, x, deadline_ms, tenant, rid)

    def _submit(self, name: str, csr: CSR, x: Optional[np.ndarray],
                deadline_ms: Optional[float], tenant: int,
                rid: Optional[str]) -> bool:
        now = self.clock()
        rid = rid if rid else f"{name}#{int(self._counts['submitted'])}"
        if rid in self._inflight or rid in self._terminal:
            self._counts["duplicate_submits"] += 1
            return True
        self._counts["submitted"] += 1
        ms = deadline_ms if deadline_ms is not None else self.deadline_ms
        if self.journal is not None:
            # WAL before admission: the journal record exists before the
            # queue can accept (or reject) the request
            self.journal.append_submit(rid, name, tenant=tenant,
                                       deadline_ms=ms)
        req = EngineRequest(
            name, csr, x, t_enqueue=now,
            deadline=(Deadline.after_ms(ms, now=now) if ms is not None
                      else None),
            tenant=tenant, rid=rid)
        if not self.queue.push(req):
            self._counts["rejected"] += 1
            self._terminal.add(rid)
            if self.journal is not None:
                self.journal.append_outcome(rid, "rejected")
            return False
        self._inflight.add(rid)
        if self.queue.over_soft:
            # soft watermark: shed the verify sweep while the queue is
            # backed up — selection gets cheaper exactly under pressure
            self.service.enter_degraded("queue-depth")
            self._counts["degrade_signals"] += 1
        return True

    # ------------------------------------------------------------ admission
    def _admit(self) -> int:
        """Move up to ``admit_max`` queued requests into slots: decide a
        Schedule per request (the service's cache/tree/verify path) and key
        the slot by (schedule, PreparedStore residency)."""
        admitted = 0
        store = self.service.prepared_store
        while len(self.queue) and admitted < self.admit_max:
            er = self.queue.pop()
            dec = self.service.select(er.csr, name=er.name)
            resident = bool(dec.ck) and store.resident(dec.ck)
            sreq = Request(er.name, er.csr, er.x, ck=dec.ck)
            slot = self.slots.assign((er, sreq, dec), dec.schedule, resident,
                                     affinity=dec.ck)
            self._counts["admitted"] += 1
            if resident:
                self._counts["resident_admits"] += 1
            obs_trace.emit("admit", er.name, slot=slot.label,
                           resident=resident, occupancy=len(slot.members))
            admitted += 1
        return admitted

    # ---------------------------------------------------------------- drain
    def _terminal_outcome(self, er: EngineRequest, outcome: str) -> None:
        """Tombstone one request: idempotency bookkeeping + WAL record."""
        with self._lock:
            if er.rid:
                self._inflight.discard(er.rid)
                self._terminal.add(er.rid)
            if self.journal is not None:
                self.journal.append_outcome(er.rid, outcome)

    def _shed(self, er: EngineRequest) -> None:
        self._counts["shed"] += 1
        self._terminal_outcome(er, "shed")
        obs_trace.emit("shed", er.name, reason="deadline")

    def _drain_one(self) -> int:
        """Drain the pick-policy slot as ONE stacked launch; returns the
        number of requests completed. Deadline-expired members are shed
        here — answered without execution — so a launch never burns device
        time on a request whose caller has already given up."""
        slot = self.slots.pick()
        if slot is None:
            return 0
        self.slots.take(slot)
        now = self.clock()
        live: List[Tuple[EngineRequest, Request, Decision]] = []
        for er, sreq, dec in slot.members:
            if er.rid and er.rid in self._terminal:
                # idempotency key on drain (defense-in-depth — submit
                # already dedupes): a rid answered by an earlier
                # incarnation's execution is never executed again; it
                # counts completed so the ledger pairs with its admit
                self._counts["drain_dedups"] += 1
                self._counts["completed"] += 1
            elif er.deadline is not None and er.deadline.exceeded(now):
                self._shed(er)
            else:
                live.append((er, sreq, dec))
        if not live:
            return 0
        # canonical member order: the bucket store keys on the ordered
        # member content-key tuple, so sorting makes recurring compositions
        # hit the stacked-container cache regardless of arrival interleaving
        live.sort(key=lambda t: (t[2].ck or "", t[1].name))
        with obs_trace.span("drain", slot.label, slot=slot.label,
                            n_requests=len(live), resident=slot.resident,
                            n_shed=len(slot.members) - len(live)):
            self.service.drain_bucket([(sreq, dec) for _, sreq, dec in live],
                                      backend=self.backend)
        t_done = self.clock()
        reg = self._metrics.registry
        for er, _, _ in live:
            lat_ms = (t_done - er.t_enqueue) * 1e3
            reg.observe(self._metrics.key("request_ms"), lat_ms)
            self._counts["completed"] += 1
            self._terminal_outcome(er, "completed")
            if self.slo_ms is not None:
                key = ("slo_attained" if lat_ms <= self.slo_ms
                       else "slo_missed")
                self._counts[key] += 1
        self._counts["drains"] += 1
        self._counts["drained_members"] += len(live)
        if len(live) >= 2:
            self._counts["multi_request_drains"] += 1
        return len(live)

    # ----------------------------------------------------------------- loop
    def _crash_point(self, where: str) -> None:
        """The ``crash`` fault site (DESIGN.md §15): simulated process
        death between two ticks (or between admission and drain — the
        mid-drain crash point). Raises ``SimulatedCrash`` (a BaseException)
        so NOTHING below the run_with_restarts supervisor can absorb it."""
        if resilience.fault_fired("crash", where):
            raise resilience.SimulatedCrash(where)

    def tick(self) -> int:
        """One engine tick: admit a queue slice into slots, then drain one
        slot through one stacked launch. Returns requests completed."""
        self._crash_point("tick")
        self._admit()
        self._crash_point("drain")
        done = self._drain_one()
        self._ticks += 1
        if self.checkpointer is not None and self.checkpoint_every and \
                self._ticks % self.checkpoint_every == 0:
            self.checkpoint()
        return done

    def drain_all(self, max_ticks: int = 100000) -> int:
        """Tick until the engine runs dry; returns total completed."""
        done = 0
        for _ in range(max_ticks):
            if not self.backlog:
                break
            done += self.tick()
        return done

    def start(self, idle_s: float = 0.0005) -> None:
        """Run the tick loop on a dedicated serving thread (the one thread
        that touches the service/plan stack), on the service's device."""
        if self._thread is not None:
            raise RuntimeError("engine already started")
        self._stop.clear()
        device = self.service.device

        def loop() -> None:
            if device.type == "cuda":
                import torch
                torch.cuda.set_device(device)
            while not self._stop.is_set():
                if self.backlog:
                    self.tick()
                else:
                    time.sleep(idle_s)

        self._thread = threading.Thread(target=loop, name="serving-engine",
                                        daemon=True)
        self._thread.start()

    def stop(self, timeout_s: float = 10.0) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=timeout_s)
        self._thread = None

    # ----------------------------------------------------- durability (§15)
    def checkpoint(self) -> bool:
        """Snapshot the full learned state through the checkpointer; a
        failed save is counted (and absorbed by the checkpointer), never
        raised — the previous checkpoint stays valid."""
        if self.checkpointer is None:
            return False
        path = self.checkpointer.save(self, journal=self.journal)
        if path is not None:
            self._counts["checkpoints"] += 1
        return path is not None

    def close(self) -> None:
        """Clean shutdown: stop the tick thread if running, snapshot once
        more (checkpoint-on-clean-shutdown), and compact + fsync + close
        the journal. Idempotent."""
        self.stop()
        if self.checkpointer is not None:
            self.checkpoint()
        if self.journal is not None:
            self.journal.compact()
            self.journal.close()

    def export_state(self) -> Dict:
        """The checkpoint payload body: tick counter, ledger counters, and
        the service's learned state (quarantine with TTLs remaining,
        retraining buffer, schedule cache, selector counters)."""
        return {
            "tick": int(self._ticks),
            "counts": {k: int(v) for k, v in self._counts.items()},
            "selector": self.service.export_state(),
        }

    def restore_state(self, payload: Dict) -> None:
        """Rebuild from a checkpoint payload. Terminal counters restore
        verbatim; ``admitted``/``submitted`` restore REDUCED to the
        terminal history (``admitted = completed + shed``,
        ``submitted = admitted + rejected``) because the journal replay
        will re-submit the non-terminal suffix and re-count it once —
        keeping ``admitted == completed + shed`` an exact identity inside
        this incarnation's registry."""
        if not isinstance(payload, dict):
            return
        counts = {k: int(v) for k, v in (payload.get("counts") or {}).items()
                  if isinstance(v, (int, float))}
        term = counts.get("completed", 0) + counts.get("shed", 0)
        counts["admitted"] = term
        counts["submitted"] = term + counts.get("rejected", 0)
        for k, v in counts.items():
            if k in self._counts:
                self._counts[k] = v
        self._ticks = int(payload.get("tick", 0) or 0)
        self.service.restore_state(payload.get("selector") or {})

    def seed_terminal(self, rids) -> None:
        """Load the journal's terminal rid set (recovery): duplicates of
        already-answered requests are dropped at submit AND at drain."""
        self._terminal.update(str(r) for r in rids)

    # ------------------------------------------------------------ telemetry
    def reset_metrics(self) -> None:
        """Zero this engine's ledger — counters and the latency histogram.
        Called between warm-up and a measured replay, so the scorecard
        covers steady-state requests only (warm-up pays host prep and the
        first launches, which would otherwise own the p99 column)."""
        if self.backlog:
            raise RuntimeError("reset_metrics with requests in flight "
                               "would break the admitted==completed+shed "
                               "ledger; drain first")
        self._metrics.registry.clear_prefix(self._metrics.prefix + ".")

    def latency_snapshot(self) -> Dict[str, float]:
        """p50/p95/p99/min/max of completed-request latency (ms), from the
        engine's registry histogram."""
        hist = self._metrics.registry.histogram(
            self._metrics.key("request_ms"))
        if hist is None:
            return {"count": 0.0, "sum_ms": 0.0, "p50_ms": 0.0,
                    "p95_ms": 0.0, "p99_ms": 0.0}
        return hist.snapshot()

    def telemetry(self) -> Dict[str, float]:
        c = dict(self._counts)
        out = {k: float(v) for k, v in c.items()}
        out.update({
            "enqueued": float(c["submitted"] - c["rejected"]),
            "queue_depth": float(len(self.queue)),
            "queue_max": float(self.queue.queue_max),
            "soft_watermark": float(self.queue.soft_watermark),
            "open_slots": float(len(self.slots)),
            "slot_backlog": float(self.slots.backlog()),
            "slot_max": float(self.slots.slot_max),
            "mean_drain_size": c["drained_members"] / max(c["drains"], 1),
            "shed_rate": c["shed"] / max(c["admitted"], 1),
            "reject_rate": c["rejected"] / max(c["submitted"], 1),
            "slo_attainment": (c["slo_attained"]
                               / max(c["slo_attained"] + c["slo_missed"], 1)),
        })
        for k, v in self.latency_snapshot().items():
            out[f"latency_{k}"] = float(v)
        # store eviction pressure rides along (DESIGN.md §13): the serving
        # ledger and the byte-budget pressure it induces, one view
        prep = self.service.prepared_store.telemetry()
        for k in ("entries", "bytes_in_use", "evictions",
                  "eviction_pressure", "hit_rate"):
            out[f"prep_{k}"] = prep[k]
        # durability ledger (DESIGN.md §15): WAL + checkpoint activity next
        # to the request counters they make provable across restarts
        if self.journal is not None:
            for k, v in self.journal.telemetry().items():
                out[f"journal_{k}"] = v
        if self.checkpointer is not None:
            for k, v in self.checkpointer.telemetry().items():
                out[f"ckpt_{k}"] = v
        return ordered(out)
