"""Online schedule-selection service: the characterization loop as a server
(port of ``repro.selector.service``).

Request path (DESIGN.md §7):

    CSR --> fingerprint --> cache? --hit--> Schedule      (no tree, no sim)
                              |miss
                              v
                          tree predict --confident--> Schedule  (no sim)
                              |low confidence
                              v
                          simulation verify over the tree's top-k
                          (the existing autotune pass) --> Schedule
                              |
                              +--> cache.put + retraining example

Past the corpus (a request more than twice the largest matrix the tree
was fitted on, in rows and in nonzeros: ``streamed.OUT_OF_DOMAIN_LOG10``),
a cache miss skips the tree: the lossless candidate that streams the
fewest bytes through the counted kernels is served (source ``bytes``) and
cached, and no retraining example is kept (its label is not the model's).

Batching: requests drained per ``process_pending`` call are bucketed by the
selected schedule, because the schedule picks the kernel — matrices in one
bucket share one kernel (same layout / block size / slice height / RHS
tile), so the bucket count, not the request count, is the number of
launches a serving tick pays for: members executing in one tick go through
``repro_torch.sparse.plan_bucket``, one stacked launch with the member on
the kernel grid, on the service's ``device`` (the card unless
``device="cpu"``), under the service's ``GuardedExecutor``.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.autotune import (DENSE_DENSITY_THRESHOLD, Schedule,
                             ScheduleTuner, _modeled_time)
from ..core.csr import CSR
from ..obs import CounterDict, default_registry, ordered
from ..obs import trace as obs_trace
from ..sparse import resilience
from ..sparse.resilience import Deadline
from . import streamed
from .cache import ScheduleCache
from .fingerprint import Fingerprint, fingerprint
from .predictor import Prediction, SchedulePredictor, retraining_row


# Counters the reference's service lacks: a checkpoint carries one only
# once it has counted, so a service that never left the corpus writes the
# reference's counts key for key, and either package restores the other's.
PORT_ONLY_COUNTS = ("out_of_domain",)


@dataclasses.dataclass
class Request:
    name: str
    csr: CSR
    x: Optional[np.ndarray] = None   # optional RHS: execute the kernel too
    ck: Optional[str] = None         # content_key memo (filled by _decide)
    deadline: Optional[Deadline] = None   # admission deadline (shed if past)


@dataclasses.dataclass
class Decision:
    name: str
    schedule: Schedule
    source: str              # "cache" | "tree" | "verify" | "bytes"
    confidence: float
    fingerprint_key: str
    modeled_time_s: Optional[float]
    batch_id: int = -1
    bucket: int = -1         # bucket index within the batch
    y: Optional[np.ndarray] = None   # kernel output (host copy) when the
    #                                      request carried x
    ck: Optional[str] = None  # exact-bytes content key (PreparedStore reuse)
    # measured-latency feedback (DESIGN.md §12): per-member wall-clock of
    # the stacked launch that served this decision, and the log10 residual
    # against the modeled time the selector promised
    measured_ms: Optional[float] = None
    residual: Optional[float] = None


class SelectorService:
    """Batched, cached, tree-predicted kernel-config selection.

    Beyond schedule selection, the service owns a ``PreparedStore``
    (DESIGN.md §9): every bucket it executes — and every
    ``plan(..., selector=service)`` call — caches its finished
    device-resident operands there, so repeat traffic skips host prep as
    well as selection. ``refit_every=N`` schedules
    ``refit(min_examples=refit_min_examples)`` from the serving loop every
    N ``process_pending`` ticks (ROADMAP follow-up), with refit events
    recorded in the telemetry counters.
    """

    def __init__(self, tuner: ScheduleTuner, cache: Optional[ScheduleCache] = None,
                 confidence_threshold: float = 0.02, verify_top_k: int = 0,
                 batch_max: int = 16, prepared_store=None,
                 refit_every: int = 0, refit_min_examples: int = 8,
                 deadline_ms: Optional[float] = None, max_retries: int = 2,
                 backoff_base_s: float = 0.005,
                 quarantine: Optional[resilience.Quarantine] = None,
                 executor: Optional[resilience.GuardedExecutor] = None,
                 negative_penalty_s: float = 1.0,
                 degraded_cooldown: int = 4, device="cuda") -> None:
        from ..kernels.common import resolve_device
        from ..sparse.prepared import PreparedStore
        self.device = resolve_device(device)
        self.tuner = tuner
        self.predictor = SchedulePredictor(tuner)
        self.cache = cache if cache is not None else ScheduleCache()
        if not self.cache.context:
            # pin persisted entries to this tuner configuration so a reused
            # cache file can never serve wrong-kernel/platform schedules
            self.cache.context = (f"{tuner.kernel}:{tuner.platform.name}:"
                                  f"rhs{tuner.n_rhs}")
        self.confidence_threshold = float(confidence_threshold)
        # 0 = verify the full candidate sweep (exact argmin fallback);
        # k > 0 = verify only the tree's top-k ranked candidates.
        self.verify_top_k = int(verify_top_k)
        self.batch_max = max(int(batch_max), 1)
        self.prepared_store = (prepared_store if prepared_store is not None
                               else PreparedStore())
        self.refit_every = max(int(refit_every), 0)
        self.refit_min_examples = int(refit_min_examples)
        # resilience knobs (DESIGN.md §11): admission deadlines, bounded
        # retry/backoff around bucket execution, quarantine-aware selection,
        # and the degraded mode that sheds the verify sweep under pressure
        self.deadline_ms = deadline_ms
        self.max_retries = max(int(max_retries), 0)
        self.backoff_base_s = float(backoff_base_s)
        self.quarantine = (quarantine if quarantine is not None
                           else resilience.default_quarantine())
        self.executor = (executor if executor is not None
                         else resilience.default_executor())
        self.negative_penalty_s = float(negative_penalty_s)
        self.degraded_cooldown = max(int(degraded_cooldown), 1)
        self._degraded_until = 0
        self._exec_pressure = False
        self._last_fault_fired = 0
        self.pending: "deque[Request]" = deque()
        self.retraining_examples: List[Dict] = []
        # Fingerprint memo keyed by exact matrix bytes: characterize() is
        # milliseconds per matrix, so on repeat traffic it would dominate
        # the whole zero-rebuild path; a byte-identical matrix reuses its
        # Fingerprint the same way it reuses its prepared operands.
        self._fp_memo: "OrderedDict[str, Fingerprint]" = OrderedDict()
        self._fp_memo_cap = 4096
        # counters live in the process MetricsRegistry (DESIGN.md §12):
        # every existing ``self._counts[...] += 1`` call site is unchanged,
        # but telemetry() is now a genuine view over the registry
        self._metrics = default_registry().scope("selector")
        self._counts = CounterDict(self._metrics, (
            "requests", "cache_hits", "tree_served", "verify_fallbacks",
            "batches", "buckets", "executed", "stacked_launches", "refits",
            "ticks", "fp_memo_hits", "shard_requests", "sharded_plans",
            "shed_requests", "degraded_ticks", "degraded_served",
            "quarantine_blocked", "quarantine_overridden",
            "negative_examples", "exec_retries", "failed_executions",
            "out_of_domain"))
        self._bucket_sizes: List[int] = []
        # fp.key -> retraining example appended this tick, so a measured
        # launch can attach its wall-clock + residual to the example before
        # refit() consumes it
        self._examples_by_fp: Dict[str, Dict] = {}

    # ------------------------------------------------------------- ingress
    def submit(self, name: str, csr: CSR, x: Optional[np.ndarray] = None,
               deadline_ms: Optional[float] = None) -> None:
        ms = deadline_ms if deadline_ms is not None else self.deadline_ms
        deadline = Deadline.after_ms(ms) if ms is not None else None
        self.pending.append(Request(name, csr, x, deadline=deadline))

    def select(self, csr: CSR, name: str = "plan") -> Decision:
        """Single-request decision (fingerprint -> cache -> tree -> verify)
        without batching; the schedule source behind
        ``repro_torch.sparse.plan(op, ..., selector=service)``."""
        dec = self._decide(Request(name, csr), batch_id=-1)
        self._counts["requests"] += 1
        return dec

    def select_shards(self, shards: List[CSR],
                      name: str = "shard") -> List[Decision]:
        """One decision PER ROW SHARD of a partitioned matrix — the
        schedule source behind ``repro_torch.sparse.plan_sharded``. Each
        shard is fingerprinted and decided independently through the same
        cache -> tree -> verify path, because a skewed matrix's shards
        differ structurally (a hub-core shard wants a different layout or
        block size than a sparse-tail shard); recurring shard traffic hits
        the fingerprint cache and the content-key memo exactly like
        whole-matrix traffic."""
        decs = [self._decide(Request(f"{name}{i}", csr), batch_id=-1)
                for i, csr in enumerate(shards)]
        self._counts["requests"] += len(shards)
        self._counts["shard_requests"] += len(shards)
        self._counts["sharded_plans"] += 1
        return decs

    # ----------------------------------------------------------- resilience
    def enter_degraded(self, reason: str = "pressure") -> None:
        """External pressure signal — the serving engine's queue-depth
        soft watermark (DESIGN.md §13) calls this when the queue backs up:
        the verify sweep is shed for the next ``degraded_cooldown`` ticks,
        exactly as if the pressure had originated inside the service."""
        self._degraded_until = (self._counts["ticks"]
                                + self.degraded_cooldown)

    @property
    def degraded(self) -> bool:
        """True while the service is under pressure (recent sheds, execution
        retries/failures, or injected faults): the autotune verify-sweep is
        shed and low-confidence requests are served the tree schedule."""
        return self._counts["ticks"] < self._degraded_until

    def _quarantined(self, sched: Schedule) -> bool:
        return sched.backend != "dense" and \
            self.quarantine.blocked_any_backend(self.tuner.kernel, sched)

    def _negative_example(self, fp: Fingerprint, sched: Schedule) -> None:
        """Feed a quarantined pick into the retraining buffer with a
        penalty time, so the next ``refit`` teaches the tree away from the
        poisoned schedule instead of merely masking it."""
        self.retraining_examples.append(
            retraining_row(fp, sched, self.negative_penalty_s))
        self._counts["negative_examples"] += 1

    # ------------------------------------------------------------ decisions
    def _verify(self, fp: Fingerprint, A: CSR) -> Tuple[Schedule, float]:
        """The autotune simulation pass, optionally pruned by the tree —
        and always excluding quarantined schedules (unless that empties the
        sweep entirely, in which case the full list is kept and counted)."""
        with obs_trace.span("verify", fp.key) as ev:
            candidates = [s for _, s in self.predictor.rank(fp.features)]
            if self.verify_top_k > 0:
                candidates = candidates[: self.verify_top_k]
            avail = [s for s in candidates if not self._quarantined(s)]
            if avail:
                candidates = avail
            else:
                self._counts["quarantine_overridden"] += 1
            timed = [(_modeled_time(self.tuner.kernel, A,
                                    self.tuner.platform, s), s)
                     for s in candidates]
            timed.sort(key=lambda p: p[0])
            ev["candidates"] = len(timed)
            return timed[0][1], timed[0][0]

    def _bytes_pick(self, req: Request, fp: Fingerprint,
                    batch_id: int) -> Decision:
        """Past the corpus: the lossless, unquarantined candidate that
        streams the fewest bytes, modeled at those bytes over the
        platform's HBM bandwidth (a quarantine that blocks every lossless
        candidate is overridden and counted, as in ``_verify``)."""
        with obs_trace.span("bytes", req.name) as ev:
            ranked = streamed.rank_by_bytes(req.csr, self.predictor.candidates,
                                            self.tuner.n_rhs)
            avail = [c for c in ranked if not self._quarantined(c.schedule)]
            if avail:
                ranked = avail
            else:
                self._counts["quarantine_overridden"] += 1
            best = ranked[0]
            t = best.bytes / self.tuner.platform.hbm_bw
            ev.update(candidates=len(self.predictor.candidates),
                      eligible=len(ranked), streamed_bytes=best.bytes,
                      modeled_ms=t * 1e3)
        self._counts["out_of_domain"] += 1
        self._metrics.registry.inc("select_out_of_domain")
        self.cache.put(fp, best.schedule, "bytes", t)
        return Decision(req.name, best.schedule, "bytes", 1.0, fp.key, t,
                        batch_id, ck=req.ck)

    def _fingerprint(self, req: Request) -> Fingerprint:
        from ..sparse.prepared import content_key
        with obs_trace.span("content_key", req.name):
            req.ck = content_key(req.csr)
        with obs_trace.span("fingerprint", req.name) as ev:
            fp = self._fp_memo.get(req.ck)
            ev["memo_hit"] = fp is not None
            if fp is not None:
                self._fp_memo.move_to_end(req.ck)
                self._counts["fp_memo_hits"] += 1
                return fp
            fp = fingerprint(req.csr)
            self._fp_memo[req.ck] = fp
            while len(self._fp_memo) > self._fp_memo_cap:
                self._fp_memo.popitem(last=False)
            return fp

    def _decide(self, req: Request, batch_id: int) -> Decision:
        """Instrumented decision: a ``select`` span records the outcome
        (source / schedule / confidence), and the wall-clock of every
        decision feeds the ``select_ms`` latency histogram."""
        t0 = time.monotonic()
        with obs_trace.span("select", req.name) as ev:
            dec = self._decide_inner(req, batch_id)
            ev.update(source=dec.source, schedule=str(dec.schedule),
                      fingerprint=dec.fingerprint_key,
                      confidence=dec.confidence)
        self._metrics.registry.observe("select_ms",
                                       (time.monotonic() - t0) * 1e3)
        return dec

    def _decide_inner(self, req: Request, batch_id: int) -> Decision:
        fp = self._fingerprint(req)
        cached = self.cache.get(fp)
        if cached is not None and self._quarantined(cached):
            # a cached pick that has since been quarantined is never
            # re-served: treat as a miss, log the negative example
            self._counts["quarantine_blocked"] += 1
            self._negative_example(fp, cached)
            cached = None
        if cached is not None:
            self._counts["cache_hits"] += 1
            return Decision(req.name, cached, "cache", 1.0, fp.key, None,
                            batch_id, ck=req.ck)
        if fp.features.get("density", 0.0) <= DENSE_DENSITY_THRESHOLD and \
                streamed.past_extent(fp.features,
                                     streamed.training_extent(self.tuner)):
            return self._bytes_pick(req, fp, batch_id)
        with obs_trace.span("tree", req.name):
            pred: Prediction = self.predictor.predict(fp)
        if pred.schedule.backend != "dense" and \
                self._quarantined(pred.schedule):
            # poisoned tree pick: re-decide through the (filtered) verify
            # sweep, even in degraded mode — correctness over pressure
            self._counts["quarantine_blocked"] += 1
            self._negative_example(fp, pred.schedule)
            sched, t = self._verify(fp, req.csr)
            self._counts["verify_fallbacks"] += 1
            self.cache.put(fp, sched, "verify", t)
            ex = retraining_row(fp, sched, t)
            self.retraining_examples.append(ex)
            self._examples_by_fp[fp.key] = ex
            return Decision(req.name, sched, "verify", pred.confidence,
                            fp.key, t, batch_id, ck=req.ck)
        if pred.schedule.backend != "dense" and \
                pred.confidence < self.confidence_threshold:
            if self.degraded:
                # degraded mode: shed the verify sweep, serve the tree pick
                # — but do NOT cache it: a low-confidence decision made
                # under pressure must not outlive the degraded window as a
                # normal (persisted) cache hit; the next non-degraded
                # lookup re-decides through the full verify path
                self._counts["degraded_served"] += 1
                self._counts["tree_served"] += 1
                return Decision(req.name, pred.schedule, "tree",
                                pred.confidence, fp.key, pred.tree_time_s,
                                batch_id, ck=req.ck)
            sched, t = self._verify(fp, req.csr)
            self._counts["verify_fallbacks"] += 1
            self.cache.put(fp, sched, "verify", t)
            ex = retraining_row(fp, sched, t)
            self.retraining_examples.append(ex)
            self._examples_by_fp[fp.key] = ex
            return Decision(req.name, sched, "verify", pred.confidence,
                            fp.key, t, batch_id, ck=req.ck)
        self._counts["tree_served"] += 1
        self.cache.put(fp, pred.schedule, "tree", pred.tree_time_s)
        return Decision(req.name, pred.schedule, "tree", pred.confidence,
                        fp.key, pred.tree_time_s, batch_id, ck=req.ck)

    def _shed(self, req: Request, batch_id: int) -> Decision:
        """Deadline-exceeded admission: no fingerprint, no selection, no
        execution — the request is answered with the default schedule and
        counted, honoring the deadline instead of blowing through it."""
        self._counts["shed_requests"] += 1
        obs_trace.emit("shed", req.name)
        sched = Schedule("bsr", 128, 1.0, n_rhs=self.tuner.n_rhs)
        return Decision(req.name, sched, "shed", 0.0, "", None, batch_id)

    # ------------------------------------------------------------- serving
    def process_pending(self, backend: str = "auto") -> List[Decision]:
        """Drain up to ``batch_max`` requests as one serving tick: decide a
        schedule per request, bucket same-schedule requests together, and run
        the kernel for requests that carried an RHS (one bucket = one
        stacked launch)."""
        batch: List[Request] = []
        shed: List[Request] = []
        while self.pending and len(batch) + len(shed) < self.batch_max:
            req = self.pending.popleft()
            if req.deadline is not None and req.deadline.exceeded():
                shed.append(req)
            else:
                batch.append(req)
        if not batch and not shed:
            return []
        # measured-feedback scope is one tick: examples appended while
        # deciding this batch may receive wall-clock residuals from this
        # tick's launches, never a later tick's
        self._examples_by_fp.clear()
        if self.degraded:
            self._counts["degraded_ticks"] += 1
        batch_id = self._counts["batches"]
        self._counts["batches"] += 1
        decisions = [self._decide(req, batch_id) for req in batch]
        self._counts["requests"] += len(batch) + len(shed)

        buckets: "Dict[Schedule, List[int]]" = {}
        for i, dec in enumerate(decisions):
            buckets.setdefault(dec.schedule, []).append(i)
        for b, (key, members) in enumerate(sorted(buckets.items(),
                                                  key=lambda kv: kv[1][0])):
            for i in members:
                decisions[i].bucket = b
            self._bucket_sizes.append(len(members))
            self._execute_bucket([(batch[i], decisions[i]) for i in members],
                                 backend)
        self._counts["buckets"] += len(buckets)
        decisions.extend(self._shed(req, batch_id) for req in shed)
        # Serving-loop retraining tick (ROADMAP follow-up): fold the verify
        # feedback buffer into the tuner tree every ``refit_every`` ticks.
        self._counts["ticks"] += 1
        self.quarantine.tick()
        # pressure signal -> degraded window: any shed, execution
        # retry/failure, or injected fault this tick sheds the verify sweep
        # for the next ``degraded_cooldown`` ticks
        inj = resilience.injector()
        fired = sum(inj.fired.values()) if inj is not None else 0
        if shed or self._exec_pressure or fired > self._last_fault_fired:
            self._degraded_until = (self._counts["ticks"]
                                    + self.degraded_cooldown)
        self._exec_pressure = False
        self._last_fault_fired = fired
        if self.refit_every and self._counts["ticks"] % self.refit_every == 0:
            self.refit(min_examples=self.refit_min_examples)
        return decisions

    def run(self, backend: str = "auto") -> List[Decision]:
        """Process every pending request; returns all decisions."""
        out: List[Decision] = []
        while self.pending:
            out.extend(self.process_pending(backend))
        return out

    def drain_bucket(self, members: List[Tuple[Request, Decision]],
                     backend: str = "auto") -> List[Decision]:
        """Engine-driven drain path (DESIGN.md §13): execute one
        pre-bucketed group of already-decided requests as ONE stacked
        launch, then advance the serving clock.

        ``process_pending`` owns the whole tick (drain queue, decide,
        bucket, execute); the continuous-batching engine instead decides at
        admission time (``select``), holds requests in schedule-keyed
        slots, and hands each slot here when it drains it — so the service
        keeps ownership of execution (retry/backoff, stacked launch,
        measured-latency feedback, refit cadence) while the engine owns
        queueing, admission, and slot policy. Members must share one
        Schedule (they came from one slot); requests were already counted
        by ``select`` at admission.
        """
        if not members:
            return []
        batch_id = self._counts["batches"]
        self._counts["batches"] += 1
        for req, dec in members:
            dec.batch_id = batch_id
            dec.bucket = 0
        self._bucket_sizes.append(len(members))
        self._counts["buckets"] += 1
        if self.degraded:
            self._counts["degraded_ticks"] += 1
        self._execute_bucket(list(members), backend)
        self._counts["ticks"] += 1
        self.quarantine.tick()
        inj = resilience.injector()
        fired = sum(inj.fired.values()) if inj is not None else 0
        if self._exec_pressure or fired > self._last_fault_fired:
            self._degraded_until = (self._counts["ticks"]
                                    + self.degraded_cooldown)
        self._exec_pressure = False
        self._last_fault_fired = fired
        if self.refit_every and self._counts["ticks"] % self.refit_every == 0:
            self.refit(min_examples=self.refit_min_examples)
        # measured-feedback scope ends with the drain: examples appended
        # while admitting this slot's requests received this launch's
        # residuals in _execute_bucket; never a later drain's
        self._examples_by_fp.clear()
        return [dec for _, dec in members]

    def _execute_bucket(self, members: List[Tuple[Request, Decision]],
                        backend: str) -> None:
        """Run SpMV for the bucket members that carried an RHS — all of
        them through ONE stacked launch.

        All members share one Schedule, hence one kernel; they also share
        the launch: ``plan_bucket`` pads the members to common shapes,
        stacks them along a leading axis, and the whole bucket executes as
        a single kernel launch instead of one launch per member.
        """
        from ..sparse import plan_bucket
        todo = [(req, dec) for req, dec in members if req.x is not None]
        if not todo:
            return
        # One stacked launch per RHS signature: members may mix vector and
        # multi-RHS (or different-k) inputs under one schedule; each
        # homogeneous group still shares a single dispatch.
        groups: "Dict[Tuple, List[Tuple[Request, Decision]]]" = {}
        for req, dec in todo:
            x = np.asarray(req.x)
            groups.setdefault((x.ndim,) + x.shape[1:], []).append((req, dec))
        for grp in groups.values():
            # member_keys: _decide already hashed every request's matrix
            # (content_key memo), so the bucket store key reuses those
            # instead of paying a second O(nnz) hashing pass per tick
            mks = [req.ck for req, _ in grp]

            def attempt(grp=grp, mks=mks):
                bucket_plan = plan_bucket(
                    "spmv", [req.csr for req, _ in grp],
                    grp[0][1].schedule, backend=backend,
                    store=self.prepared_store, device=self.device,
                    executor=self.executor,
                    member_keys=(mks if all(mks) else None))
                # modeled cost of the stacked launch = sum of the members'
                # tree/cache predictions, so the launch trace event carries
                # modeled_ms next to wall-clock
                modeled = [dec.modeled_time_s for _, dec in grp
                           if dec.modeled_time_s]
                if modeled and bucket_plan.modeled_time_s is None:
                    bucket_plan.modeled_time_s = float(sum(modeled))
                return bucket_plan, bucket_plan.execute(
                    [req.x for req, _ in grp])

            # bounded retry + exponential backoff (the run_with_restarts
            # supervisor shape, sized for one serving call); on the CPU the
            # guard's fallback ladder inside the plan absorbs almost
            # everything, so a retry here means the whole chain failed
            # transiently; on the card the guard raises a kernel's failure
            # and a retry launches the kernel again
            try:
                bucket_plan, ys = resilience.with_backoff(
                    attempt, max_retries=self.max_retries,
                    base_s=self.backoff_base_s, on_retry=self._on_exec_retry)
            except resilience.GUARDED_EXCEPTIONS as e:
                self._counts["failed_executions"] += 1
                self._exec_pressure = True
                if isinstance(e, resilience.InjectedFault):
                    resilience.note_recovery(e.site)
                continue
            self._counts["stacked_launches"] += 1
            # measured-latency feedback (DESIGN.md §12): the stacked
            # launch's wall-clock, amortized per member, lands on each
            # decision and on the retraining example the decision produced
            # this tick — refit() then carries measured_ms/residual next
            # to the modeled label, and the calibration report reads the
            # same residual off the launch events
            measured_s = bucket_plan.last_measured_s
            per_member_ms = (measured_s * 1e3 / max(len(grp), 1)
                             if measured_s is not None else None)
            for (req, dec), y in zip(grp, ys):
                dec.y = y.cpu().numpy()
                self._counts["executed"] += 1
                if per_member_ms is None:
                    continue
                dec.measured_ms = per_member_ms
                if dec.modeled_time_s and dec.modeled_time_s > 0:
                    dec.residual = float(
                        np.log10(max(per_member_ms, 1e-9)
                                 / (dec.modeled_time_s * 1e3)))
                ex = self._examples_by_fp.get(dec.fingerprint_key)
                if ex is not None:
                    ex["measured_ms"] = dec.measured_ms
                    ex["residual"] = dec.residual

    def _on_exec_retry(self, attempt: int, exc: BaseException) -> None:
        self._counts["exec_retries"] += 1
        self._exec_pressure = True

    # ------------------------------------------------------ durability (§15)
    def export_state(self) -> Dict:
        """Checkpoint view of the service's learned state (DESIGN.md §15):
        counters, the retraining buffer (rows are already JSON-shaped),
        the fingerprint->Schedule cache, and the quarantine with TTLs in
        ticks remaining. The PreparedStore is deliberately absent — device
        buffers cannot be checkpointed and the store cold-rebuilds on miss
        by design."""
        return {
            "counts": {k: int(v) for k, v in self._counts.items()
                       if v or k not in PORT_ONLY_COUNTS},
            "retraining_examples": [dict(ex)
                                    for ex in self.retraining_examples],
            "cache": self.cache.export_state(),
            "quarantine": self.quarantine.export_state(),
        }

    def restore_state(self, state: Dict) -> None:
        """Rebuild learned state from :meth:`export_state` output. Counter
        values restore verbatim (the selector faces no cross-incarnation
        identity; the engine adjusts its own ledger counters — see
        ``EngineCheckpoint``); malformed components cold-start empty."""
        if not isinstance(state, dict):
            return
        for k, v in (state.get("counts") or {}).items():
            if k in self._counts:
                try:
                    self._counts[k] = int(v)
                except (TypeError, ValueError):
                    pass
        raw = state.get("retraining_examples", [])
        self.retraining_examples = [
            dict(ex) for ex in (raw if isinstance(raw, list) else [])
            if isinstance(ex, dict) and "features" in ex and "cfg" in ex]
        self.cache.restore_state(state.get("cache") or {})
        self.quarantine.restore_state(state.get("quarantine") or [])

    # ----------------------------------------------------------- retraining
    def refit(self, min_examples: int = 8) -> Dict[str, float]:
        """Refresh the tuner tree from the verify-fallback feedback buffer
        (ROADMAP follow-up). Explicit call, no background thread: serving
        code decides when a retrain tick is affordable.

        Consumes ``retraining_examples`` once at least ``min_examples`` have
        accumulated; rows are already in the (static metrics + cfg) feature
        space ``ScheduleTuner.fit`` trains on, so no simulation re-runs.
        Returns telemetry: ``refit`` (0/1), ``examples`` consumed/pending.
        """
        n = len(self.retraining_examples)
        if n < max(int(min_examples), 1):
            return {"refit": 0.0, "examples": float(n)}
        n_static = len(self.tuner.feature_names) - len(
            self.retraining_examples[0]["cfg"])
        rows = [[ex["features"][k]
                 for k in self.tuner.feature_names[:n_static]] + list(ex["cfg"])
                for ex in self.retraining_examples]
        ys = [ex["log10_time_s"] for ex in self.retraining_examples]
        self.tuner.refit(rows, ys)
        self.retraining_examples.clear()
        self._counts["refits"] += 1
        return {"refit": 1.0, "examples": float(n)}

    # ------------------------------------------------------------ telemetry
    def telemetry(self) -> Dict[str, float]:
        c = dict(self._counts)
        n = max(c["requests"], 1)
        sizes = self._bucket_sizes or [0]
        out = {k: float(v) for k, v in c.items()}
        out.update({
            "fallback_fraction": c["verify_fallbacks"] / n,
            "cache_hit_rate": c["cache_hits"] / n,
            "mean_bucket_size": float(np.mean(sizes)),
            "max_bucket_size": float(np.max(sizes)),
            "retraining_examples": float(len(self.retraining_examples)),
        })
        store = self.cache.telemetry()
        for k in ("entries", "collisions", "evictions"):
            out[f"cache_{k}"] = store[k]
        # prepared-operand cache telemetry (DESIGN.md §9), next to the
        # schedule-cache counters: host prep skipped vs paid, bytes pinned.
        prep = self.prepared_store.telemetry()
        for k in ("entries", "hits", "misses", "evictions", "bytes_in_use",
                  "hit_rate"):
            out[f"prep_{k}"] = prep[k]
        # resilience ledger (DESIGN.md §11): guard fallbacks, quarantine
        # state, degraded-mode activity, and — when a FaultInjector is
        # installed — the fired/recovered accounting the chaos smoke checks
        ex = self.executor.telemetry()
        out["guard_fallbacks"] = ex["fallbacks"]
        out["guard_nan_trips"] = ex["nan_trips"]
        out["guard_dense_served"] = ex["dense_served"]
        out["guard_quarantine_skips"] = ex["quarantine_skips"]
        out["guard_quarantine_overrides"] = ex["quarantine_overrides"]
        q = self.quarantine.telemetry()
        out["quarantine_entries"] = q["entries"]
        out["quarantine_entered"] = q["entered"]
        out["quarantine_expired"] = q["expired"]
        out["degraded"] = 1.0 if self.degraded else 0.0
        inj = resilience.injector()
        if inj is not None:
            out.update(inj.telemetry())
        # deterministic shape (obs/schema.py): canonical snake_case keys in
        # sorted order, so golden tests and bench JSON stop being
        # order-fragile
        return ordered(out)
