"""Serving-side resilience: guarded execution, quarantine, fault injection
(the port of ``repro.sparse.resilience``).

SpChar's thesis is that sparse performance is input-dependent and hard to
predict — which means a production selector *will* eventually pick schedules
that fail or degrade on unseen inputs, and a serving loop that dies on the
first bad kernel launch (or the first truncated cache file) is not a serving
loop. This module brings a supervisor posture to the serving side
(DESIGN.md §11):

* ``GuardedExecutor`` + ``guard_plan`` — every ``Plan`` launch runs under
  the guard. On the CPU it runs through an ordered backend fallback chain
  (torch → dense reference): a failed or NaN/Inf launch drops one rung,
  the failing ``(op, backend, schedule)`` combo enters the
  ``Quarantine``, and the caller still gets a correct answer. On the card
  the chain is the plan's backend alone: the failure is counted, the
  combo quarantined and the error raised, so no answer ever comes from
  anything but the kernel the plan names. A CUDA kernel wrapper never
  falls back by itself either; every fall is counted and traced as a
  ``fallback`` event.
* ``Quarantine`` — records poisoned combos so the selector and tuner never
  re-serve them; quarantined picks feed the retraining buffer as negative
  examples (SelectorService wiring). Entries can expire after
  ``ttl_ticks`` serving ticks — a transient fault does not ban a schedule
  forever. One deliberate exception to "never re-serve": when the
  quarantined combo is the ONLY remaining rung (or the verify sweep would
  otherwise be empty), it is served as a last resort and counted
  (``quarantine_overrides`` on the executor, ``quarantine_overridden`` in
  SelectorService telemetry) — a degraded answer beats no answer.
* checksummed atomic persistence helpers (``atomic_write_json`` /
  ``load_json_guarded`` / ``entry_checksum``) — ``ScheduleCache`` and
  ``PreparedStore`` write temp-file + ``os.replace`` and skip-and-count
  corrupt entries on load instead of raising (cold-start-from-empty
  guarantee).
* ``Deadline`` / ``with_backoff`` — per-request admission deadlines and the
  bounded-retry supervisor shape of ``run_with_restarts``, sized for a
  single serving call instead of a training run.
* ``FaultInjector`` — deterministic, seed-driven, site-named failure
  injection (prep / launch / cache-read / cache-write / store-evict /
  shard-dispatch) threaded through the stack so every recovery path above
  is exercised by tests. Every
  fired fault that a handler absorbs is counted as ``recovered``; the chaos
  smoke machine-checks ``fired == recovered``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time
import zlib
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..obs import default_registry, ordered, scoped_int
from ..obs import trace as obs_trace

# Ordered fallback ladder. A guarded launch starts at its plan's backend and
# only ever moves right: the CUDA kernel, its plain PyTorch version, then
# "dense", the per-op numpy reference of last resort (registered via
# register_dense_ref), not a Schedule backend. Only a plan on the CPU walks
# it (from "torch"): on the card the chain is cut to the plan's own rung
# (``GuardedExecutor.chain_from``), because a fall there would serve the
# plain version or the host in the kernel's place.
FALLBACK_CHAIN = ("cuda", "torch", "dense")

# Named injection sites a FaultInjector can fire at, the JAX package's set.
# The port fires prep, launch, cache-read, cache-write and store-evict; the
# others wait for the modules that own them. The two mutation
# sites (DESIGN.md §14): ``delta-apply`` fires inside the value-only device
# fast path (recovery = the epoch-swap rebuild), ``slack-overflow``
# simulates an exhausted slack reservation (recovery = same swap), so the
# chaos gate's ``fired == recovered`` identity covers dynamic sparsity.
# The three durability sites (DESIGN.md §15): ``journal-append`` fails one
# WAL record write (recovery = count + keep serving, durability degraded),
# ``checkpoint-write`` fails a checkpoint save (recovery = previous
# checkpoint stays valid), and ``crash`` simulates process death between
# two engine ticks (recovery = the run_with_restarts supervisor restores
# the newest checkpoint and replays the journal suffix).
SITES = ("prep", "launch", "cache-read", "cache-write", "store-evict",
         "shard-dispatch", "delta-apply", "slack-overflow",
         "journal-append", "checkpoint-write", "crash")


class InjectedFault(RuntimeError):
    """A simulated failure raised by the installed FaultInjector."""

    def __init__(self, site: str, detail: str = "") -> None:
        super().__init__(f"injected fault at {site}"
                         + (f" ({detail})" if detail else ""))
        self.site = site
        self.detail = detail


class NonFiniteOutput(RuntimeError):
    """A guarded launch produced NaN/Inf output (treated as a launch
    failure: quarantine the combo and re-execute one rung down, or raise
    where there is no rung below)."""


class SimulatedCrash(BaseException):
    """Simulated process death (the ``crash`` fault site, fired between two
    engine ticks). Derives from BaseException ON PURPOSE: nothing in the
    guarded ladder, the retry/backoff shape, or the engine may absorb it —
    only the ``run_with_restarts`` supervisor catches it, exactly as a real
    ``kill -9`` would only be survived by a process supervisor."""

    def __init__(self, where: str = "") -> None:
        super().__init__(f"simulated crash{f' at {where}' if where else ''}")
        self.where = where


# Failure classes the guard absorbs. ValueError/TypeError stay fatal on
# purpose: they are caller contract errors (bad layouts, shape mismatches),
# and masking them behind a fallback would hide real bugs.
# A failed CUDA launch raises RuntimeError, and torch.cuda.OutOfMemoryError
# subclasses RuntimeError, so real launch failures land here too: on the
# card they are counted and the combo quarantined before they are raised
# (the device is not reset). MemoryError is guarded: an OOM during a build
# or a lazy densification should walk the ladder (or exhaust it), not
# unwind the serving loop.
GUARDED_EXCEPTIONS = (RuntimeError, OSError, ArithmeticError, MemoryError)


def dense_ref_cap() -> int:
    """Max elements per operand the dense reference rung will materialize
    (``REPRO_DENSE_REF_MAX_ELEMS`` overrides; default 2**26 ≈ 256 MB of
    float32 per operand). Above the cap an op simply has no dense rung —
    the ladder ends at torch instead of OOMing the process on the exact
    availability path that exists to prevent crashes."""
    return int(os.environ.get("REPRO_DENSE_REF_MAX_ELEMS", str(1 << 26)))


# ---------------------------------------------------------------------------
# deterministic fault injection
# ---------------------------------------------------------------------------

class FaultInjector:
    """Seed-driven, site-named failure injection.

    Each ``fire(site)`` call draws deterministically from
    ``crc32(seed:site:n)`` where ``n`` is that site's draw counter — the
    same seed and call sequence always fires the same faults, so chaos runs
    are reproducible and test failures replay. ``recovered(site)`` is
    ticked by the handler that absorbed a fired fault; the chaos smoke's
    accounting identity is ``fired == recovered`` per site.
    """

    def __init__(self, rate: float, seed: int = 0,
                 sites: Optional[Sequence[str]] = None) -> None:
        self.rate = float(rate)
        self.seed = int(seed)
        self.sites = tuple(sites) if sites is not None else SITES
        self._draws: "Counter[str]" = Counter()
        self.checks: "Counter[str]" = Counter()
        self.fired: "Counter[str]" = Counter()
        self.recovered_counts: "Counter[str]" = Counter()

    def fire(self, site: str, detail: str = "") -> bool:
        """True if a fault fires at this site for this (deterministic)
        draw. Counts the check either way."""
        self.checks[site] += 1
        if site not in self.sites or self.rate <= 0.0:
            return False
        n = self._draws[site]
        self._draws[site] += 1
        draw = zlib.crc32(f"{self.seed}:{site}:{n}".encode()) / 0xFFFFFFFF
        if draw < self.rate:
            self.fired[site] += 1
            return True
        return False

    def maybe_raise(self, site: str, detail: str = "") -> None:
        if self.fire(site, detail):
            raise InjectedFault(site, detail)

    def recovered(self, site: str) -> None:
        self.recovered_counts[site] += 1

    def telemetry(self) -> Dict[str, float]:
        out = {
            "fault_checks": float(sum(self.checks.values())),
            "fault_fired": float(sum(self.fired.values())),
            "fault_recovered": float(sum(self.recovered_counts.values())),
        }
        for site in self.sites:
            if self.fired[site]:
                out[f"fault_fired_{site}"] = float(self.fired[site])
        return ordered(out)


# Concurrency contract: the module-level defaults below (_INJECTOR,
# _DEFAULT_QUARANTINE, _DEFAULT_EXECUTOR) are process-wide and
# unsynchronized — they assume ONE single-threaded serving loop per
# process. Callers running several services (or threads) should construct
# their own GuardedExecutor/Quarantine and thread them explicitly through
# ``plan(..., executor=...)`` / ``SelectorService(executor=...,
# quarantine=...)``; tests isolate via ``reset_resilience()``.
_INJECTOR: Optional[FaultInjector] = None


def install_injector(inj: Optional[FaultInjector]) -> Optional[FaultInjector]:
    """Install (or, with None, remove) the process-wide fault injector."""
    global _INJECTOR
    _INJECTOR = inj
    return inj


def injector() -> Optional[FaultInjector]:
    return _INJECTOR


def check_fault(site: str, detail: str = "") -> None:
    """Raise InjectedFault at ``site`` if the installed injector fires
    (no-op when none is installed — the zero-overhead production path)."""
    if _INJECTOR is not None:
        _INJECTOR.maybe_raise(site, detail)


def fault_fired(site: str, detail: str = "") -> bool:
    """Non-raising check for sites whose recovery IS the normal miss path
    (cache-read / store-evict): the handler turns a fired fault into a
    miss and counts the recovery itself."""
    return _INJECTOR is not None and _INJECTOR.fire(site, detail)


def note_recovery(site: str) -> None:
    if _INJECTOR is not None:
        _INJECTOR.recovered(site)


def _note_handled(e: BaseException) -> None:
    """Credit an absorbed InjectedFault back to the injector's recovery
    accounting (called only on handled paths, never before a re-raise)."""
    if isinstance(e, InjectedFault) and _INJECTOR is not None:
        _INJECTOR.recovered(e.site)


# ---------------------------------------------------------------------------
# schedule quarantine
# ---------------------------------------------------------------------------

class Quarantine:
    """Registry of poisoned ``(op, backend, Schedule)`` combos.

    Lifecycle (DESIGN.md §11): a combo **enters** when a guarded launch
    fails (exception or NaN/Inf output) on that backend; while quarantined
    the guard skips the rung and the selector refuses to serve the schedule
    (feeding a **negative example** into the retraining buffer instead);
    after ``ttl_ticks`` serving ticks the entry **expires** and the combo
    gets another chance (``ttl_ticks=None`` = never — a poisoned combo
    stays out until the process restarts).

    Last-resort override: when every alternative is quarantined too — the
    guard's final rung, or a verify sweep that would otherwise be empty —
    the quarantined combo IS served rather than failing the request. Each
    such serve is counted (``GuardedExecutor.quarantine_overrides`` /
    the service's ``quarantine_overridden``), so the bend in the
    never-re-serve contract is always observable in telemetry.
    """

    # counters live in the process MetricsRegistry (DESIGN.md §12): the
    # attributes below are views into this instance's registry scope, so
    # ``telemetry()`` and a registry ``snapshot()`` can never disagree
    entered = scoped_int("entered")
    expired = scoped_int("expired")
    blocked_hits = scoped_int("blocked_hits")

    def __init__(self, ttl_ticks: Optional[int] = None) -> None:
        self._metrics = default_registry().scope("quarantine")
        self.ttl_ticks = ttl_ticks
        self._entries: Dict[Tuple, Dict] = {}
        self._tick = 0

    def __len__(self) -> int:
        return len(self._entries)

    @staticmethod
    def _key(op: str, backend: str, schedule) -> Tuple:
        return (op, backend, schedule)

    def add(self, op: str, backend: str, schedule, reason: str = "") -> None:
        key = self._key(op, backend, schedule)
        if key not in self._entries:
            self.entered += 1
            obs_trace.emit("quarantine", f"{op}:{backend}", op=op,
                           backend=backend, reason=reason,
                           schedule=str(schedule))
        self._entries[key] = {
            "op": op, "backend": backend, "schedule": schedule,
            "reason": reason, "entered_tick": self._tick,
            "expires_tick": (None if self.ttl_ticks is None
                             else self._tick + int(self.ttl_ticks)),
        }

    def blocked(self, op: str, backend: str, schedule) -> bool:
        hit = self._key(op, backend, schedule) in self._entries
        if hit:
            self.blocked_hits += 1
        return hit

    def blocked_any_backend(self, op: str, schedule) -> bool:
        """Selection-time check: a schedule quarantined on ANY backend is
        not re-served (the selector cannot know which backend the plan
        will execute on)."""
        for key in self._entries:
            if key[0] == op and key[2] == schedule:
                self.blocked_hits += 1
                return True
        return False

    def tick(self) -> None:
        """Advance the serving clock and expire aged entries."""
        self._tick += 1
        stale = [k for k, v in self._entries.items()
                 if v["expires_tick"] is not None
                 and v["expires_tick"] <= self._tick]
        for k in stale:
            del self._entries[k]
            self.expired += 1

    def entries(self) -> List[Dict]:
        return list(self._entries.values())

    def clear(self) -> None:
        self._entries.clear()

    # ------------------------------------------------------ durability (§15)
    def export_state(self) -> List[Dict]:
        """JSON-ready entries with TTLs in *ticks remaining*, never absolute
        tick numbers: a restored incarnation starts its tick counter at 0,
        so persisting ``expires_tick`` verbatim would expire every entry
        immediately (late entries) or pin them forever (early ones)."""
        out: List[Dict] = []
        for v in self._entries.values():
            sched = v["schedule"]
            out.append({
                "op": v["op"], "backend": v["backend"],
                "schedule": (dataclasses.asdict(sched)
                             if dataclasses.is_dataclass(sched)
                             else {"repr": str(sched)}),
                "reason": v["reason"],
                "ttl_remaining": (None if v["expires_tick"] is None
                                  else max(int(v["expires_tick"])
                                           - self._tick, 0)),
            })
        return out

    def restore_state(self, entries: Sequence[Dict]) -> int:
        """Rebuild entries from :meth:`export_state` output against THIS
        incarnation's tick counter (``expires = now + ttl_remaining``).
        Malformed entries are skipped, never raised; returns the number
        restored. Restored entries do not re-count ``entered`` — the
        checkpointed counter snapshot already carries that history."""
        from ..core.autotune import Schedule
        n = 0
        for e in entries:
            if not isinstance(e, dict):
                continue
            sd = e.get("schedule")
            if not isinstance(sd, dict) or "backend" not in sd:
                continue
            try:
                sched = Schedule(
                    backend=str(sd["backend"]),
                    block_size=int(sd.get("block_size", 128)),
                    ell_quantile=float(sd.get("ell_quantile", 1.0)),
                    layout=str(sd.get("layout", "ell")),
                    slice_height=int(sd.get("slice_height", 0)),
                    n_rhs=int(sd.get("n_rhs", 1)))
                op, backend = str(e["op"]), str(e["backend"])
            except (KeyError, TypeError, ValueError):
                continue
            ttl = e.get("ttl_remaining")
            self._entries[self._key(op, backend, sched)] = {
                "op": op, "backend": backend, "schedule": sched,
                "reason": str(e.get("reason", "restored")),
                "entered_tick": self._tick,
                "expires_tick": (None if ttl is None
                                 else self._tick + int(ttl)),
            }
            n += 1
        return n

    def telemetry(self) -> Dict[str, float]:
        return ordered({
            "entries": float(len(self._entries)),
            "entered": float(self.entered),
            "expired": float(self.expired),
            "blocked_hits": float(self.blocked_hits),
        })


# ---------------------------------------------------------------------------
# dense reference registry (the ladder's last rung)
# ---------------------------------------------------------------------------

# op name -> builder(operands, schedule, **op_kwargs) -> run(*runtime).
# Builder contract: the builder call itself must be CHEAP — eager type and
# size-cap validation only (raise TypeError for operands it cannot
# reference; make_dense_run turns that into "no dense rung", ending the
# chain at torch). The O(n*m) densification is deferred inside the returned
# ``run`` and happens only if the guard actually falls to the dense rung —
# plan() calls make_dense_run on every build, so an eager to_dense() here
# would materialize dense copies of every planned operand.
_DENSE_REFS: Dict[str, Callable] = {}


def register_dense_ref(op: str, builder: Callable) -> None:
    """Register the numpy reference implementation used as an op's final
    fallback rung (ops_builtin registers the six built-in ops). The
    builder must defer densification into the returned run — see the
    ``_DENSE_REFS`` contract above."""
    _DENSE_REFS[op] = builder


def _on_card(op_kwargs: Dict) -> bool:
    return torch.device(op_kwargs.get("device", "cpu")).type != "cpu"


def make_dense_run(op: str, operands, schedule,
                   op_kwargs: Dict) -> Optional[Callable]:
    """Cheap, plan-time construction of the dense rung: the builder only
    validates eligibility (types, ``dense_ref_cap``); no dense data exists
    until the returned run is actually invoked. A plan on the card
    (``op_kwargs["device"]``) has no dense rung: it would compute on the
    host in the kernel's place."""
    builder = _DENSE_REFS.get(op)
    if builder is None or _on_card(op_kwargs):
        return None
    try:
        return builder(operands, schedule, **op_kwargs)
    except (TypeError, ValueError):
        return None     # unsupported or over-cap operands: no dense rung


def make_dense_bucket_run(op: str, members: Sequence, schedule,
                          op_kwargs: Dict) -> Optional[Callable]:
    """Per-member dense references behind one bucket-shaped entry point
    (``execute(xs)`` for matvec buckets, ``execute()`` for spgemm/spadd).
    Like ``make_dense_run`` this is cheap per tick: member densification
    is deferred until the bucket actually falls to the dense rung. None on
    the card, as there."""
    builder = _DENSE_REFS.get(op)
    if builder is None or _on_card(op_kwargs):
        return None
    try:
        runs = [builder(tuple(m) if isinstance(m, (tuple, list)) else (m,),
                        schedule, **op_kwargs) for m in members]
    except (TypeError, ValueError):
        return None

    def run(*runtime):
        if runtime:
            (xs,) = runtime
            return [r(x) for r, x in zip(runs, xs)]
        return [r() for r in runs]

    return run


# ---------------------------------------------------------------------------
# guarded execution
# ---------------------------------------------------------------------------

def _float_leaves(out: Any) -> List:
    """The float arrays of an op output: tensors and numpy arrays, the
    blocks of a "bsr" (or any) ``SparseTensor``, and per-member lists."""
    if out is None:
        return []
    if isinstance(out, (list, tuple)):
        return [leaf for o in out for leaf in _float_leaves(o)]
    arrays = getattr(out, "arrays", None)
    if isinstance(arrays, dict):                 # SparseTensor result
        return _float_leaves([v for v in arrays.values()])
    if isinstance(out, torch.Tensor):
        return [out] if out.is_floating_point() else []
    if isinstance(out, np.ndarray) and np.issubdtype(out.dtype, np.floating):
        return [out]
    return []


def output_finite(out: Any) -> bool:
    """True if every float leaf of an op output is finite. Understands the
    facade's output shapes: tensors (on any device) and numpy arrays,
    ``SparseTensor`` results (their blocks), and per-member lists from
    bucket plans. Device tensors are reduced ON THE DEVICE to their
    ``aminmax`` (a reduction, so no full-size temporary: ``isfinite(t)``
    would make one byte per element). NaN propagates through both extrema
    and +-Inf reaches one of them, so a leaf is finite iff they are; -0.0
    is finite. Only one boolean verdict crosses to the host,
    and that read is the launch's one wait (``Plan.execute``'s stream
    synchronize then finds the stream idle). Latency-critical callers can
    disable the check with ``GuardedExecutor(nan_guard=False)`` or
    ``REPRO_NAN_GUARD=0``."""
    extrema: List[torch.Tensor] = []
    for leaf in _float_leaves(out):
        if isinstance(leaf, np.ndarray):
            if not np.isfinite(leaf).all():
                return False
        elif leaf.numel():
            extrema += [m.reshape(1) for m in torch.aminmax(leaf)]
    return not extrema or bool(torch.isfinite(torch.cat(extrema)).all())


class GuardedExecutor:
    """Policy + telemetry for guarded plan builds and launches.

    One executor (the module default, unless a caller passes its own) is
    shared by every guarded plan in the process, so its counters are the
    serving loop's failure ledger: fallbacks taken, NaN guards tripped,
    dense rungs served, build retries, chains exhausted.
    """

    # registry-backed counter views (DESIGN.md §12); ``fallbacks`` keeps
    # its per-op Counter shape, with the total mirrored to the scope by
    # ``count_fallback`` so the registry snapshot carries it too
    nan_trips = scoped_int("nan_trips")
    dense_served = scoped_int("dense_served")
    dense_builds = scoped_int("dense_builds")
    build_retries = scoped_int("build_retries")
    exhausted = scoped_int("exhausted")
    quarantine_skips = scoped_int("quarantine_skips")
    quarantine_overrides = scoped_int("quarantine_overrides")

    def __init__(self, quarantine: Optional[Quarantine] = None,
                 nan_guard: Optional[bool] = None,
                 max_build_retries: int = 1) -> None:
        self._metrics = default_registry().scope("guarded_executor")
        self.quarantine = quarantine if quarantine is not None else Quarantine()
        # nan_guard=None reads REPRO_NAN_GUARD (default on). The check
        # synchronizes on each launch's result, so latency-critical
        # production serving can opt out process-wide via the env var
        # without touching call sites.
        if nan_guard is None:
            nan_guard = os.environ.get("REPRO_NAN_GUARD", "1") != "0"
        self.nan_guard = bool(nan_guard)
        self.max_build_retries = int(max_build_retries)
        self.fallbacks: "Counter[str]" = Counter()   # per op

    def count_fallback(self, op: str) -> None:
        self.fallbacks[op] += 1
        self._metrics.inc("fallbacks")

    def chain_from(self, backend: str, has_dense: bool,
                   on_card: bool = False) -> List[str]:
        """The rungs a plan on ``backend`` may run, in order. On the card
        that is ``backend`` alone: a fault there is counted, quarantined
        and raised, never served by the plain version or the host."""
        if on_card:
            return [backend]
        if backend in FALLBACK_CHAIN:
            chain = list(FALLBACK_CHAIN[FALLBACK_CHAIN.index(backend):])
        else:
            chain = [backend, "dense"]
        if not has_dense:
            chain = [b for b in chain if b != "dense"]
        return chain or [backend]

    def telemetry(self) -> Dict[str, float]:
        return ordered({
            "fallbacks": self._metrics.get("fallbacks"),
            "nan_trips": float(self.nan_trips),
            "dense_served": float(self.dense_served),
            "dense_builds": float(self.dense_builds),
            "build_retries": float(self.build_retries),
            "exhausted": float(self.exhausted),
            "quarantine_skips": float(self.quarantine_skips),
            "quarantine_overrides": float(self.quarantine_overrides),
        })


_DEFAULT_QUARANTINE = Quarantine()
_DEFAULT_EXECUTOR = GuardedExecutor(quarantine=_DEFAULT_QUARANTINE)


def default_quarantine() -> Quarantine:
    return _DEFAULT_QUARANTINE


def default_executor() -> GuardedExecutor:
    return _DEFAULT_EXECUTOR


def reset_resilience() -> None:
    """Fresh default executor/quarantine and no injector (test isolation)."""
    global _DEFAULT_QUARANTINE, _DEFAULT_EXECUTOR, _INJECTOR
    _DEFAULT_QUARANTINE = Quarantine()
    _DEFAULT_EXECUTOR = GuardedExecutor(quarantine=_DEFAULT_QUARANTINE)
    _INJECTOR = None


def guarded_build(build: Callable[[], Any], *, op: str, schedule=None,
                  dense_run: Optional[Callable] = None,
                  n_members: int = 1,
                  executor: Optional[GuardedExecutor] = None):
    """Run a plan build under the guard: transient failures (injected prep
    faults, corrupted host state) retry up to ``max_build_retries``; a
    build that still fails degrades to a dense-reference plan when the op
    has one (on the CPU only: ``make_dense_run`` gives a plan on the card
    none), and only then re-raises."""
    ex = executor if executor is not None else default_executor()
    attempts = 0
    while True:
        try:
            return build()
        except GUARDED_EXCEPTIONS as e:
            attempts += 1
            if attempts <= ex.max_build_retries:
                _note_handled(e)
                ex.build_retries += 1
                continue
            if dense_run is None:
                raise
            _note_handled(e)
            ex.dense_builds += 1
            from .plan import Plan
            return Plan(op=op, schedule=schedule, backend="dense",
                        _run=dense_run, source="guard-dense",
                        n_members=n_members)


def guard_plan(p, rebuild: Optional[Callable] = None,
               dense_run: Optional[Callable] = None, *,
               site: str = "launch",
               executor: Optional[GuardedExecutor] = None):
    """Wrap ``p._run`` in the backend fallback ladder.

    On a guarded failure (exception or non-finite output) the failing
    ``(op, backend, schedule)`` combo enters the quarantine, the plan is
    rebuilt one rung down via ``rebuild(backend)`` (cheap when a
    PreparedStore holds the prep), and the launch re-executes — callers
    see a slower answer, never a crash, until the chain is exhausted. A
    plan on the card has a chain of one rung (``chain_from``), so there
    the failure is counted (``exhausted``, ``nan_trips``), the combo
    quarantined and the error raised.
    Rung state persists across ``execute`` calls: a plan that fell to torch
    stays there instead of re-failing every launch. Already-quarantined
    rungs are skipped up front, so a poisoned combo is never re-served —
    with one deliberate exception: on the chain's FINAL rung a quarantined
    combo is executed anyway (a degraded answer beats no answer). Those
    last-resort serves are counted in ``quarantine_overrides`` so the
    contract bend is observable, never silent.
    """
    ex = executor if executor is not None else default_executor()
    chain = ex.chain_from(p.backend, dense_run is not None,
                          on_card=p.device.type == "cuda")
    if len(chain) == 1 and chain[0] == p.backend and dense_run is None \
            and p.backend not in FALLBACK_CHAIN:
        return p    # unknown backend, nothing to fall back to
    op, schedule = p.op, p.schedule
    state = {"rung": 0, "run": p._run}

    def guarded(*runtime):
        while True:
            b = chain[state["rung"]]
            if b != "dense" and ex.quarantine.blocked(op, b, schedule):
                if state["rung"] + 1 < len(chain):
                    ex.quarantine_skips += 1
                    obs_trace.emit("fallback", f"{op}:{b}", op=op,
                                   from_backend=b,
                                   to_backend=chain[state["rung"] + 1],
                                   reason="quarantined")
                    state["rung"] += 1
                    state["run"] = None
                    continue
                ex.quarantine_overrides += 1    # last rung: serve anyway
            try:
                if b == "dense":
                    out = dense_run(*runtime)
                else:
                    check_fault(site, f"{op}:{b}")
                    if state["run"] is None:
                        if rebuild is None:
                            raise RuntimeError(
                                f"no rebuild path for op {op!r} rung {b!r}")
                        state["run"] = rebuild(b)._run
                        p.backend = b
                    out = state["run"](*runtime)
                if ex.nan_guard and not output_finite(out):
                    raise NonFiniteOutput(
                        f"{op} produced non-finite output on backend {b!r}")
                if b == "dense":
                    ex.dense_served += 1
                    p.backend = "dense"
                return out
            except GUARDED_EXCEPTIONS as e:
                if isinstance(e, NonFiniteOutput):
                    ex.nan_trips += 1
                if b != "dense":
                    ex.quarantine.add(op, b, schedule,
                                      reason=type(e).__name__)
                if state["rung"] + 1 >= len(chain):
                    ex.exhausted += 1
                    raise
                _note_handled(e)
                ex.count_fallback(op)
                obs_trace.emit("fallback", f"{op}:{b}", op=op,
                               from_backend=b,
                               to_backend=chain[state["rung"] + 1],
                               reason=type(e).__name__)
                state["rung"] += 1
                state["run"] = None

    p._run = guarded
    return p


def unquarantined_select(tuner, A, op: str,
                         quarantine: Optional[Quarantine] = None):
    """Tree-argmin re-selection over the candidate grid EXCLUDING
    quarantined schedules — the ScheduleTuner-path guarantee that a
    poisoned schedule is never re-served (plan() calls this when the
    tuner's pick is quarantined). Returns None when every candidate is
    blocked (caller keeps the original pick rather than serving nothing).
    """
    from ..core import metrics as metrics_mod
    from ..core.autotune import candidate_schedules
    q = quarantine if quarantine is not None else default_quarantine()
    avail = [s for s in candidate_schedules(tuner.n_rhs)
             if not q.blocked_any_backend(op, s)]
    if not avail:
        return None
    static = metrics_mod.characterize(A)
    return min(avail, key=lambda s: tuner.predict_time(static, s))


# ---------------------------------------------------------------------------
# deadline / backoff admission
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Deadline:
    """Absolute per-request deadline on the monotonic clock."""

    t_deadline: float

    @classmethod
    def after_ms(cls, ms: float,
                 now: Optional[float] = None) -> "Deadline":
        now = time.monotonic() if now is None else now
        return cls(now + float(ms) / 1e3)

    def exceeded(self, now: Optional[float] = None) -> bool:
        return (time.monotonic() if now is None else now) > self.t_deadline

    def remaining_s(self, now: Optional[float] = None) -> float:
        return self.t_deadline - (time.monotonic() if now is None else now)


def with_backoff(fn: Callable[[], Any], *, max_retries: int = 2,
                 base_s: float = 0.005,
                 sleep: Callable[[float], None] = time.sleep,
                 on_retry: Optional[Callable] = None) -> Any:
    """Bounded retry with exponential backoff — a restart supervisor's
    shape sized for one serving call:
    retry, back off ``base_s * 2**attempt``, give up after ``max_retries``
    and let the caller decide (the SelectorService counts the failure and
    keeps serving)."""
    attempt = 0
    while True:
        try:
            return fn()
        except GUARDED_EXCEPTIONS as e:
            attempt += 1
            if attempt > max_retries:
                raise
            _note_handled(e)
            if on_retry is not None:
                on_retry(attempt, e)
            sleep(base_s * (2 ** (attempt - 1)))


# ---------------------------------------------------------------------------
# checksummed atomic persistence
# ---------------------------------------------------------------------------

def entry_checksum(entry: Dict) -> int:
    """crc32 over the canonical JSON form of one persisted entry (the
    ``crc`` field itself excluded)."""
    clean = {k: v for k, v in entry.items() if k != "crc"}
    return zlib.crc32(json.dumps(clean, sort_keys=True,
                                 separators=(",", ":")).encode())


def checksum_entries(entries: Sequence[Dict]) -> List[Dict]:
    return [dict(e, crc=entry_checksum(e)) for e in entries]


def verify_entries(entries: Sequence[Dict]) -> Tuple[List[Dict], int]:
    """(valid entries with ``crc`` stripped, corrupt count): entries whose
    checksum is missing or wrong are skipped and counted, never raised —
    one flipped bit costs one entry, not the file."""
    ok: List[Dict] = []
    corrupt = 0
    for e in entries:
        if not isinstance(e, dict) or "crc" not in e:
            corrupt += 1
            continue
        if entry_checksum(e) != e["crc"]:
            corrupt += 1
            continue
        ok.append({k: v for k, v in e.items() if k != "crc"})
    return ok, corrupt


def atomic_write_json(path: str, payload: Dict) -> None:
    """Crash-safe JSON write: unique temp file in the target directory,
    fsync, then ``os.replace`` — a crash (or injected cache-write fault)
    at any point leaves the previous file intact. Raises on failure; the
    caller counts the failure and keeps the in-memory state."""
    check_fault("cache-write", path)
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path) + ".",
                               suffix=".tmp", dir=d)
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def load_json_guarded(path: str) -> Optional[Dict]:
    """Best-effort JSON load: a missing, unreadable, truncated, or
    non-JSON file returns None (cold start from empty) — corruption is the
    caller's counter, never their crash. An injected cache-read fault is
    absorbed here (counted as recovered) and served as None."""
    if fault_fired("cache-read", path):
        note_recovery("cache-read")
        return None
    try:
        with open(path) as f:
            payload = json.load(f)
    except (OSError, ValueError):
        return None
    return payload if isinstance(payload, dict) else None
