"""plan/execute: the compile-style front door to the sparse kernels (port of
``repro.sparse.plan``).

``plan(op, operands, schedule=... | selector=...)`` resolves a ``Schedule``
(explicitly, through a fitted ``ScheduleTuner``, or through the online
``SelectorService`` cache/tree/verify path), runs the op's host-side prep
once, and returns a ``Plan`` — an executable carrying the resolved
schedule, the selection provenance (source / fingerprint / confidence /
modeled cost), the backend and the prepared device operands.
``plan_bucket`` builds ONE launch for a whole same-schedule bucket: the
member axis is on the kernel grid. ``plan_sharded`` splits a matrix's rows
into nnz-balanced shards, resolves one schedule per shard and executes
them as one stacked launch (one schedule) or per-shard launches on their
own CUDA streams (several, or the shards of a prepared
``ShardedSparseTensor``).

Device and backend are explicit. Every entry point takes ``device=``, the
card by default, and raises when the card is asked for and there is none;
``backend="auto"`` is the CUDA kernel on the card and the plain PyTorch
version on the CPU, resolved before the guard is built. Every build and
every launch runs under the ``GuardedExecutor`` (``resilience``): a
transient prep fault retries; on the CPU a failed or non-finite launch
falls one rung down the ladder torch -> dense (counted, traced, the combo
quarantined), and past the last rung the error is raised. On the card the
ladder is the CUDA kernel alone: its failure is counted, the combo
quarantined and the error raised, never served by the plain version or
the host. A kernel wrapper never falls back by itself.

Telemetry, under the JAX package's names in the process
``MetricsRegistry``: ``plan.launches.<op>`` ticks once per
``Plan.execute`` (a bucket of N members bumps it once), and each execute is
timed into the ``launch_ms.<op>`` histogram, the ``launch`` trace span and
``Plan.last_measured_s``, and, where the plan carries a modeled time, its
log10 ratio to it into ``residual_log10.<op>``. ``execute`` synchronises
the current stream before it reads the clock, so the time is end to end,
not the enqueue; the guard's finiteness check runs inside the timed launch.
There is no ``trace_count``: PyTorch runs eagerly and never retraces.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.autotune import Schedule
from ..core.csr import BSR, CSR, ELLBSR, SELLBSR
from ..kernels.common import resolve_backend, resolve_device
from ..obs import default_registry, trace as obs_trace
from . import resilience
from .prepared import PreparedStore
from .registry import get_op
from .tensor import SparseTensor


def _bump_launch(key: str) -> None:
    default_registry().inc(f"plan.launches.{key}")


def launch_count(op: Optional[str] = None) -> int:
    """Number of ``Plan.execute`` launches (per op, or total)."""
    reg = default_registry()
    return int(round(reg.get(f"plan.launches.{op}") if op
                     else reg.sum_prefix("plan.launches.")))


def reset_counters() -> None:
    default_registry().clear_prefix("plan.launches.")


@dataclasses.dataclass
class Plan:
    """An executable sparse-op launch with its provenance."""

    op: str
    schedule: Optional[Schedule]
    backend: str
    _run: Callable
    device: torch.device = torch.device("cpu")
    operands: tuple = ()                # prepared device operands
    source: str = "explicit"            # "explicit" | "tuner" | "selector-*"
    fingerprint_key: str = ""
    modeled_time_s: Optional[float] = None
    confidence: Optional[float] = None
    n_members: int = 1                  # >1 for stacked bucket plans
    n_shards: int = 1                   # >1 for sharded plans
    # per-shard selection provenance of a sharded plan: one dict per shard
    # with its source, schedule and (from a selector) fingerprint key,
    # confidence and modeled time
    shard_provenance: Optional[List[Dict]] = None
    # end-to-end time of the most recent execute: the launch, the guard's
    # finiteness check and the stream synchronize
    last_measured_s: Optional[float] = None

    def execute(self, *runtime):
        """Run the planned launch on the runtime inputs (stacked plans run
        their whole bucket here), synchronised and timed into the
        ``launch_ms.<op>`` histogram and the ``launch`` span."""
        _bump_launch(self.op)
        with obs_trace.span("launch", f"{self.op}") as ev:
            t0 = time.monotonic()
            out = self._run(*runtime)
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
            dt = time.monotonic() - t0
            self.last_measured_s = dt
            s = self.schedule
            modeled_ms = (self.modeled_time_s * 1e3
                          if self.modeled_time_s else None)
            # backend read AFTER the run: the guard rewrites it when the
            # launch fell down the fallback ladder
            if s is None and self.n_shards > 1:
                layout = "per-shard"
            else:
                layout = ("dense" if s is None or s.backend == "dense"
                          else s.layout)
            ev.update(op=self.op, backend=self.backend, layout=layout,
                      measured_ms=dt * 1e3, modeled_ms=modeled_ms,
                      source=self.source, n_members=self.n_members,
                      n_shards=self.n_shards)
        reg = default_registry()
        reg.observe(f"launch_ms.{self.op}", dt * 1e3)
        if modeled_ms:
            reg.observe(f"residual_log10.{self.op}",
                        math.log10(max(dt * 1e3, 1e-9) / modeled_ms))
        return out

    __call__ = execute

    def describe(self) -> str:
        s = self.schedule
        if s is None:
            sched = "per-shard" if self.n_shards > 1 else "none"
        elif s.backend == "dense":
            sched = "dense"
        else:
            lay = (f"sell C={s.slice_height}" if s.layout == "sell"
                   else f"ell q={s.ell_quantile}")
            sched = f"{s.backend} bs={s.block_size} {lay} rhs={s.n_rhs}"
        extra = f" members={self.n_members}" if self.n_members > 1 else ""
        if self.n_shards > 1:
            extra = f" shards={self.n_shards}"
        return (f"plan[{self.op}] {sched} {self.backend}@{self.device} "
                f"via {self.source}{extra}")


def _resolve_with_selector(selector, A: CSR, op: str = "",
                           quarantine=None):
    """(Schedule, provenance, operand content key) from a SelectorService
    or a ScheduleTuner. The service already hashed the matrix bytes for its
    fingerprint memo; the key is forwarded so the planner's PreparedStore
    lookup does not pay a second O(nnz) hashing pass. ``quarantine`` is the
    registry the tuner path consults (defaults to the process-wide one)."""
    if not isinstance(A, CSR):
        raise TypeError("selector-based planning needs a CSR first operand, "
                        f"got {type(A).__name__}")
    if hasattr(selector, "process_pending"):      # SelectorService
        dec = selector.select(A)
        return dec.schedule, {
            "source": f"selector-{dec.source}",
            "fingerprint_key": dec.fingerprint_key,
            "modeled_time_s": dec.modeled_time_s,
            "confidence": dec.confidence,
        }, getattr(dec, "ck", None)
    if hasattr(selector, "select"):               # ScheduleTuner
        schedule, info = selector.select(A)
        source = "tuner"
        q = (quarantine if quarantine is not None
             else resilience.default_quarantine())
        if op and schedule is not None \
                and q.blocked_any_backend(op, schedule):
            # never re-serve a poisoned schedule: re-argmin the candidate
            # grid minus the quarantine (None = everything blocked; keep
            # the pick — a degraded answer beats no answer)
            resel = resilience.unquarantined_select(selector, A, op, q)
            if resel is not None:
                schedule, source = resel, "tuner-requarantined"
        return schedule, {
            "source": source,
            "modeled_time_s": info.get("verified_time_s"),
        }, None
    raise _unsupported_selector(selector)


def _unsupported_selector(selector) -> TypeError:
    return TypeError(f"unsupported selector {type(selector).__name__}; "
                     "pass a SelectorService or a fitted ScheduleTuner")


def plan(op: str, operands, schedule: Optional[Schedule] = None,
         backend: str = "auto", store: Optional[PreparedStore] = None,
         device="cuda", *, selector=None,
         executor: Optional[resilience.GuardedExecutor] = None,
         **op_kwargs) -> Plan:
    """Build an executable ``Plan`` for a registered sparse op on
    ``device`` (the card unless ``device="cpu"``).

    Exactly one schedule source applies: an explicit ``schedule``, a
    ``selector`` (``SelectorService`` -> cache/tree/verify path, or a
    fitted ``ScheduleTuner`` -> tree-argmin + simulation verify), or the
    op planner's defaults.

    ``store`` is a ``PreparedStore``: repeat traffic for the same (matrix
    bytes, schedule, device) reuses the finished device operands and skips
    host prep. When planning through a ``SelectorService`` the service's
    own store is used unless one is passed explicitly.

    ``executor`` is the ``GuardedExecutor`` (fallback policy + failure
    ledger + quarantine) the build and every launch run under; it defaults
    to the selector's own executor when planning through a
    ``SelectorService``, else the process-wide default. Any keyword the
    op's planner does not take raises ``TypeError``.
    """
    spec = get_op(op)
    if not isinstance(operands, tuple):
        operands = (operands,)
    dev = resolve_device(device)
    backend = resolve_backend(backend, dev)
    provenance: Dict[str, object] = {}
    operand_key = None
    if selector is not None and store is None:
        store = getattr(selector, "prepared_store", None)
    if executor is None and selector is not None:
        executor = getattr(selector, "executor", None)
    quarantine = executor.quarantine if executor is not None else None
    if schedule is None and selector is not None:
        schedule, provenance, operand_key = _resolve_with_selector(
            selector, operands[0], op, quarantine=quarantine)
    if schedule is not None and schedule.backend != "dense" \
            and spec.layouts and schedule.layout not in spec.layouts:
        raise ValueError(f"op {op!r} supports layouts {spec.layouts}, "
                         f"schedule asks for {schedule.layout!r}")
    if store is not None and spec.planner_store_ok:
        op_kwargs = dict(op_kwargs, store=store)
        if operand_key is not None and spec.planner_operand_key_ok:
            op_kwargs.setdefault("operand_key", operand_key)
    # guarded build + guarded launch (DESIGN.md §11): transient prep faults
    # retry, persistent ones degrade to the op's dense reference (on the
    # CPU; on the card they raise); every execute runs through the backend
    # fallback ladder, whose rebuild prepares one rung down through the
    # same store
    dense_run = resilience.make_dense_run(op, operands, schedule,
                                          dict(op_kwargs, device=dev))
    with obs_trace.span("prep", f"plan:{op}", op=op):
        p = resilience.guarded_build(
            lambda: spec.planner(operands, schedule, backend, device=dev,
                                 **op_kwargs),
            op=op, schedule=schedule, dense_run=dense_run,
            executor=executor)
    resilience.guard_plan(
        p, rebuild=lambda b: spec.planner(operands, schedule, b, device=dev,
                                          **op_kwargs),
        dense_run=dense_run, executor=executor)
    for k, v in provenance.items():
        setattr(p, k, v)
    return p


def plan_sharded(op: str, operands, n_shards: Optional[int] = None,
                 schedule: Optional[Schedule] = None,
                 schedules: Optional[Sequence[Schedule]] = None,
                 selector=None, strategy: str = "nnz", backend: str = "auto",
                 store: Optional[PreparedStore] = None, device="cuda", *,
                 executor: Optional[resilience.GuardedExecutor] = None,
                 **op_kwargs) -> Plan:
    """Sharded plan on ``device``: nnz-balanced row shards, one schedule
    per shard.

    The first operand's rows are partitioned into ``n_shards`` contiguous
    shards (``strategy="nnz"`` balances work through the Eq. 5 counters;
    ``"rows"`` is the naive equal-row split). Each shard's schedule is
    resolved on its own: explicitly (``schedule`` for all shards,
    ``schedules`` per shard) or through the ``selector``, whose per-shard
    fingerprints let a skewed matrix get different layouts or block sizes
    per shard. The op's sharded planner builds the launch: one stacked
    launch when the shard schedules agree, per-shard launches on their own
    CUDA streams otherwise and for a prepared ``ShardedSparseTensor``, whose
    shards are already on the device. ``n_shards`` defaults to the number
    of cards
    on the card and to 1 on the CPU.

    Per-shard provenance lands on ``Plan.shard_provenance``. The
    PreparedStore (``store=``, or the selector's own) caches the partition
    and the prepared shard operands, so warm sharded plans skip both. The
    build and every launch run under the guard at the ``shard-dispatch``
    fault site.
    """
    from .partition import STRATEGIES, partition_rows
    from .tensor import ShardedSparseTensor
    spec = get_op(op)
    if spec.sharded_planner is None:
        raise ValueError(f"op {op!r} has no sharded execution path; "
                         "ops with one register a sharded_planner")
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown partition strategy {strategy!r}; "
                         f"one of {STRATEGIES}")
    if not isinstance(operands, tuple):
        operands = (operands,)
    dev = resolve_device(device)
    backend = resolve_backend(backend, dev)
    a = operands[0]
    if selector is not None and store is None:
        store = getattr(selector, "prepared_store", None)
    if executor is None and selector is not None:
        executor = getattr(selector, "executor", None)

    part = None
    shard_csrs: Optional[List[CSR]] = None
    ck: Optional[str] = None
    from_prepared = False
    if isinstance(a, ShardedSparseTensor):
        n_parts = a.n_shards
        if n_shards is not None and int(n_shards) != n_parts:
            raise ValueError(f"operand is already partitioned into "
                             f"{n_parts} shards; n_shards={n_shards} "
                             "cannot re-partition a ShardedSparseTensor")
        if schedules is None and schedule is None:
            if selector is not None:
                raise TypeError(
                    "selector-resolved sharded planning needs a CSR first "
                    "operand (a prepared ShardedSparseTensor carries its "
                    "shards' schedules; pass the CSR to re-select)")
            schedules = a.schedules()
            from_prepared = True
    elif isinstance(a, CSR):
        if n_shards is None:
            n_shards = torch.cuda.device_count() if dev.type == "cuda" else 1
        n_shards = max(int(n_shards), 1)
        if store is not None:
            from .prepared import content_key
            ck = content_key(a)
        part_key = None if ck is None else ("row_partition", ck,
                                            n_shards, strategy)
        built = store.get(part_key) if part_key is not None else None
        if built is None:
            part = partition_rows(a, n_shards, strategy)
            built = {"part": part, "shards": part.slice(a)}
            if part_key is not None:
                # host CSR slices hold no tensor, so the store's own
                # accounting would see 0 bytes and its LRU could never
                # evict them: count them here
                store.put(part_key, built, nbytes=sum(
                    arr.nbytes for c in built["shards"]
                    for arr in (c.row_ptrs, c.col_idxs, c.nnz_vals)))
        part = built["part"]
        shard_csrs = built["shards"]
        n_parts = part.n_parts
    else:
        raise TypeError("plan_sharded needs a CSR or ShardedSparseTensor "
                        f"first operand, got {type(a).__name__}")

    provenance: List[Dict]
    if schedules is not None:
        scheds = list(schedules)
        if len(scheds) != n_parts:
            raise ValueError(f"{len(scheds)} schedules for {n_parts} shards")
        src = "prepared" if from_prepared else "explicit"
        provenance = [{"source": src, "schedule": s} for s in scheds]
    elif schedule is not None:
        scheds = [schedule] * n_parts
        provenance = [{"source": "explicit", "schedule": schedule}
                      for _ in range(n_parts)]
    elif selector is not None:
        if shard_csrs is None:
            raise TypeError("selector-resolved sharded planning needs a CSR "
                            "first operand (shards must be characterized)")
        if hasattr(selector, "select_shards"):       # SelectorService
            decs = selector.select_shards(shard_csrs, name=f"{op}-shard")
            scheds = [d.schedule for d in decs]
            provenance = [{"source": f"selector-{d.source}",
                           "fingerprint_key": d.fingerprint_key,
                           "confidence": d.confidence,
                           "modeled_time_s": d.modeled_time_s,
                           "schedule": d.schedule} for d in decs]
        elif hasattr(selector, "select"):            # ScheduleTuner
            scheds, provenance = [], []
            for c in shard_csrs:
                s, info = selector.select(c)
                scheds.append(s)
                provenance.append({
                    "source": "tuner", "schedule": s,
                    "modeled_time_s": info.get("verified_time_s")})
        else:
            raise _unsupported_selector(selector)
    else:
        default = SparseTensor.default_schedule()
        scheds = [default] * n_parts
        provenance = [{"source": "default", "schedule": default}
                      for _ in range(n_parts)]
    for s in scheds:
        if s is not None and s.backend != "dense" and spec.layouts \
                and s.layout not in spec.layouts:
            raise ValueError(f"op {op!r} supports layouts {spec.layouts}, "
                             f"a shard schedule asks for {s.layout!r}")

    if store is not None and spec.sharded_store_ok:
        op_kwargs = dict(op_kwargs, store=store)
        if ck is not None:
            op_kwargs.setdefault("operand_key", ck)
    dense_run = resilience.make_dense_run(op, operands, scheds[0],
                                          dict(op_kwargs, device=dev))

    def build(b: str) -> Plan:
        return spec.sharded_planner(operands, tuple(scheds), b, device=dev,
                                    part=part, shard_csrs=shard_csrs,
                                    **op_kwargs)

    with obs_trace.span("prep", f"plan_sharded:{op}", op=op,
                        n_shards=n_parts):
        p = resilience.guarded_build(
            lambda: build(backend), op=op, schedule=scheds[0],
            dense_run=dense_run, executor=executor)
    if p.source != "guard-dense":
        p.source = f"sharded-{strategy}"
    resilience.guard_plan(p, rebuild=build, dense_run=dense_run,
                          site="shard-dispatch", executor=executor)
    p.shard_provenance = provenance
    return p


def _member_layout(m) -> Optional[str]:
    """Container layout a bucket member arrives in (None = raw CSR, which
    every op can prepare into its own layout)."""
    if isinstance(m, SparseTensor):
        return m.layout
    if isinstance(m, ELLBSR):
        return "ell"
    if isinstance(m, SELLBSR):
        return "sell"
    if isinstance(m, BSR):
        return "bsr"
    if isinstance(m, np.ndarray):
        return "dense"
    return None


def plan_bucket(op: str, operands: Sequence, schedule: Schedule,
                backend: str = "auto",
                store: Optional[PreparedStore] = None, device="cuda", *,
                selector=None,
                executor: Optional[resilience.GuardedExecutor] = None,
                **op_kwargs) -> Plan:
    """ONE launch for a whole same-schedule bucket.

    ``operands`` is a list of per-member operands (CSR or prepared; an
    (A, B) pair per member for spgemm/spadd); the plan's ``execute`` takes
    the matching list of runtime inputs (none for spgemm/spadd) and
    returns the per-member outputs. Every member is validated against the
    bucket's shared Schedule up front, so a mixed bucket fails here with a
    per-member error. The build and the launch run under ``executor``
    (the process-wide ``GuardedExecutor`` by default); the dense rung
    serves each member from its own dense reference. A ``SelectorService``
    as ``selector`` lends the bucket its store and executor unless they are
    passed (the bucket's shared schedule is still the caller's). Any
    keyword the bucket planner does not take raises ``TypeError``.
    """
    if selector is not None:
        if not hasattr(selector, "process_pending"):
            raise _unsupported_selector(selector)
        if store is None:
            store = selector.prepared_store
        if executor is None:
            executor = selector.executor
    spec = get_op(op)
    if spec.bucket_planner is None:
        raise ValueError(f"op {op!r} has no stacked bucket launch")
    if schedule is None:
        raise ValueError("plan_bucket needs the bucket's shared Schedule")
    if schedule.backend != "dense" and spec.layouts \
            and schedule.layout not in spec.layouts:
        raise ValueError(f"op {op!r} supports layouts {spec.layouts}, "
                         f"bucket schedule asks for {schedule.layout!r}")
    members: List = list(operands)
    if not members:
        raise ValueError("empty bucket")
    if spec.bucket_layouts is not None:
        allowed = tuple(spec.bucket_layouts(schedule))
        for i, m in enumerate(members):
            for part in (m if isinstance(m, (tuple, list)) else (m,)):
                got = _member_layout(part)
                if got is not None and got not in allowed:
                    raise ValueError(
                        f"bucket member {i} is a {got!r}-layout operand, "
                        f"incompatible with op {op!r} under the bucket's "
                        f"schedule (expected one of {allowed} or raw CSR); "
                        "buckets share one Schedule by construction")
    dev = resolve_device(device)
    backend = resolve_backend(backend, dev)
    if store is not None and spec.bucket_store_ok:
        op_kwargs = dict(op_kwargs, store=store)
    dense_run = resilience.make_dense_bucket_run(
        op, members, schedule, dict(op_kwargs, device=dev))
    with obs_trace.span("prep", f"plan_bucket:{op}", op=op,
                        n_members=len(members)):
        p = resilience.guarded_build(
            lambda: spec.bucket_planner(members, schedule, backend,
                                        device=dev, **op_kwargs),
            op=op, schedule=schedule, dense_run=dense_run,
            n_members=len(members), executor=executor)
    return resilience.guard_plan(
        p, rebuild=lambda b: spec.bucket_planner(members, schedule, b,
                                                 device=dev, **op_kwargs),
        dense_run=dense_run, executor=executor)
