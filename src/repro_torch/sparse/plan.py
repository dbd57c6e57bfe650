"""plan/execute: the compile-style front door to the sparse kernels (port of
``repro.sparse.plan`` without its sharded path).

``plan(op, operands, schedule=... | selector=...)`` resolves a ``Schedule``
(explicitly, through a fitted ``ScheduleTuner``, or through the online
``SelectorService`` cache/tree/verify path), runs the op's host-side prep
once, and returns a ``Plan`` — an executable carrying the resolved
schedule, the selection provenance (source / fingerprint / confidence /
modeled cost), the backend and the prepared device operands.
``plan_bucket`` builds ONE launch for a whole same-schedule bucket: the
member axis is on the kernel grid.

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
            ev.update(op=self.op, backend=self.backend,
                      layout=("dense" if s is None or s.backend == "dense"
                              else s.layout),
                      measured_ms=dt * 1e3, modeled_ms=modeled_ms,
                      source=self.source, n_members=self.n_members)
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
            sched = "none"
        elif s.backend == "dense":
            sched = "dense"
        else:
            lay = (f"sell C={s.slice_height}" if s.layout == "sell"
                   else f"ell q={s.ell_quantile}")
            sched = f"{s.backend} bs={s.block_size} {lay} rhs={s.n_rhs}"
        extra = f" members={self.n_members}" if self.n_members > 1 else ""
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
