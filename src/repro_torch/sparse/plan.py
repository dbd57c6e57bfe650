"""plan/execute: the compile-style front door to the sparse kernels (port of
``repro.sparse.plan`` for spmv, spmm, spgemm and spadd).

``plan(op, operands, schedule=...)`` runs the op's host-side prep once and
returns a ``Plan`` — an executable carrying the resolved schedule, the
backend and the prepared device operands. ``plan_bucket`` builds ONE launch
for a whole same-schedule bucket: the member axis is on the kernel grid.

Device and backend are explicit. Every entry point takes ``device=``, the
card by default, and raises when the card is asked for and there is none;
``backend="auto"`` is the CUDA kernel on the card and the plain PyTorch
version on the CPU. There is no fallback ladder: the planner is called
directly, and a kernel that fails to build or launch raises.

Telemetry, under the JAX package's names in the process
``MetricsRegistry``: ``plan.launches.<op>`` ticks once per
``Plan.execute`` (a bucket of N members bumps it once), and each execute is
timed into the ``launch_ms.<op>`` histogram, the ``launch`` trace span and
``Plan.last_measured_s``. ``execute`` synchronises the current stream before
it reads the clock, so the time is end to end, not the enqueue. There is no
``trace_count``: PyTorch runs eagerly and never retraces.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..core.autotune import Schedule
from ..core.csr import BSR, ELLBSR, SELLBSR
from ..kernels.common import resolve_backend, resolve_device
from ..obs import default_registry, trace as obs_trace
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
    source: str = "explicit"            # "explicit" | "default"
    modeled_time_s: Optional[float] = None
    n_members: int = 1                  # >1 for stacked bucket plans
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
            ev.update(op=self.op, backend=self.backend,
                      layout=("dense" if s is None or s.backend == "dense"
                              else s.layout),
                      measured_ms=dt * 1e3,
                      modeled_ms=(self.modeled_time_s * 1e3
                                  if self.modeled_time_s else None),
                      source=self.source, n_members=self.n_members)
        default_registry().observe(f"launch_ms.{self.op}", dt * 1e3)
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


def _refuse_unported(selector, executor) -> None:
    """``selector=`` and ``executor=`` come with later slices of the port;
    until then they raise instead of being dropped."""
    if executor is not None:
        raise TypeError("executor= (GuardedExecutor) is not ported yet: it "
                        "comes with ROADMAP Queue A item 1, guarded "
                        "execution")
    if selector is not None:
        raise TypeError("selector= is not ported yet: it comes with ROADMAP "
                        "Queue A item 2, the selector service")


def plan(op: str, operands, schedule: Optional[Schedule] = None,
         backend: str = "auto", store: Optional[PreparedStore] = None,
         device="cuda", *, selector=None, executor=None,
         **op_kwargs) -> Plan:
    """Build an executable ``Plan`` for a registered sparse op on
    ``device`` (the card unless ``device="cpu"``).

    ``schedule`` names the layout and block size; without one the op
    planner's defaults apply. ``store`` is a ``PreparedStore``: repeat
    traffic for the same (matrix bytes, schedule, device) reuses the
    finished device operands and skips host prep. ``selector`` and
    ``executor`` raise ``TypeError`` (not ported yet), as does any keyword
    the op's planner does not take.
    """
    _refuse_unported(selector, executor)
    spec = get_op(op)
    if not isinstance(operands, tuple):
        operands = (operands,)
    dev = resolve_device(device)
    backend = resolve_backend(backend, dev)
    if schedule is not None and schedule.backend != "dense" \
            and spec.layouts and schedule.layout not in spec.layouts:
        raise ValueError(f"op {op!r} supports layouts {spec.layouts}, "
                         f"schedule asks for {schedule.layout!r}")
    if store is not None and spec.planner_store_ok:
        op_kwargs = dict(op_kwargs, store=store)
    with obs_trace.span("prep", f"plan:{op}", op=op):
        return spec.planner(operands, schedule, backend, device=dev,
                            **op_kwargs)


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
                selector=None, executor=None, **op_kwargs) -> Plan:
    """ONE launch for a whole same-schedule bucket.

    ``operands`` is a list of per-member operands (CSR or prepared; an
    (A, B) pair per member for spgemm/spadd); the plan's ``execute`` takes
    the matching list of runtime inputs (none for spgemm/spadd) and
    returns the per-member outputs. Every member is validated against the
    bucket's shared Schedule up front, so a mixed bucket fails here with a
    per-member error. ``selector`` and ``executor`` raise ``TypeError``
    (not ported yet), as does any keyword the bucket planner does not take.
    """
    _refuse_unported(selector, executor)
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
    with obs_trace.span("prep", f"plan_bucket:{op}", op=op,
                        n_members=len(members)):
        return spec.bucket_planner(members, schedule, backend, device=dev,
                                   **op_kwargs)
