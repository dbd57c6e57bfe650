"""Op registry of the plan/execute facade (DESIGN.md §8).

Every sparse op the system serves is registered once, declaring its operand
spec (human-readable contract), its layout axis (the schedule values its
planner dispatches on), an optional host-side symbolic phase, and the
planner that turns (operands, Schedule, backend) into an executable
``Plan``. Ops that support the schedule-bucketed stacked launch also
register a ``bucket_planner`` (one jitted program for a whole same-schedule
bucket). ``repro_torch.sparse.plan`` is the only consumer. This slice
registers spmv and spmm; the other ops of ``repro.sparse`` come later.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Callable, Dict, Optional, Tuple


def _accepts_kwarg(fn: Callable, name: str) -> bool:
    """True if ``fn`` can receive keyword ``name`` (declared or **kwargs).
    Planners that cannot are simply not offered serving-path extras like
    ``store=`` — the public register_op contract stays (operands, schedule,
    backend, **kw-you-care-about)."""
    try:
        params = inspect.signature(fn).parameters.values()
    except (TypeError, ValueError):
        return True
    for p in params:
        if p.kind is inspect.Parameter.VAR_KEYWORD:
            return True
        if p.name == name and p.kind in (inspect.Parameter.KEYWORD_ONLY,
                                         inspect.Parameter.POSITIONAL_OR_KEYWORD):
            return True
    return False


@dataclasses.dataclass(frozen=True)
class OpSpec:
    """One registered sparse op."""

    name: str
    planner: Callable            # (operands, schedule, backend, **kw) -> Plan
    operand_spec: str = ""       # human-readable operand/runtime contract
    layouts: Tuple[str, ...] = ("ell",)   # schedule.layout values supported
    symbolic: Optional[Callable] = None   # host symbolic phase, if the op has one
    bucket_planner: Optional[Callable] = None  # stacked same-schedule launch
    # Container layouts a bucket member may arrive in for a given Schedule
    # (Schedule -> tuple of layout names). ``plan_bucket`` validates every
    # member against this BEFORE the stacked build, so a mixed bucket fails
    # with a per-member error instead of deep inside the planner.
    bucket_layouts: Optional[Callable] = None
    # Distributed plan path (DESIGN.md §10): turns (operands, per-shard
    # schedules, backend) plus the row partition into a Plan that executes
    # one shard per mesh slot. Ops without one reject plan_sharded().
    sharded_planner: Optional[Callable] = None
    # Whether the (bucket/sharded) planner can receive the serving-path
    # ``store=`` / ``operand_key=`` kwargs; computed at registration so
    # plan()/plan_bucket()/plan_sharded() never break a planner that does
    # not declare them.
    planner_store_ok: bool = True
    planner_operand_key_ok: bool = True
    bucket_store_ok: bool = True
    sharded_store_ok: bool = True


_REGISTRY: Dict[str, OpSpec] = {}


def register_op(name: str, planner: Callable, *, operand_spec: str = "",
                layouts: Tuple[str, ...] = ("ell",),
                symbolic: Optional[Callable] = None,
                bucket_planner: Optional[Callable] = None,
                bucket_layouts: Optional[Callable] = None,
                sharded_planner: Optional[Callable] = None,
                overwrite: bool = False) -> OpSpec:
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"op {name!r} already registered "
                         "(pass overwrite=True to replace)")
    spec = OpSpec(name, planner, operand_spec, tuple(layouts), symbolic,
                  bucket_planner, bucket_layouts, sharded_planner,
                  planner_store_ok=_accepts_kwarg(planner, "store"),
                  planner_operand_key_ok=_accepts_kwarg(planner,
                                                        "operand_key"),
                  bucket_store_ok=(bucket_planner is not None
                                   and _accepts_kwarg(bucket_planner, "store")),
                  sharded_store_ok=(sharded_planner is not None
                                    and _accepts_kwarg(sharded_planner,
                                                       "store")))
    _REGISTRY[name] = spec
    return spec


def get_op(name: str) -> OpSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown sparse op {name!r}; registered: "
                       f"{sorted(_REGISTRY)}") from None


def list_ops() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))
