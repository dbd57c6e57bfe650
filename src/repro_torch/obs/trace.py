"""Span tracer: one request's path through the stack, as data.

A :class:`Tracer` records typed spans/instants (the DESIGN.md §12 taxonomy,
``schema.EVENT_TYPES``) against an **injectable monotonic clock**, and
exports the same event stream two ways:

* a JSONL event log — one self-describing object per line, the
  machine-checkable record smoke.sh and the golden-schema test parse;
* Chrome-trace JSON (``{"traceEvents": [...]}``) that loads directly in
  Perfetto / ``chrome://tracing``, spans nested per thread.

Every event carries an ``id``, its ``parent`` (the innermost span open on
its thread when it started, else None) and a ``req``: the request id every
event of one ``request()`` scope shares (``plan()`` opens one), or,
outside any scope, of one outermost span (``Plan.execute``'s ``launch``).
Every recorded event also ticks ``events.<type>`` in the bound
:class:`~repro_torch.obs.metrics.MetricsRegistry` — which is what makes
"the JSONL per-event counts reconcile exactly with the registry snapshot"
a provable identity rather than a hope. Events are appended under one
lock; emitting from many threads is safe (each event carries its ``tid``,
and the open-span stack is per thread).

While a ``torch.profiler`` records, each span also opens
``torch.profiler.record_function("<type>:<name>")`` around its body, so
the program's spans sit in the device trace's own host timeline, on its
clock, and an idle gap of the card is named by the innermost span.

The process-wide installed tracer mirrors the FaultInjector pattern:
``install_tracer(t)`` turns instrumentation on, ``install_tracer(None)``
returns every ``emit``/``span``/``request`` call site to a no-op: one
shared context, the zero-overhead production default.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import sys
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

from .metrics import MetricsRegistry, default_registry
from .schema import EVENT_TYPES


# this process's id, read once (and again in a forked child): on some
# hosts os.getpid() is a system call that costs tens of microseconds
_PID = os.getpid()


def _forked() -> None:
    global _PID
    _PID = os.getpid()


os.register_at_fork(after_in_child=_forked)

_PROFILER_ENABLED: Optional[Callable[[], bool]] = None


def _profiling() -> bool:
    """True while a ``torch.profiler`` records in this process (none can
    before torch is imported). The check is whichever the installed torch
    has, found on first use."""
    global _PROFILER_ENABLED
    if _PROFILER_ENABLED is None:
        torch = sys.modules.get("torch")
        if torch is None:
            return False
        _PROFILER_ENABLED = getattr(
            torch._C._autograd, "_profiler_enabled", None) or (
            lambda: torch.autograd.profiler._is_profiler_enabled)
    return bool(_PROFILER_ENABLED())


class _Span:
    """One span of a :class:`Tracer` (``Tracer.span``): entering it yields
    its live fields dict."""

    __slots__ = ("_tracer", "_type", "_name", "_fields", "_mirror", "_id",
                 "_parent", "_req", "_stack", "_t0")

    def __init__(self, tracer: "Tracer", type_: str, name: str,
                 fields: Dict[str, Any]) -> None:
        tracer._check(type_)
        self._tracer, self._type, self._name = tracer, type_, name
        self._fields = fields

    def __enter__(self) -> Dict[str, Any]:
        tr = self._tracer
        self._mirror = None
        if _profiling():
            import torch
            self._mirror = torch.profiler.record_function(
                f"{self._type}:{self._name or self._type}")
            self._mirror.__enter__()
        stack = self._stack = tr._stack()
        self._parent, self._req = stack[-1] if stack \
            else (None, next(tr._reqs))
        self._id = next(tr._ids)
        stack.append((self._id, self._req))
        self._t0 = tr._now_us()
        return self._fields

    def __exit__(self, *exc: Any) -> bool:
        tr = self._tracer
        t1 = tr._now_us()
        self._stack.remove((self._id, self._req))
        tr._record(self._type, self._name, self._t0, t1 - self._t0,
                   self._fields, self._id, self._parent, self._req)
        if self._mirror is not None:
            self._mirror.__exit__(None, None, None)
        return False


class Tracer:
    """Typed span/event recorder over an injectable monotonic clock."""

    def __init__(self, clock: Optional[Callable[[], float]] = None,
                 registry: Optional[MetricsRegistry] = None,
                 strict: bool = True) -> None:
        self.clock = clock if clock is not None else time.monotonic
        self.registry = registry if registry is not None \
            else default_registry()
        # strict tracers reject types outside the DESIGN.md §12 taxonomy;
        # non-strict ones (benchmark module spans) may add categories.
        self.strict = bool(strict)
        self._lock = threading.RLock()
        self._events: List[Dict] = []
        self._t0 = self.clock()
        self._ids = itertools.count(1)
        self._reqs = itertools.count(1)
        self._local = threading.local()

    # ------------------------------------------------------------ recording
    def _now_us(self) -> float:
        return (self.clock() - self._t0) * 1e6

    def _check(self, type_: str) -> None:
        if self.strict and type_ not in EVENT_TYPES:
            raise ValueError(f"unknown event type {type_!r}; "
                             f"one of {EVENT_TYPES}")

    def _stack(self) -> List[Tuple[Optional[int], int]]:
        """This thread's open spans and request scopes, innermost last, as
        (span id, or None for a scope; request id)."""
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _place(self) -> Tuple[Optional[int], int]:
        """(parent, req) of an event starting now on this thread."""
        stack = self._stack()
        return stack[-1] if stack else (None, next(self._reqs))

    def _record(self, type_: str, name: str, ts_us: float, dur_us: float,
                args: Dict[str, Any], id_: int, parent: Optional[int],
                req: int) -> Dict:
        ev = {
            "type": type_,
            "name": name or type_,
            "ts_us": round(ts_us, 3),
            # the fake-clock tests pin this: durations are never negative,
            # even under a clock that stalls or a span timed across a reset
            "dur_us": round(max(dur_us, 0.0), 3),
            "pid": _PID,
            "tid": threading.get_ident(),
            "id": id_,
            "parent": parent,
            "req": req,
            "args": dict(args),
        }
        with self._lock:
            self._events.append(ev)
        self.registry.inc(f"events.{type_}")
        return ev

    @contextlib.contextmanager
    def request(self) -> Iterator[None]:
        """Scope one request: the events inside share a new request id,
        unless this thread is inside a span or scope already (then they
        share its id)."""
        stack = self._stack()
        if stack:
            yield
            return
        stack.append((None, next(self._reqs)))
        try:
            yield
        finally:
            stack.pop()

    def span(self, type_: str, name: str = "", **args: Any) -> _Span:
        """Timed span, a context; the fields dict it yields is live —
        fields added inside the ``with`` body (a decision source, a
        measured cost) are recorded. While a ``torch.profiler`` records,
        the body is also a ``record_function("<type>:<name>")`` range."""
        return _Span(self, type_, name, dict(args))

    def instant(self, type_: str, name: str = "", **args: Any) -> Dict:
        """Zero-duration event (quarantine entries, evictions, sheds)."""
        self._check(type_)
        parent, req = self._place()
        return self._record(type_, name, self._now_us(), 0.0, args,
                            next(self._ids), parent, req)

    # -------------------------------------------------------------- exports
    def events(self) -> List[Dict]:
        with self._lock:
            return list(self._events)

    def counts(self) -> Dict[str, int]:
        """Events per type — the reconciliation view against the registry's
        ``events.<type>`` counters."""
        out: Dict[str, int] = {}
        for ev in self.events():
            out[ev["type"]] = out.get(ev["type"], 0) + 1
        return out

    def jsonl(self) -> str:
        lines = []
        for ev in self.events():
            flat = {k: ev[k] for k in
                    ("type", "name", "ts_us", "dur_us", "pid", "tid")}
            flat.update(ev["args"])
            flat.update(id=ev["id"], parent=ev["parent"], req=ev["req"])
            lines.append(json.dumps(flat, sort_keys=True, default=str))
        return "\n".join(lines) + ("\n" if lines else "")

    def write_jsonl(self, path: str) -> int:
        evs = self.jsonl()
        with open(path, "w") as f:
            f.write(evs)
        return evs.count("\n")

    def chrome_trace(self) -> Dict:
        """Perfetto/chrome://tracing-compatible trace: every span is a
        complete ("X") event; same-thread spans nest by containment. The
        ``id`` / ``parent`` / ``req`` fields ride in each event's args."""
        trace_events = []
        for ev in self.events():
            trace_events.append({
                "name": ev["name"],
                "cat": ev["type"],
                "ph": "X",
                "ts": ev["ts_us"],
                "dur": ev["dur_us"],
                "pid": ev["pid"],
                "tid": ev["tid"],
                "args": dict(ev["args"], id=ev["id"], parent=ev["parent"],
                             req=ev["req"]),
            })
        return {"traceEvents": trace_events, "displayTimeUnit": "ms"}

    def write_chrome_trace(self, path: str) -> int:
        trace = self.chrome_trace()
        with open(path, "w") as f:
            json.dump(trace, f, indent=1, sort_keys=True, default=str)
        return len(trace["traceEvents"])


# ---------------------------------------------------------------------------
# process-wide installed tracer (the FaultInjector pattern)
# ---------------------------------------------------------------------------

_TRACER: Optional[Tracer] = None


class _Sink:
    """The fields of a span no tracer records: writes go nowhere."""

    __slots__ = ()

    def update(self, *args: Any, **kwargs: Any) -> None:
        pass

    def __setitem__(self, key: str, value: Any) -> None:
        pass


class _NoSpan:
    """The one context every ``span`` and ``request`` call gets while no
    tracer is installed."""

    __slots__ = ()

    def __enter__(self) -> _Sink:
        return _SINK

    def __exit__(self, *exc: Any) -> bool:
        return False


_SINK = _Sink()
_NO_SPAN = _NoSpan()


def install_tracer(t: Optional[Tracer]) -> Optional[Tracer]:
    """Install (or, with None, remove) the process-wide tracer every
    instrumented call site emits through."""
    global _TRACER
    _TRACER = t
    return t


def tracer() -> Optional[Tracer]:
    return _TRACER


def emit(type_: str, name: str = "", **args: Any) -> None:
    """Instant event through the installed tracer (no-op when none)."""
    if _TRACER is not None:
        _TRACER.instant(type_, name, **args)


def span(type_: str, name: str = "", **args: Any):
    """Span through the installed tracer; without one, the shared no-op
    context, whose fields take writes and keep none, so call sites never
    branch."""
    t = _TRACER
    if t is None:
        return _NO_SPAN
    return t.span(type_, name, **args)


def request():
    """Request scope through the installed tracer (``Tracer.request``);
    without one, the shared no-op context."""
    t = _TRACER
    if t is None:
        return _NO_SPAN
    return t.request()
