"""Span tracer: one request's path through the stack, as data.

A :class:`Tracer` records typed spans/instants (the DESIGN.md §12 taxonomy:
select / prep / compile / launch / fallback / quarantine / shed /
store_evict) against an **injectable monotonic clock**, and exports the same
event stream two ways:

* a JSONL event log — one self-describing object per line, the
  machine-checkable record smoke.sh and the golden-schema test parse;
* Chrome-trace JSON (``{"traceEvents": [...]}``) that loads directly in
  Perfetto / ``chrome://tracing``, spans nested per thread.

Every recorded event also ticks ``events.<type>`` in the bound
:class:`~repro_torch.obs.metrics.MetricsRegistry` and spans feed the
``span_ms.<type>`` latency histogram — which is what makes "the JSONL
per-event counts reconcile exactly with the registry snapshot" a provable
identity rather than a hope. All mutation happens under one lock; emitting
from many threads is safe (each event carries its ``tid``).

The process-wide installed tracer mirrors the FaultInjector pattern:
``install_tracer(t)`` turns instrumentation on, ``install_tracer(None)``
returns every ``emit``/``span`` call site to a no-op — the zero-overhead
production default.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

from .metrics import MetricsRegistry, default_registry
from .schema import EVENT_TYPES


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

    # ------------------------------------------------------------ recording
    def _now_us(self) -> float:
        return (self.clock() - self._t0) * 1e6

    def _record(self, type_: str, name: str, ts_us: float, dur_us: float,
                args: Dict[str, Any]) -> Dict:
        if self.strict and type_ not in EVENT_TYPES:
            raise ValueError(f"unknown event type {type_!r}; "
                             f"one of {EVENT_TYPES}")
        ev = {
            "type": type_,
            "name": name or type_,
            "ts_us": round(ts_us, 3),
            # the fake-clock tests pin this: durations are never negative,
            # even under a clock that stalls or a span timed across a reset
            "dur_us": round(max(dur_us, 0.0), 3),
            "pid": os.getpid(),
            "tid": threading.get_ident(),
            "args": dict(args),
        }
        with self._lock:
            self._events.append(ev)
        self.registry.inc(f"events.{type_}")
        return ev

    @contextlib.contextmanager
    def span(self, type_: str, name: str = "",
             **args: Any) -> Iterator[Dict[str, Any]]:
        """Timed span; the yielded dict is live — fields added inside the
        ``with`` body (a decision source, a measured cost) are recorded."""
        fields: Dict[str, Any] = dict(args)
        t0 = self._now_us()
        try:
            yield fields
        finally:
            t1 = self._now_us()
            self._record(type_, name, t0, t1 - t0, fields)
            self.registry.observe(f"span_ms.{type_}", (t1 - t0) / 1e3)

    def instant(self, type_: str, name: str = "", **args: Any) -> Dict:
        """Zero-duration event (quarantine entries, evictions, sheds)."""
        return self._record(type_, name, self._now_us(), 0.0, args)

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
            lines.append(json.dumps(flat, sort_keys=True, default=str))
        return "\n".join(lines) + ("\n" if lines else "")

    def write_jsonl(self, path: str) -> int:
        evs = self.jsonl()
        with open(path, "w") as f:
            f.write(evs)
        return evs.count("\n")

    def chrome_trace(self) -> Dict:
        """Perfetto/chrome://tracing-compatible trace: every span is a
        complete ("X") event; same-thread spans nest by containment."""
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
                "args": ev["args"],
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


@contextlib.contextmanager
def span(type_: str, name: str = "",
         **args: Any) -> Iterator[Dict[str, Any]]:
    """Span through the installed tracer; without one, yields a throwaway
    fields dict so call sites never branch."""
    if _TRACER is None:
        yield dict(args)
        return
    with _TRACER.span(type_, name, **args) as fields:
        yield fields
