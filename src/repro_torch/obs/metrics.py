"""Software PMCs: a process-wide, thread-safe metrics registry.

SpChar characterizes sparse computation from hardware Performance Monitoring
Counters; the serving stack's analogue is this registry — counters, gauges,
and bucketed latency histograms that every subsystem writes through instead
of keeping private tallies. The subsystem ``telemetry()`` dicts are *views*
over this registry (each instance owns a :class:`Scope`), so one
``snapshot()`` is the whole process's counter file, and the JSONL event log
reconciles against it exactly (the acceptance test of DESIGN.md §12).

Everything here is guarded by one re-entrant lock: ROADMAP item 2's threaded
serving engine will increment these from many threads, and unlike the
documented-single-threaded module globals in ``sparse/resilience.py`` the
observability substrate must already be safe to hammer concurrently.
"""
from __future__ import annotations

import bisect
import math
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

from .schema import METRIC_NAME_RE

# Log-spaced latency bucket bounds (ms): 1us .. ~100s, x4 per decade-ish.
# Bucket counts are what a long-running server exports cheaply; exact
# percentiles come from the retained-sample window below.
HIST_BOUNDS_MS: Tuple[float, ...] = tuple(
    round(10.0 ** (e / 4.0), 6) for e in range(-12, 21)
)

# Per-histogram retained-sample cap. Percentile snapshots are computed from
# this window (exact, numpy-equal, for up to ``cap`` observations; a sliding
# window of the most recent ``cap`` afterwards).
HIST_SAMPLE_CAP = 4096


class Histogram:
    """Bucketed latency histogram with an exact-percentile sample window."""

    def __init__(self, sample_cap: int = HIST_SAMPLE_CAP) -> None:
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.buckets = [0] * (len(HIST_BOUNDS_MS) + 1)
        self._cap = int(sample_cap)
        self._samples: List[float] = []
        self._next = 0              # ring cursor once the window is full

    def observe(self, value_ms: float) -> None:
        v = float(value_ms)
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        # the first bound >= v (NaN lands in bucket 0, as a scan would)
        self.buckets[bisect.bisect_left(HIST_BOUNDS_MS, v)] += 1
        if len(self._samples) < self._cap:
            self._samples.append(v)
        else:
            self._samples[self._next] = v
            self._next = (self._next + 1) % self._cap

    def recent(self, n: int) -> List[float]:
        """The last ``n`` retained samples, oldest first (fewer when the
        window holds fewer)."""
        if n <= 0:
            return []
        ordered = self._samples[self._next:] + self._samples[:self._next]
        return ordered[-n:]

    def percentile(self, q: float) -> float:
        """Exact percentile over the retained window (numpy's default
        linear interpolation), computed without importing numpy on the hot
        path."""
        if not self._samples:
            return 0.0
        xs = sorted(self._samples)
        rank = (q / 100.0) * (len(xs) - 1)
        lo = int(math.floor(rank))
        hi = min(lo + 1, len(xs) - 1)
        frac = rank - lo
        return xs[lo] * (1.0 - frac) + xs[hi] * frac

    def snapshot(self) -> Dict[str, float]:
        if self.count == 0:
            return {"count": 0.0, "sum_ms": 0.0, "p50_ms": 0.0,
                    "p95_ms": 0.0, "p99_ms": 0.0}
        return {
            "count": float(self.count),
            "sum_ms": self.sum,
            "min_ms": self.min,
            "max_ms": self.max,
            "p50_ms": self.percentile(50.0),
            "p95_ms": self.percentile(95.0),
            "p99_ms": self.percentile(99.0),
        }


class Scope:
    """One instance's counter namespace inside a registry.

    ``registry.scope("prepared_store")`` returns a scope whose keys land in
    the registry as ``prepared_store.<i>.<key>`` (``<i>`` a per-prefix
    instance index, so two stores never alias). Subsystem counter
    attributes are properties over a scope — see :func:`scoped_int` — which
    is what makes their ``telemetry()`` dicts genuine registry views.
    """

    def __init__(self, registry: "MetricsRegistry", prefix: str) -> None:
        self.registry = registry
        self.prefix = prefix

    def key(self, key: str) -> str:
        return f"{self.prefix}.{key}"

    def inc(self, key: str, delta: float = 1.0) -> float:
        return self.registry.inc(self.key(key), delta)

    def get(self, key: str) -> float:
        return self.registry.get(self.key(key))

    def set(self, key: str, value: float) -> None:
        self.registry.set(self.key(key), value)


class CounterDict:
    """Dict-shaped view over a fixed key set in a registry scope.

    Drop-in for the ad-hoc ``self._counts = {...}`` telemetry dicts:
    ``counts["requests"] += 1`` increments the registry counter, reads come
    back as ``int``, and iteration order is the (stable) declared key
    order — so converting a subsystem to registry-backed counters does not
    change a single call site."""

    def __init__(self, scope: Scope, keys) -> None:
        self._scope = scope
        self._keys = tuple(keys)
        for k in self._keys:
            scope.set(k, scope.get(k))    # materialize at 0

    def __getitem__(self, key: str) -> int:
        if key not in self._keys:
            raise KeyError(key)
        return int(round(self._scope.get(key)))

    def __setitem__(self, key: str, value: float) -> None:
        if key not in self._keys:
            raise KeyError(key)
        self._scope.set(key, float(value))

    def __contains__(self, key: str) -> bool:
        return key in self._keys

    def __iter__(self):
        return iter(self._keys)

    def __len__(self) -> int:
        return len(self._keys)

    def keys(self):
        return self._keys

    def items(self):
        return [(k, self[k]) for k in self._keys]

    def values(self):
        return [self[k] for k in self._keys]


def scoped_int(key: str) -> property:
    """Class attribute backed by the instance's ``_metrics`` scope.

    Keeps the existing mutation idiom (``self.hits += 1``) while the value
    itself lives in the registry; reads come back as ``int`` because every
    consumer (telemetry floats aside) formats and compares these as event
    counts."""
    def fget(self) -> int:
        return int(round(self._metrics.get(key)))

    def fset(self, value: float) -> None:
        self._metrics.set(key, float(value))

    return property(fget, fset)


class MetricsRegistry:
    """Thread-safe counters + gauges + histograms with delta views."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, Histogram] = {}
        self._scope_ids: Dict[str, int] = {}

    # ------------------------------------------------------------- counters
    def _check(self, name: str) -> str:
        if not METRIC_NAME_RE.match(name):
            raise ValueError(f"metric name {name!r} is not snake_case")
        return name

    def inc(self, name: str, delta: float = 1.0) -> float:
        with self._lock:
            v = self._counters.get(name)
            if v is None:                 # a new name: check it once
                v = 0.0
                self._check(name)
            v += delta
            self._counters[name] = v
            return v

    def get(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0.0)

    def set(self, name: str, value: float) -> None:
        with self._lock:
            self._counters[self._check(name)] = float(value)

    def sum_prefix(self, prefix: str) -> float:
        with self._lock:
            return sum(v for k, v in self._counters.items()
                       if k.startswith(prefix))

    def clear_prefix(self, prefix: str) -> None:
        """Drop every counter, gauge, and histogram under ``prefix`` — one
        subsystem's slate wiped without touching its neighbours'."""
        with self._lock:
            for store in (self._counters, self._gauges, self._hists):
                for k in [k for k in store if k.startswith(prefix)]:
                    del store[k]

    # --------------------------------------------------------------- gauges
    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[self._check(name)] = float(value)

    def gauge(self, name: str) -> float:
        with self._lock:
            return self._gauges.get(name, 0.0)

    # ----------------------------------------------------------- histograms
    def observe(self, name: str, value_ms: float) -> None:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[self._check(name)] = Histogram()
            h.observe(value_ms)

    def histogram(self, name: str) -> Optional[Histogram]:
        with self._lock:
            return self._hists.get(name)

    # --------------------------------------------------------------- scopes
    def scope(self, prefix: str) -> Scope:
        with self._lock:
            i = self._scope_ids.get(prefix, 0)
            self._scope_ids[prefix] = i + 1
            return Scope(self, f"{prefix}.{i}")

    # ------------------------------------------------------------ snapshots
    def snapshot(self) -> Dict[str, float]:
        """One flat, sorted, snake_case+dots view of everything: counters
        verbatim, gauges under ``gauge.``, histograms flattened to
        ``<name>.count|sum_ms|p50_ms|p95_ms|p99_ms...``."""
        with self._lock:
            out: Dict[str, float] = dict(self._counters)
            for k, v in self._gauges.items():
                out[f"gauge.{k}"] = v
            for k, h in self._hists.items():
                for stat, v in h.snapshot().items():
                    out[f"{k}.{stat}"] = v
            return {k: out[k] for k in sorted(out)}

    def delta(self, prev: Dict[str, float]) -> Dict[str, float]:
        """Changed-keys view since a prior ``snapshot()``: counters and
        histogram counts/sums as differences, percentiles and gauges at
        their current value. Keys whose value did not move are dropped."""
        cur = self.snapshot()
        out: Dict[str, float] = {}
        for k, v in cur.items():
            base = prev.get(k, 0.0)
            monotonic = k.split(".")[-1] in ("count", "sum_ms") or \
                (k in self._counters)
            d = v - base if monotonic else v
            if k not in prev or v != base:
                out[k] = d
        return out

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()
            # scope ids survive a reset so re-created scopes never alias


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return _DEFAULT


def reset_default_registry() -> None:
    """Zero every metric in the process-default registry (test isolation).
    Scopes handed out earlier keep working — their keys simply restart
    from 0, exactly like a counter file truncation."""
    _DEFAULT.reset()


def timed(clock: Callable[[], float], fn: Callable[[], Any]):
    """(result, elapsed_seconds) of one call under the given clock."""
    t0 = clock()
    out = fn()
    return out, clock() - t0
