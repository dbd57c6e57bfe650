"""The one place the observability vocabulary lives (DESIGN.md §12).

Two namespaces are defined here so every producer and consumer agrees:

* **Event taxonomy** — ``EVENT_TYPES`` is the closed set of span/event types
  a request can emit on its way through the stack, and ``EVENT_FIELDS``
  names the required ``args`` fields per type. The Tracer validates types
  at emit time; the golden-schema test validates fields on a real trace.
* **Telemetry keys** — every ``telemetry()`` dict in the repo returns flat
  ``snake_case`` keys in sorted order via :func:`ordered`, so golden tests
  and the committed ``BENCH_*.json`` trajectory never depend on dict
  insertion order, and a key like ``fault_fired_cache-read`` can never
  leak a non-identifier character into a JSON consumer's field names.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

# Request-path event taxonomy (DESIGN.md §12). Span types are emitted as
# Chrome-trace complete events ("ph": "X"); instants are zero-duration.
#
#   select      SelectorService decision (cache hit / tree pick / verify sweep)
#   prep        host-side prep + symbolic phase of a plan build
#   compile     a CUDA library's first load in the process (kernels/_build.py):
#               whether nvcc ran or the hashed .so was found, and the seconds
#   launch      one guarded Plan.execute: measured wall-clock vs modeled cost
#   fallback    the guard dropped one backend rung (pallas->interpret->jnp->dense)
#   quarantine  an (op, backend, schedule) combo entered the quarantine
#   shed        a deadline-expired request was answered without selection
#   store_evict PreparedStore dropped an entry (LRU pressure or injected fault)
#
# Serving-engine events (DESIGN.md §13) — the continuous-batching engine's
# request lifecycle, reconciled against the registry exactly like the rest:
#   enqueue     a request hit the engine's bounded queue (queued or rejected)
#   admit       a queued request passed admission into a slot
#   drain       one engine tick drained one slot as ONE stacked launch (span)
#
# Dynamic-sparsity events (DESIGN.md §14) — the mutation/drift path:
#   mutate      a MutableMatrix delta landed (generation bump + store rekey)
#   epoch_swap  slack exhausted or fault injected: old generation kept
#               serving while the new container was rebuilt
#   drift       DriftMonitor scored a mutated matrix against its baseline
#               fingerprint (quarantine/refit decisions carry the score)
#
# Durability events (DESIGN.md §15) — the crash-recovery path:
#   checkpoint  an EngineCheckpoint save attempt (outcome saved/failed;
#               carries the engine tick the snapshot covers)
#   restart     run_with_restarts caught a crash and is bringing up a new
#               incarnation (carries the attempt index and crash reason)
#   recovery    one incarnation finished restore+replay: how many journal
#               records were replayed and how many artifacts were dropped
#               as corrupt on the way
#
# Spans below the request-path ones, at the benchmark's layer boundaries
# (PERF.md §3). Under ``select``:
#   content_key the sha1 of the CSR's bytes (sparse/prepared.py)
#   fingerprint the matrix's features, or the memo's (``memo_hit``)
#   tree        the cost tree's prediction
#   verify      the model's sweep over the candidates
# Under ``prep`` (sparse/tensor.py; each also times ``prep_ms.<type>``):
#   container   the host container a schedule names (BSR index, ELL/SELL
#               fill)
#   bucket      the pad of the container to bucket edges
#   upload      the container's arrays onto the plan's device
# Under ``launch`` (one Plan.execute):
#   stage       the runtime input as a blocked float32 tensor on the device
#   kernel      the host call that enqueues the product
#   check       the guard's finiteness reductions, enqueued
#   wait        the host blocked on the verdict's read (the card finishing)
#   sync        Plan.execute's stream synchronize
EVENT_TYPES: Tuple[str, ...] = (
    "select", "prep", "compile", "launch", "fallback", "quarantine",
    "shed", "store_evict", "enqueue", "admit", "drain",
    "mutate", "epoch_swap", "drift",
    "checkpoint", "restart", "recovery",
    "content_key", "fingerprint", "tree", "verify",
    "container", "bucket", "upload",
    "stage", "kernel", "check", "wait", "sync",
)

# Required ``args`` fields per event type — the golden-schema contract a
# JSONL event log is tested against. Producers may add fields; they may
# never omit these.
EVENT_FIELDS: Dict[str, Tuple[str, ...]] = {
    "select": ("source", "schedule"),
    "prep": ("op",),
    "compile": ("key",),
    "launch": ("op", "backend", "layout", "measured_ms", "modeled_ms"),
    "fallback": ("op", "from_backend", "to_backend", "reason"),
    "quarantine": ("op", "backend", "reason"),
    "shed": ("name",),
    "store_evict": ("reason",),
    "enqueue": ("name", "outcome"),
    "admit": ("name", "slot"),
    "drain": ("slot", "n_requests"),
    "mutate": ("base", "generation"),
    "epoch_swap": ("op", "reason"),
    "drift": ("base", "score"),
    "checkpoint": ("tick", "outcome"),
    "restart": ("attempt", "reason"),
    "recovery": ("replayed", "dropped_corrupt"),
    "content_key": (),
    "fingerprint": ("memo_hit",),
    "tree": (),
    "verify": (),
    "container": ("layout", "block_size", "blocks", "bytes"),
    "bucket": ("bytes_before", "bytes_after"),
    "upload": ("bytes",),
    "stage": (),
    "kernel": (),
    "check": (),
    "wait": (),
    "sync": (),
}

# Telemetry keys are flat snake_case identifiers: lowercase alphanumerics
# and underscores, starting with a letter. Registry metric names may add
# dot namespacing (``selector.0.requests``).
TELEMETRY_KEY_RE = re.compile(r"^[a-z][a-z0-9_]*$")
METRIC_NAME_RE = re.compile(r"^[a-z][a-z0-9_.]*$")


def telemetry_key(raw: str) -> str:
    """Canonicalize one telemetry key: dashes (fault sites like
    ``cache-read``) become underscores; anything else must already be
    snake_case."""
    key = raw.replace("-", "_")
    if not TELEMETRY_KEY_RE.match(key):
        raise ValueError(f"telemetry key {raw!r} is not snake_case")
    return key


def ordered(d: Mapping[str, float]) -> Dict[str, float]:
    """Deterministic telemetry view: canonicalized snake_case keys in
    sorted order — the stable shape golden tests and bench JSON rely on."""
    return {telemetry_key(k): d[k] for k in sorted(d)}
