"""Persistent fingerprint -> Schedule cache with LRU eviction (port of
``repro.selector.cache``; the file format, ``CACHE_FORMAT_VERSION`` and the
per-entry checksums are the JAX package's, so either package reads the
other's file).

One JSON file on disk, checksummed + atomically written (unique temp file,
fsync, ``os.replace``), bounded entry count. Every entry stores the
canonical (rounded) feature vector alongside the schedule: a lookup whose
hash matches but whose canonical vector differs is a hash collision and is
served as a miss (and counted), so aliasing can never hand a matrix another
matrix's schedule. Corrupted persistence (truncated file, flipped bits) is
recovered, never raised: a bad file loads as empty, a bad entry is skipped
and counted — the cold-start-from-empty guarantee of DESIGN.md §11.
Telemetry counts hits / misses / collisions / evictions / corruption /
fault recoveries for the serving loop's hit-rate reporting.
"""
from __future__ import annotations

import dataclasses
import os
from collections import OrderedDict
from typing import Dict, Optional

from ..core.autotune import Schedule
from ..obs import default_registry, ordered, scoped_int
from ..sparse.resilience import (InjectedFault, atomic_write_json,
                                 checksum_entries, fault_fired,
                                 load_json_guarded, note_recovery,
                                 verify_entries)
from .fingerprint import Fingerprint

# v2: per-entry crc32 checksums + guarded (skip-and-count) load
CACHE_FORMAT_VERSION = 2


def schedule_to_dict(sched: Schedule) -> Dict:
    return dataclasses.asdict(sched)


def schedule_from_dict(d: Dict) -> Schedule:
    return Schedule(backend=str(d["backend"]), block_size=int(d["block_size"]),
                    ell_quantile=float(d["ell_quantile"]),
                    layout=str(d.get("layout", "ell")),
                    slice_height=int(d.get("slice_height", 0)),
                    n_rhs=int(d.get("n_rhs", 1)))


class ScheduleCache:
    """LRU cache of selected schedules keyed by matrix fingerprint.

    ``context`` identifies the tuner configuration the schedules were
    selected for (kernel:platform:rhs — SelectorService fills it in;
    ``moe_tile_schedule`` sets "moe_gmm"); a
    persisted cache file reopened under a different configuration serves
    misses instead of handing back wrong-kernel/wrong-platform schedules.
    """

    # counters are views into this cache's MetricsRegistry scope
    # (DESIGN.md §12) — telemetry() and registry snapshots agree by
    # construction
    hits = scoped_int("hits")
    misses = scoped_int("misses")
    collisions = scoped_int("collisions")
    context_misses = scoped_int("context_misses")
    evictions = scoped_int("evictions")
    corrupt_entries = scoped_int("corrupt_entries")
    corrupt_files = scoped_int("corrupt_files")
    faulted_reads = scoped_int("faulted_reads")
    flush_failures = scoped_int("flush_failures")
    drift_evictions = scoped_int("drift_evictions")

    def __init__(self, path: Optional[str] = None, capacity: int = 256,
                 context: str = "") -> None:
        self._metrics = default_registry().scope("schedule_cache")
        self.path = path
        self.capacity = max(int(capacity), 1)
        self.context = context
        self._entries: "OrderedDict[str, Dict]" = OrderedDict()
        if path is not None and os.path.exists(path):
            self._load(path)

    def __len__(self) -> int:
        return len(self._entries)

    # ----------------------------------------------------------------- I/O
    def _load(self, path: str) -> None:
        """Guarded load: a truncated/non-JSON file starts empty, an entry
        with a missing or wrong checksum is skipped — both counted, never
        raised (cold-start-from-empty guarantee)."""
        payload = load_json_guarded(path)
        if payload is None:
            self.corrupt_files += 1
            return
        if payload.get("version") != CACHE_FORMAT_VERSION:
            return  # stale format: start empty rather than misread entries
        raw = payload.get("entries", [])
        entries, corrupt = verify_entries(raw if isinstance(raw, list) else [])
        self.corrupt_entries += corrupt
        for entry in entries:
            if isinstance(entry.get("key"), str):
                self._entries[entry["key"]] = entry
            else:
                self.corrupt_entries += 1
        while len(self._entries) > self.capacity:  # honor a smaller reopen
            self._entries.popitem(last=False)
            self.evictions += 1

    def flush(self) -> bool:
        """Persist entries (LRU order preserved): checksummed, unique temp
        file + fsync + ``os.replace``. A failed flush (disk error, injected
        cache-write fault) is counted and leaves both the in-memory state
        and the previous on-disk file intact — returns False instead of
        raising."""
        if self.path is None:
            return True
        payload = {"version": CACHE_FORMAT_VERSION,
                   "entries": checksum_entries(list(self._entries.values()))}
        try:
            atomic_write_json(self.path, payload)
        except (RuntimeError, OSError) as e:
            self.flush_failures += 1
            if isinstance(e, InjectedFault):
                note_recovery(e.site)
            return False
        return True

    # -------------------------------------------------------------- lookup
    def get(self, fp: Fingerprint) -> Optional[Schedule]:
        if fault_fired("cache-read", fp.key):
            # injected fault: serve a miss — the selector re-decides, which
            # is exactly the recovery a lost cache line needs
            self.faulted_reads += 1
            self.misses += 1
            note_recovery("cache-read")
            return None
        entry = self._entries.get(fp.key)
        if entry is None:
            self.misses += 1
            return None
        if entry.get("context", "") != self.context:
            self.context_misses += 1
            self.misses += 1
            return None
        if entry["canonical"] != [list(pair) for pair in fp.canonical] or \
                entry["shape"] != list(fp.shape) or entry["nnz"] != fp.nnz:
            self.collisions += 1
            self.misses += 1
            return None
        self._entries.move_to_end(fp.key)
        self.hits += 1
        return schedule_from_dict(entry["schedule"])

    def put(self, fp: Fingerprint, sched: Schedule, source: str,
            modeled_time_s: Optional[float] = None) -> None:
        self._entries[fp.key] = {
            "key": fp.key,
            "context": self.context,
            "canonical": [list(pair) for pair in fp.canonical],
            "shape": list(fp.shape),
            "nnz": fp.nnz,
            "schedule": schedule_to_dict(sched),
            "source": source,
            "modeled_time_s": modeled_time_s,
        }
        self._entries.move_to_end(fp.key)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.evictions += 1

    # ------------------------------------------------------ durability (§15)
    def export_state(self) -> Dict:
        """Checkpoint view: entries in LRU order plus the tuner context
        they were selected under (per-entry ``context`` is re-checked on
        every ``get``, so a context-mismatched restore serves misses, not
        wrong schedules)."""
        return {"context": self.context,
                "entries": [dict(e) for e in self._entries.values()]}

    def restore_state(self, state: Dict) -> int:
        """Rebuild from :meth:`export_state` output (malformed entries are
        skipped and counted, never raised); returns entries restored."""
        if not isinstance(state, dict):
            return 0
        raw = state.get("entries", [])
        n = 0
        for entry in (raw if isinstance(raw, list) else []):
            if isinstance(entry, dict) and isinstance(entry.get("key"), str) \
                    and isinstance(entry.get("schedule"), dict):
                self._entries[entry["key"]] = dict(entry)
                self._entries.move_to_end(entry["key"])
                n += 1
            else:
                self.corrupt_entries += 1
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.evictions += 1
        return n

    def quarantine(self, key: str) -> bool:
        """Drop a cached schedule whose matrix has drifted away from the
        fingerprint it was selected under (DriftMonitor, DESIGN.md §14).
        Unlike an LRU eviction this is a correctness eviction: the entry's
        canonical vector no longer describes the matrix it's keyed for."""
        if self._entries.pop(key, None) is None:
            return False
        self.drift_evictions += 1
        return True

    def telemetry(self) -> Dict[str, float]:
        lookups = self.hits + self.misses
        return ordered({
            "entries": float(len(self._entries)),
            "hits": float(self.hits),
            "misses": float(self.misses),
            "collisions": float(self.collisions),
            "context_misses": float(self.context_misses),
            "evictions": float(self.evictions),
            "corrupt_entries": float(self.corrupt_entries),
            "corrupt_files": float(self.corrupt_files),
            "faulted_reads": float(self.faulted_reads),
            "flush_failures": float(self.flush_failures),
            "drift_evictions": float(self.drift_evictions),
            "hit_rate": self.hits / lookups if lookups else 0.0,
        })
