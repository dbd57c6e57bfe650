"""Fingerprint -> Schedule cache with LRU eviction, in memory (port of
``repro.selector.cache`` without its persistence).

Every entry stores the canonical (rounded) feature vector beside the
schedule: a lookup whose hash matches but whose canonical vector differs
is a hash collision and is served as a miss (and counted), so aliasing can
never hand an operand another operand's schedule. An entry selected under
another ``context`` (the tuner configuration) is a miss too. Telemetry
counts hits / misses / collisions / context misses / evictions under the
``schedule_cache`` metrics scope, as in the JAX package.

Left for later slices: the JSON file (``path``, ``flush``, checksummed
load) and the fault-injection hooks come with guarded execution;
``export_state`` / ``restore_state`` and ``quarantine`` with the selector,
which also brings back the JAX ``put``'s ``source`` and ``modeled_time_s``
entry fields that only those read.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, Optional

from ..core.autotune import Schedule
from ..obs import default_registry, ordered, scoped_int
from .fingerprint import Fingerprint


def schedule_to_dict(sched: Schedule) -> Dict:
    return dataclasses.asdict(sched)


def schedule_from_dict(d: Dict) -> Schedule:
    return Schedule(backend=str(d["backend"]), block_size=int(d["block_size"]),
                    ell_quantile=float(d["ell_quantile"]),
                    layout=str(d.get("layout", "ell")),
                    slice_height=int(d.get("slice_height", 0)),
                    n_rhs=int(d.get("n_rhs", 1)))


class ScheduleCache:
    """LRU cache of selected schedules keyed by fingerprint.

    ``context`` identifies the configuration the schedules were selected
    for (``moe_tile_schedule`` sets "moe_gmm" on an empty one); an entry
    put under another context serves a miss.
    """

    # counters are views into this cache's MetricsRegistry scope
    hits = scoped_int("hits")
    misses = scoped_int("misses")
    collisions = scoped_int("collisions")
    context_misses = scoped_int("context_misses")
    evictions = scoped_int("evictions")

    def __init__(self, path: Optional[str] = None, capacity: int = 256,
                 context: str = "") -> None:
        if path is not None:
            raise NotImplementedError(
                "ScheduleCache(path=...) persists to disk; the file, its "
                "checksums and fault hooks come with the guarded-execution "
                "slice of the port")
        self._metrics = default_registry().scope("schedule_cache")
        self.capacity = max(int(capacity), 1)
        self.context = context
        self._entries: "OrderedDict[str, Dict]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, fp: Fingerprint) -> Optional[Schedule]:
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

    def put(self, fp: Fingerprint, sched: Schedule) -> None:
        self._entries[fp.key] = {
            "context": self.context,
            "canonical": [list(pair) for pair in fp.canonical],
            "shape": list(fp.shape),
            "nnz": fp.nnz,
            "schedule": schedule_to_dict(sched),
        }
        self._entries.move_to_end(fp.key)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.evictions += 1

    def telemetry(self) -> Dict[str, float]:
        lookups = self.hits + self.misses
        return ordered({
            "entries": float(len(self._entries)),
            "hits": float(self.hits),
            "misses": float(self.misses),
            "collisions": float(self.collisions),
            "context_misses": float(self.context_misses),
            "evictions": float(self.evictions),
            "hit_rate": self.hits / lookups if lookups else 0.0,
        })
