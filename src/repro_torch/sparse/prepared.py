"""Zero-rebuild serving: the device-resident prepared-operand cache (port of
``repro.sparse.prepared``).

``PreparedStore`` is a byte-budgeted LRU keyed by ``(content key, schedule,
...)`` whose values are finished device-resident products — prepared
``SparseTensor``s and stacked bucket arrays — so a warm ``plan()`` is a hash
plus a dict lookup and skips host prep entirely.

* ``content_key(csr)`` hashes the exact bytes of the matrix (structure AND
  values): a cached container embeds the values, so only byte-identical
  matrices may share an entry.
* ``bucket_edge(n)`` rounds container dimensions up to power-of-two-ish
  edges (1x and 1.5x powers of two). PyTorch does not retrace, so here the
  padding buys stable shapes for the store's stacked bucket arrays and keeps
  the containers leaf-for-leaf equal to the JAX package's.

An injected ``store-evict`` fault loses the entry on a hit and serves a
miss (counted in ``fault_evictions``); the caller rebuilds as after a real
eviction. Left out until their slices land: the mutation rekeying
(``pop_matching`` / versioned content keys). The JAX package's donation
check ``_leaves_alive`` has no counterpart: a torch tensor cannot be
deleted out from under a reference the store holds.
"""
from __future__ import annotations

import hashlib
import os
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.csr import CSR
from ..obs import default_registry, ordered, scoped_int
from ..obs import trace as obs_trace
from .resilience import (InjectedFault, atomic_write_json, checksum_entries,
                         fault_fired, load_json_guarded, note_recovery,
                         verify_entries)

STORE_INDEX_VERSION = 1

# Default device-byte budget of a store: enough for serving working sets,
# small enough that an unbounded stream of distinct matrices cannot pin
# device memory (the LRU evicts cold entries instead).
DEFAULT_BYTE_BUDGET = 256 << 20


def bucket_edge(n: int) -> int:
    """Smallest power-of-two-ish edge >= n: 1, 2, 3, 4, 6, 8, 12, 16, ...

    Two mantissa points per octave (1x and 1.5x each power of two) bounds
    padding waste at 50% worst-case / ~20% expected.
    """
    n = max(int(n), 1)
    edge = 1
    while edge < n:
        if edge * 3 // 2 >= n and edge * 3 % 2 == 0:
            return edge * 3 // 2
        edge *= 2
    return edge


def content_key(csr: CSR) -> str:
    """Exact-bytes identity of a matrix for the prepared cache: one sha1
    pass over the raw CSR arrays."""
    h = hashlib.sha1()
    h.update(f"csr;{csr.shape[0]}x{csr.shape[1]};{csr.nnz};".encode())
    for arr in (csr.row_ptrs, csr.col_idxs, csr.nnz_vals):
        a = np.ascontiguousarray(arr)
        h.update(str(a.dtype).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def array_key(arr: np.ndarray) -> str:
    """Exact-bytes identity of one host array."""
    a = np.ascontiguousarray(arr)
    h = hashlib.sha1()
    h.update(f"arr;{a.shape};{a.dtype};".encode())
    h.update(a.tobytes())
    return h.hexdigest()


def entry_nbytes(value: Any) -> int:
    """Bytes held by a cached value: the tensors (and numpy arrays) inside
    it, walking dicts, sequences and ``SparseTensor.arrays``."""
    if isinstance(value, torch.Tensor):
        return value.nelement() * value.element_size()
    if isinstance(value, np.ndarray):
        return int(value.nbytes)
    if isinstance(value, dict):
        return sum(entry_nbytes(v) for v in value.values())
    if isinstance(value, (list, tuple)):
        return sum(entry_nbytes(v) for v in value)
    arrays = getattr(value, "arrays", None)
    return entry_nbytes(arrays) if isinstance(arrays, dict) else 0


class PreparedStore:
    """Byte-budgeted LRU of finished prepared operands.

    Keys are tuples ``(kind, content_key(s)..., Schedule, prep kwargs)``;
    values are whatever the planner needs to skip host prep — the store
    never interprets them beyond byte accounting. Entries larger than the
    whole budget are rejected (counted, not raised): a single huge matrix
    must not flush the working set that is getting hits.
    """

    bytes_in_use = scoped_int("bytes_in_use")
    hits = scoped_int("hits")
    misses = scoped_int("misses")
    puts = scoped_int("puts")
    evictions = scoped_int("evictions")
    rejected = scoped_int("rejected")
    fault_evictions = scoped_int("fault_evictions")
    save_failures = scoped_int("save_failures")
    corrupt_loads = scoped_int("corrupt_loads")

    def __init__(self, byte_budget: int = DEFAULT_BYTE_BUDGET) -> None:
        self._metrics = default_registry().scope("prepared_store")
        self.byte_budget = int(byte_budget)
        self._entries: "OrderedDict[Tuple, Tuple[Any, int]]" = OrderedDict()
        self.prior: Dict = {}

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: Tuple) -> bool:
        return key in self._entries

    def get(self, key: Tuple) -> Optional[Any]:
        entry = self._entries.get(key)
        if entry is None:
            self.misses += 1
            return None
        if fault_fired("store-evict", str(key)):
            # injected fault: lose the entry, recover by serving a miss —
            # the caller rebuilds exactly as after a real eviction
            self._entries.pop(key)
            self.bytes_in_use -= entry[1]
            self.fault_evictions += 1
            self.misses += 1
            note_recovery("store-evict")
            obs_trace.emit("store_evict", "fault", reason="fault",
                           nbytes=entry[1])
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        return entry[0]

    def put(self, key: Tuple, value: Any,
            nbytes: Optional[int] = None) -> bool:
        nb = entry_nbytes(value) if nbytes is None else int(nbytes)
        if nb > self.byte_budget:
            self.rejected += 1
            return False
        old = self._entries.pop(key, None)
        if old is not None:
            self.bytes_in_use -= old[1]
        self._entries[key] = (value, nb)
        self.bytes_in_use += nb
        self.puts += 1
        while self.bytes_in_use > self.byte_budget and len(self._entries) > 1:
            _, (_, freed) = self._entries.popitem(last=False)
            self.bytes_in_use -= freed
            self.evictions += 1
            obs_trace.emit("store_evict", "lru", reason="lru", nbytes=freed)
        return True

    def get_or_build(self, key: Optional[Tuple],
                     builder: Callable[[], Any]) -> Any:
        """Cached value for ``key``, building (and inserting) on a miss.
        ``key=None`` bypasses the store entirely (uncacheable operand)."""
        if key is None:
            return builder()
        value = self.get(key)
        if value is None:
            value = builder()
            self.put(key, value)
        return value

    def resident(self, content_key: str) -> bool:
        """True when any cached entry's key references this exact-bytes
        content key — i.e. some prepared product of that matrix (a
        container, a staged symbolic product, a stacked bucket array) is
        device-resident right now. The serving engine's slot-based
        admission (DESIGN.md §13) keys slots on this: a tenant whose
        operands are resident drains without paying host prep, so resident
        slots are preferred drain targets. O(entries × key width) per
        probe, both bounded by the byte budget."""

        def _walk(t: Tuple) -> bool:
            for el in t:
                if isinstance(el, tuple):
                    if _walk(el):
                        return True
                elif el == content_key:
                    return True
            return False

        return any(_walk(k) for k in self._entries)

    def clear(self) -> None:
        self._entries.clear()
        self.bytes_in_use = 0

    # -------------------------------------------------- cross-run persistence
    # Only the index (key reprs + byte sizes, LRU order) and the telemetry
    # persist, never the device buffers: a reloaded copy would have to be
    # re-uploaded anyway, which is the cold rebuild a miss already does.

    def save(self, path: str) -> bool:
        """Persist the index + telemetry as checksummed JSON, atomically.
        Returns False (and counts) instead of raising on failure."""
        entries = [{"key": repr(k), "nbytes": nb}
                   for k, (_, nb) in self._entries.items()]
        payload = {
            "version": STORE_INDEX_VERSION,
            "telemetry": self.telemetry(),
            "entries": checksum_entries(entries),
        }
        try:
            atomic_write_json(path, payload)
        except (RuntimeError, OSError) as e:
            self.save_failures += 1
            if isinstance(e, InjectedFault):
                note_recovery(e.site)
            return False
        return True

    def load(self, path: str) -> Dict:
        """Load a prior run's index + telemetry for reporting context
        (``prior_*`` keys of ``telemetry()``). A missing, stale-format,
        truncated or bit-flipped file loads as empty-or-partial context,
        never a crash."""
        self.prior = {}
        payload = load_json_guarded(path)
        if payload is None:
            if os.path.exists(path):
                self.corrupt_loads += 1
            return self.prior
        if payload.get("version") != STORE_INDEX_VERSION:
            return self.prior
        raw = payload.get("entries", [])
        entries, corrupt = verify_entries(raw if isinstance(raw, list)
                                          else [])
        self.corrupt_loads += corrupt
        tel = payload.get("telemetry", {})
        self.prior = {"telemetry": tel if isinstance(tel, dict) else {},
                      "entries": entries}
        return self.prior

    def telemetry(self) -> Dict[str, float]:
        lookups = self.hits + self.misses
        out = {
            "entries": float(len(self._entries)),
            "bytes_in_use": float(self.bytes_in_use),
            "byte_budget": float(self.byte_budget),
            "hits": float(self.hits),
            "misses": float(self.misses),
            "puts": float(self.puts),
            "evictions": float(self.evictions),
            "rejected": float(self.rejected),
            "fault_evictions": float(self.fault_evictions),
            "save_failures": float(self.save_failures),
            "corrupt_loads": float(self.corrupt_loads),
            "hit_rate": self.hits / lookups if lookups else 0.0,
            "eviction_pressure": self.evictions / max(self.puts, 1),
        }
        if self.prior:
            ptel = self.prior.get("telemetry", {})
            out["prior_entries"] = float(len(self.prior.get("entries", [])))
            out["prior_hit_rate"] = float(ptel.get("hit_rate", 0.0))
            out["prior_bytes_in_use"] = float(ptel.get("bytes_in_use", 0.0))
        return ordered(out)
