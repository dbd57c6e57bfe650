"""Engine checkpoints: the learned state, snapshot and restored (port of
``repro.serving.checkpoint``; DESIGN.md §15). The file format is the
reference's, so a checkpoint written by either package loads in the
other.

A serving process accumulates knowledge the SpChar loop paid simulations
and launches for — quarantine entries, the retraining buffer, the
fingerprint->Schedule cache, and the continuous counters behind the
ledger identity. ``EngineCheckpoint`` captures all of it as one
versioned, checksummed JSON payload written with the repo's atomic
temp-file + fsync + ``os.replace`` idiom, keeps the newest ``keep``
snapshots, and restores the newest one that validates —
a checksum-failed or stale-format checkpoint is skipped and counted
(``dropped_corrupt``), falling back to the next older file and finally to
a cold start, never a raise.

Counter restore semantics: the snapshot's ``completed``/``shed``/
``rejected`` counters restore verbatim (that history really happened), but
``admitted`` restores as ``completed + shed`` and ``submitted`` as
``admitted + rejected`` — the delta is exactly the non-terminal suffix the
journal will re-submit into the new incarnation, which re-counts those
requests once. That keeps ``admitted == completed + shed`` an exact
identity *within* the restored registry while the journal ledger proves it
*across* incarnations.

``checkpoint-write`` is a FaultInjector site: an injected (or real) save
failure is absorbed and counted; the previous checkpoint on disk stays
valid — atomicity means a failed save can only lose the snapshot, never
corrupt one.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

from ..obs import default_registry, ordered
from ..obs import trace as obs_trace
from ..sparse.resilience import (InjectedFault, atomic_write_json,
                                 check_fault, entry_checksum,
                                 load_json_guarded, note_recovery)

CHECKPOINT_VERSION = 1

_CKPT_PREFIX = "ckpt-"
_CKPT_SUFFIX = ".json"


def jsonify(obj):
    """Coerce a nested payload to plain-JSON types (numpy scalars from
    characterize()/retraining rows become Python floats/ints; tuples become
    lists) so checksums are stable across a dump/load round trip."""
    if isinstance(obj, dict):
        return {str(k): jsonify(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [jsonify(v) for v in obj]
    if isinstance(obj, bool) or obj is None or isinstance(obj, str):
        return obj
    if isinstance(obj, int):
        return int(obj)
    if isinstance(obj, float):
        return float(obj)
    item = getattr(obj, "item", None)   # numpy scalar
    if callable(item):
        return jsonify(item())
    return str(obj)


class EngineCheckpoint:
    """Snapshot/restore policy over a checkpoint directory."""

    def __init__(self, dir_path: str, *, keep: int = 3) -> None:
        self.dir_path = str(dir_path)
        self.keep = max(int(keep), 1)
        os.makedirs(self.dir_path, exist_ok=True)
        self._metrics = default_registry().scope("checkpoint")
        for k in ("saves", "save_failures", "loads", "dropped_corrupt"):
            self._metrics.set(k, self._metrics.get(k))

    # ------------------------------------------------------------- file mgmt
    def _files(self) -> List[str]:
        try:
            names = sorted(n for n in os.listdir(self.dir_path)
                           if n.startswith(_CKPT_PREFIX)
                           and n.endswith(_CKPT_SUFFIX))
        except OSError:
            names = []
        return [os.path.join(self.dir_path, n) for n in names]

    @staticmethod
    def _seq_of(path: str) -> int:
        base = os.path.basename(path)
        try:
            return int(base[len(_CKPT_PREFIX):-len(_CKPT_SUFFIX)])
        except ValueError:
            return -1

    # ------------------------------------------------------------------ save
    def save(self, engine, journal=None) -> Optional[str]:
        """Atomic snapshot of the engine's full learned state; returns the
        path, or None on a (counted, absorbed) failure."""
        files = self._files()
        seq = (max((self._seq_of(p) for p in files), default=0)) + 1
        payload = {
            "version": CHECKPOINT_VERSION,
            "seq": seq,
            "journal_lsn": (int(journal.last_lsn)
                            if journal is not None else 0),
        }
        payload.update(jsonify(engine.export_state()))
        payload["crc"] = entry_checksum(payload)
        path = os.path.join(self.dir_path,
                            f"{_CKPT_PREFIX}{seq:08d}{_CKPT_SUFFIX}")
        try:
            check_fault("checkpoint-write", path)
            if journal is not None:
                # WAL barrier: everything the snapshot claims terminal must
                # be durable in the journal before the snapshot exists
                journal.flush()
            atomic_write_json(path, payload)
        except (RuntimeError, OSError) as e:
            self._metrics.inc("save_failures")
            if isinstance(e, InjectedFault):
                note_recovery(e.site)
            obs_trace.emit("checkpoint", f"seq{seq}",
                           tick=payload.get("tick", 0), outcome="failed")
            return None
        self._metrics.inc("saves")
        obs_trace.emit("checkpoint", f"seq{seq}",
                       tick=payload.get("tick", 0), outcome="saved")
        for old in self._files()[:-self.keep]:
            try:
                os.unlink(old)
            except OSError:
                pass
        return path

    # ------------------------------------------------------------------ load
    def load_latest(self) -> Tuple[Optional[Dict], int]:
        """(newest valid payload or None, corrupt artifacts dropped).
        Walks newest-to-oldest; a missing/truncated file, wrong format
        version, or checksum mismatch drops that candidate and tries the
        next — cold start (None) only when nothing validates."""
        dropped = 0
        for path in reversed(self._files()):
            payload = load_json_guarded(path)
            if payload is None or payload.get("version") != CHECKPOINT_VERSION:
                dropped += 1
                continue
            if entry_checksum(payload) != payload.get("crc"):
                dropped += 1
                continue
            self._metrics.inc("loads")
            if dropped:
                self._metrics.inc("dropped_corrupt", dropped)
            return {k: v for k, v in payload.items() if k != "crc"}, dropped
        if dropped:
            self._metrics.inc("dropped_corrupt", dropped)
        return None, dropped

    # ------------------------------------------------------------- telemetry
    def telemetry(self) -> Dict[str, float]:
        return ordered({
            "saves": self._metrics.get("saves"),
            "save_failures": self._metrics.get("save_failures"),
            "loads": self._metrics.get("loads"),
            "dropped_corrupt": self._metrics.get("dropped_corrupt"),
            "files": float(len(self._files())),
        })
