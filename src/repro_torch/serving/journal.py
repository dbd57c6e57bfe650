"""Write-ahead request journal: crash-durable serving admission (port
of ``repro.serving.journal``; DESIGN.md §15). The file format is the
reference's, so a journal written by either package scans the same in
the other.

Every ``ServingEngine.submit`` appends one checksummed ``submit`` record
here BEFORE the request enters the bounded queue, and every terminal
outcome (``completed`` / ``shed`` / ``rejected``) appends a matching
tombstone — so after a crash the non-terminal suffix of the journal is
exactly the set of requests the process owed an answer and never gave.
Recovery (``supervisor.run_with_restarts``) re-submits that suffix, keyed
by the records' idempotency ``rid``s, and the cross-incarnation ledger
``submitted == completed + shed + rejected + open`` stays provable from
the journal alone.

Framing reuses the repo's persistence idioms (DESIGN.md §11) shifted to an
append-only shape: one JSON line per record with a ``crc`` field computed
by ``resilience.entry_checksum`` over the canonical form, monotonically
increasing ``lsn``s, **fsync batching** (one fsync per ``fsync_every``
appends, not per record — the journal must not serialize the serving loop
on the disk), **segment rotation** at ``segment_max_records``, and
**compaction** that rewrites the live suffix while folding the terminal
history into one ``ledger`` record so distinct-rid accounting survives the
rewrite. A torn tail write (crash mid-append) or a flipped bit costs
exactly the bad record(s): the scan skips and counts them
(``dropped_corrupt``), never raises — cold-start-from-empty, like every
other persisted artifact in the repo.

The ``journal-append`` fault site fires inside :meth:`append`: an injected
(or real I/O) append failure is absorbed and counted — the engine keeps
serving with durability degraded rather than failing the request, and the
chaos gate's ``fired == recovered`` identity covers the site.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence, Set

from ..obs import default_registry, ordered
from ..sparse.resilience import (InjectedFault, check_fault, entry_checksum,
                                 note_recovery)

JOURNAL_FORMAT_VERSION = 1

# Terminal request outcomes a tombstone may carry. ``rejected`` is terminal
# too: a backpressured request was answered (with "no") and must not be
# replayed after a restart.
OUTCOMES = ("completed", "shed", "rejected")

_SEGMENT_PREFIX = "wal-"
_SEGMENT_SUFFIX = ".jsonl"


@dataclasses.dataclass
class JournalScan:
    """One pass over every segment: the recovery view of the journal."""

    pending: List[Dict]          # non-terminal submit records, lsn order
    terminal: Set[str]           # rids with a terminal tombstone
    ledger: Dict[str, int]       # distinct-rid counts (+ compacted history)
    dropped_corrupt: int         # unparseable / checksum-failed records
    duplicate_outcomes: int      # rids with >1 terminal tombstone
    last_lsn: int


def _segment_name(index: int) -> str:
    return f"{_SEGMENT_PREFIX}{index:08d}{_SEGMENT_SUFFIX}"


class RequestJournal:
    """Append-only, checksummed, segmented request journal."""

    def __init__(self, dir_path: str, *, fsync_every: int = 8,
                 segment_max_records: int = 2048) -> None:
        self.dir_path = str(dir_path)
        self.fsync_every = max(int(fsync_every), 1)
        self.segment_max_records = max(int(segment_max_records), 16)
        os.makedirs(self.dir_path, exist_ok=True)
        self._metrics = default_registry().scope("journal")
        for k in ("appends", "append_failures", "fsyncs", "rotations",
                  "compactions", "dropped_corrupt"):
            self._metrics.set(k, self._metrics.get(k))
        self._f = None
        self._segment_index = 0
        self._segment_records = 0
        self._unsynced = 0
        self._next_lsn = 1
        self._recover_positions()

    # ------------------------------------------------------------- lifecycle
    def _segments(self) -> List[str]:
        try:
            names = sorted(n for n in os.listdir(self.dir_path)
                           if n.startswith(_SEGMENT_PREFIX)
                           and n.endswith(_SEGMENT_SUFFIX))
        except OSError:
            names = []
        return [os.path.join(self.dir_path, n) for n in names]

    def _recover_positions(self) -> None:
        """Continue lsn / segment numbering from whatever is on disk, so a
        reopened journal never reuses an lsn (replay ordering depends on
        monotonicity across incarnations)."""
        segs = self._segments()
        if segs:
            last = os.path.basename(segs[-1])
            self._segment_index = int(
                last[len(_SEGMENT_PREFIX):-len(_SEGMENT_SUFFIX)])
            scan = self.scan()
            self._next_lsn = scan.last_lsn + 1
            self._segment_records = self._count_records(segs[-1])
        if self._segment_records >= self.segment_max_records:
            self._segment_index += 1
            self._segment_records = 0

    @staticmethod
    def _count_records(path: str) -> int:
        try:
            with open(path) as f:
                return sum(1 for line in f if line.strip())
        except OSError:
            return 0

    @property
    def last_lsn(self) -> int:
        return self._next_lsn - 1

    def _open_segment(self) -> None:
        path = os.path.join(self.dir_path, _segment_name(self._segment_index))
        # a torn tail (crash mid-append) leaves a partial line with no
        # newline; terminate it before appending, or the next record would
        # concatenate onto the garbage and be lost with it
        try:
            with open(path, "rb") as f:
                f.seek(0, os.SEEK_END)
                if f.tell():
                    f.seek(-1, os.SEEK_END)
                    torn = f.read(1) != b"\n"
                else:
                    torn = False
        except OSError:
            torn = False
        # line-buffered: every record reaches the OS as one append-mode
        # write, so a crashed incarnation's abandoned handle can never
        # interleave stale buffered lines under a successor's appends;
        # ``fsync_every`` batches DURABILITY (OS cache -> disk), not writes
        self._f = open(path, "a", buffering=1)
        if torn:
            self._f.write("\n")

    def _rotate(self) -> None:
        self._sync()
        if self._f is not None:
            self._f.close()
            self._f = None
        self._segment_index += 1
        self._segment_records = 0
        self._metrics.inc("rotations")

    def _sync(self) -> None:
        if self._f is not None and self._unsynced:
            self._f.flush()
            os.fsync(self._f.fileno())
            self._unsynced = 0
            self._metrics.inc("fsyncs")

    def flush(self) -> None:
        """Force-fsync the open segment (checkpoint barrier / shutdown)."""
        self._sync()

    def close(self) -> None:
        self._sync()
        if self._f is not None:
            self._f.close()
            self._f = None

    # --------------------------------------------------------------- appends
    def _append(self, rec: Dict, detail: str = "") -> bool:
        """Append one record; False (counted, never raised) on failure —
        an injected ``journal-append`` fault or a real I/O error degrades
        durability, not availability."""
        try:
            check_fault("journal-append", detail)
            if self._f is None:
                self._open_segment()
            rec = dict(rec, lsn=self._next_lsn)
            rec["crc"] = entry_checksum(rec)
            self._f.write(json.dumps(rec, sort_keys=True,
                                     separators=(",", ":")) + "\n")
            self._next_lsn += 1
            self._segment_records += 1
            self._unsynced += 1
            self._metrics.inc("appends")
            if self._unsynced >= self.fsync_every:
                self._sync()
            if self._segment_records >= self.segment_max_records:
                self._rotate()
            return True
        except (RuntimeError, OSError) as e:
            self._metrics.inc("append_failures")
            if isinstance(e, InjectedFault):
                note_recovery(e.site)
            return False

    def append_submit(self, rid: str, name: str, tenant: int = -1,
                      deadline_ms: Optional[float] = None) -> bool:
        """WAL the logical request before admission. The record carries
        what recovery needs to re-submit it (tenant index + deadline), not
        the operand bytes — the supervisor's ``resolve`` maps the record
        back to its matrix/RHS from the deterministic population."""
        return self._append({"kind": "submit", "rid": str(rid),
                             "name": str(name), "tenant": int(tenant),
                             "deadline_ms": deadline_ms}, detail=rid)

    def append_outcome(self, rid: str, outcome: str) -> bool:
        if outcome not in OUTCOMES:
            raise ValueError(f"unknown terminal outcome {outcome!r}")
        return self._append({"kind": "outcome", "rid": str(rid),
                             "outcome": outcome}, detail=rid)

    # ------------------------------------------------------------------ scan
    def scan(self) -> JournalScan:
        """Replay every segment into the recovery view. Corrupt lines —
        torn tail writes, flipped bits, wrong checksums — are skipped and
        counted, never raised."""
        self._sync()
        submits: "Dict[str, Dict]" = {}       # rid -> first submit record
        outcome_counts: "Dict[str, int]" = {}
        ledger = {"submitted": 0, "completed": 0, "shed": 0, "rejected": 0}
        terminal: Set[str] = set()
        dropped = 0
        duplicates = 0
        last_lsn = 0
        for path in self._segments():
            try:
                with open(path) as f:
                    lines = f.readlines()
            except OSError:
                dropped += 1
                continue
            for line in lines:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    dropped += 1
                    continue
                if not isinstance(rec, dict) or "crc" not in rec or \
                        entry_checksum(rec) != rec["crc"]:
                    dropped += 1
                    continue
                last_lsn = max(last_lsn, int(rec.get("lsn", 0)))
                kind = rec.get("kind")
                if kind == "submit":
                    rid = str(rec.get("rid", ""))
                    if rid and rid not in submits:
                        submits[rid] = rec
                elif kind == "outcome":
                    rid = str(rec.get("rid", ""))
                    out = rec.get("outcome")
                    if rid and out in OUTCOMES:
                        n = outcome_counts.get(rid, 0)
                        outcome_counts[rid] = n + 1
                        if n:
                            duplicates += 1
                        else:
                            terminal.add(rid)
                            ledger[out] += 1
                elif kind == "ledger":
                    # compacted history: fold the folded counts back in
                    for k in ledger:
                        ledger[k] += int(rec.get(k, 0))
                else:
                    dropped += 1
        ledger["submitted"] += len(submits)
        pending = sorted((r for rid, r in submits.items()
                          if rid not in terminal),
                         key=lambda r: int(r.get("lsn", 0)))
        if dropped:
            self._metrics.inc("dropped_corrupt", dropped)
        return JournalScan(pending=pending, terminal=terminal, ledger=ledger,
                           dropped_corrupt=dropped,
                           duplicate_outcomes=duplicates, last_lsn=last_lsn)

    def open_requests(self) -> List[Dict]:
        """The non-terminal suffix — exactly what recovery replays."""
        return self.scan().pending

    # ------------------------------------------------------------ compaction
    def compact(self) -> int:
        """Rewrite the journal down to its live suffix: one fresh segment
        holding a ``ledger`` record (the terminal history's distinct-rid
        counts, so cross-incarnation accounting survives) followed by the
        pending submit records verbatim. Returns records dropped. The
        rewrite goes through a temp segment + ``os.replace`` after the old
        segments are removed, so a crash mid-compaction costs at most the
        compaction, never the live suffix."""
        scan = self.scan()
        self.close()
        old = self._segments()
        closed = {k: scan.ledger[k] for k in
                  ("completed", "shed", "rejected")}
        closed["submitted"] = (scan.ledger["submitted"] - len(scan.pending))
        records: List[Dict] = [dict({"kind": "ledger"}, **closed)]
        records.extend(scan.pending)
        new_index = self._segment_index + 1
        path = os.path.join(self.dir_path, _segment_name(new_index))
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            for i, rec in enumerate(records):
                rec = dict(rec)
                rec.pop("crc", None)
                rec["lsn"] = scan.last_lsn + 1 + i
                rec["crc"] = entry_checksum(rec)
                f.write(json.dumps(rec, sort_keys=True,
                                   separators=(",", ":")) + "\n")
            f.flush()
            os.fsync(f.fileno())
        # old segments go first: if we crash here, the tmp file is invisible
        # to the scan (wrong suffix) and the old data was already folded —
        # worst case the compaction is lost, never the records
        for p in old:
            try:
                os.unlink(p)
            except OSError:
                pass
        os.replace(tmp, path)
        self._segment_index = new_index
        self._segment_records = len(records)
        self._next_lsn = scan.last_lsn + 1 + len(records)
        self._metrics.inc("compactions")
        return (scan.ledger["completed"] + scan.ledger["shed"]
                + scan.ledger["rejected"])

    # ------------------------------------------------------------- telemetry
    def telemetry(self) -> Dict[str, float]:
        return ordered({
            "appends": self._metrics.get("appends"),
            "append_failures": self._metrics.get("append_failures"),
            "fsyncs": self._metrics.get("fsyncs"),
            "rotations": self._metrics.get("rotations"),
            "compactions": self._metrics.get("compactions"),
            "dropped_corrupt": self._metrics.get("dropped_corrupt"),
            "segments": float(len(self._segments())),
            "last_lsn": float(self.last_lsn),
        })


def reconcile(scan: JournalScan) -> Dict[str, float]:
    """The cross-incarnation ledger, as one dict a gate can assert on:
    ``submitted == completed + shed + rejected + open`` by construction of
    the scan; ``open == 0`` once every incarnation ran dry, which is the
    "no journaled-admitted request lost" invariant."""
    led = scan.ledger
    open_n = led["submitted"] - (led["completed"] + led["shed"]
                                 + led["rejected"])
    return ordered({
        "submitted": float(led["submitted"]),
        "completed": float(led["completed"]),
        "shed": float(led["shed"]),
        "rejected": float(led["rejected"]),
        "open": float(open_n),
        "duplicate_outcomes": float(scan.duplicate_outcomes),
        "dropped_corrupt": float(scan.dropped_corrupt),
    })
