"""Slot table: schedule-bucketed, residency-aware batch assembly (port of
``repro.serving.slots``).

A slot here is keyed ``(schedule, resident)``: the **Schedule** picks the
kernel (one stacked launch per schedule — DESIGN.md §8) and the
**PreparedStore residency** of the operands says whether a drain pays host
prep (§9):

* every request in a slot shares one Schedule, hence one stacked launch —
  draining a slot costs ONE kernel launch no matter how many requests it
  holds (the launch-counter test pins this);
* the ``resident`` bit splits warm tenants from cold ones, so the drain
  policy can prefer slots that will not pay prep, and a cold burst cannot
  stall a hot tenant's warm batch behind container builds.

Drain policy (``pick``): full slots first (they cannot grow further), then
maximum occupancy (amortize the launch over the most requests), resident
before cold on ties, oldest slot last tiebreak (no starvation: an aging
singleton eventually has the highest age among equals and drains).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ..core.autotune import Schedule


def slot_label(schedule: Schedule, resident: bool) -> str:
    """Human-readable slot key for trace events: backend/layout/block-size
    plus the residency class."""
    return (f"{schedule.backend}:{schedule.layout}:bs{schedule.block_size}:"
            + ("resident" if resident else "cold"))


@dataclasses.dataclass
class Slot:
    schedule: Schedule
    resident: bool
    members: List        # [(selector Request, Decision), ...] in admit order
    opened_seq: int      # admission sequence number when the slot opened
    affinity: Optional[str] = None   # content key shared by all members

    @property
    def label(self) -> str:
        return slot_label(self.schedule, self.resident)


class SlotTable:
    """Open slots keyed by (Schedule, resident), each holding at most
    ``slot_max`` requests — a full slot stops growing and a sibling slot
    opens under the same key (so ``slot_max=1`` is the per-request
    no-batching baseline: every drain is a single-request launch)."""

    def __init__(self, slot_max: int = 16) -> None:
        self.slot_max = max(int(slot_max), 1)
        self._slots: "Dict[Tuple[Schedule, bool], List[Slot]]" = {}
        self._seq = 0

    def __len__(self) -> int:
        return sum(len(v) for v in self._slots.values())

    def backlog(self) -> int:
        return sum(len(s.members) for v in self._slots.values() for s in v)

    def assign(self, member, schedule: Schedule, resident: bool,
               affinity: Optional[str] = None) -> Slot:
        """Append one admitted (request, decision) pair to its slot,
        opening a slot when the key is new or no sibling has room.

        ``affinity`` (the request's operand content key) keeps slots
        content-pure: a member only joins a sibling whose affinity matches,
        so a hot tenant's concurrent requests assemble into one slot that
        the bucket planner can drain as a single multi-RHS launch against
        one prepared container, instead of a mixed-operand stack."""
        key = (schedule, bool(resident))
        chain = self._slots.setdefault(key, [])
        slot = None
        for s in chain:
            if len(s.members) < self.slot_max and s.affinity == affinity:
                slot = s
                break
        if slot is None:
            slot = Slot(schedule, bool(resident), [], self._seq, affinity)
            chain.append(slot)
        self._seq += 1
        slot.members.append(member)
        return slot

    def pick(self) -> Optional[Slot]:
        """The slot the next tick should drain (see module docstring), or
        None when the table is empty."""
        if not self._slots:
            return None
        return max((s for v in self._slots.values() for s in v),
                   key=lambda s: (len(s.members) >= self.slot_max,
                                  len(s.members), s.resident,
                                  -s.opened_seq))

    def take(self, slot: Slot) -> Slot:
        """Remove a slot from the table for draining."""
        chain = self._slots[(slot.schedule, slot.resident)]
        chain.remove(slot)
        if not chain:
            del self._slots[(slot.schedule, slot.resident)]
        return slot
