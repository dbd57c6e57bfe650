"""Bounded request queue + watermark backpressure (port of
``repro.serving.admission``; DESIGN.md §13).

The first stage of the continuous-batching engine: every offered request
lands here, and here is where overload is turned into an explicit, counted
outcome instead of unbounded memory growth:

* **hard watermark** (``queue_max``) — a submit that would push the queue
  past it is REJECTED immediately (the caller gets ``False``, the
  ``enqueue`` event carries ``outcome="rejected"``). Queue depth is
  provably bounded: the overload test pins ``depth <= queue_max`` under
  any submit pattern.
* **soft watermark** (``soft_watermark``, default 3/4 of the hard one) —
  crossing it is the DEGRADE signal: the engine tells its SelectorService
  to shed the verify sweep (``enter_degraded``) so selection gets cheaper
  exactly when the queue says the engine is falling behind.

Deadline *shedding* deliberately does not happen here — a queued request's
deadline is checked when its slot drains (shed-not-executed), so the
admitted/completed/shed ledger stays a single identity:
``admitted == completed + shed`` once the engine runs dry.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np

from ..core.csr import CSR
from ..obs import trace as obs_trace
from ..sparse.resilience import Deadline


@dataclasses.dataclass
class EngineRequest:
    """One admitted unit of work as the engine tracks it: the operand, the
    optional RHS, the engine-clock arrival time (latency is measured from
    here), and the admission deadline."""

    name: str
    csr: CSR
    x: Optional[np.ndarray] = None
    t_enqueue: float = 0.0
    deadline: Optional[Deadline] = None
    tenant: int = -1
    # idempotency key (DESIGN.md §15): stable across incarnations, so a
    # journal-replayed request can never drain twice
    rid: str = ""


class BoundedQueue:
    """FIFO with hard-reject / soft-degrade watermarks.

    Counters live in the owning engine's registry scope, so queue
    telemetry is one view with the engine's; this class only owns the
    deque and the watermark policy.
    """

    def __init__(self, queue_max: int = 256,
                 soft_watermark: Optional[int] = None) -> None:
        self.queue_max = max(int(queue_max), 1)
        self.soft_watermark = (int(soft_watermark) if soft_watermark
                               is not None else max(self.queue_max * 3 // 4,
                                                    1))
        self._q: "deque[EngineRequest]" = deque()

    def __len__(self) -> int:
        return len(self._q)

    @property
    def over_soft(self) -> bool:
        return len(self._q) >= self.soft_watermark

    def push(self, req: EngineRequest) -> bool:
        """Enqueue under the hard watermark; ``False`` = rejected
        (backpressure). Emits the ``enqueue`` event either way, so the
        trace shows offered traffic, not just surviving traffic."""
        if len(self._q) >= self.queue_max:
            obs_trace.emit("enqueue", req.name, outcome="rejected",
                           depth=len(self._q))
            return False
        self._q.append(req)
        obs_trace.emit("enqueue", req.name, outcome="queued",
                       depth=len(self._q))
        return True

    def pop(self) -> Optional[EngineRequest]:
        return self._q.popleft() if self._q else None
