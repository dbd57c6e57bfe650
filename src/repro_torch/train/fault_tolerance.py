"""Fault tolerance for 1000+ node posture (DESIGN.md §6); a copy of
``repro.train.fault_tolerance`` (numpy only).

On a real multi-pod deployment every host runs this supervisor around the
train loop; here the mechanisms are implemented and unit-tested with
simulated failures:

  * HeartbeatMonitor  — per-host step heartbeats; hosts silent for
    ``timeout_s`` are declared dead (pod-granular failure domain).
  * StragglerDetector — robust per-step timing stats (median + MAD); hosts
    slower than median + k*MAD for ``patience`` consecutive steps are
    flagged for replacement/avoidance (the scheduler decision is up to the
    cluster layer; we surface the signal).
  * ElasticPlan       — given surviving hosts, proposes the largest
    (pod, data, model) mesh that keeps the model axis intact (TP must stay
    whole; DP/pod axes shrink), and the checkpoint step to resume from.
  * run_with_restarts — a supervisor that retries the step function across
    simulated preemptions, restoring from the latest checkpoint; used by
    ``launch.train --simulate-failures``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


class HeartbeatMonitor:
    def __init__(self, hosts: Sequence[str], timeout_s: float = 60.0):
        self.timeout_s = timeout_s
        self.last_seen: Dict[str, float] = {h: time.time() for h in hosts}

    def beat(self, host: str, now: Optional[float] = None) -> None:
        self.last_seen[host] = time.time() if now is None else now

    def dead_hosts(self, now: Optional[float] = None) -> List[str]:
        now = time.time() if now is None else now
        return [h for h, t in self.last_seen.items()
                if now - t > self.timeout_s]


class StragglerDetector:
    """Median + MAD outlier detection over per-host step durations."""

    def __init__(self, k: float = 4.0, patience: int = 3, window: int = 32):
        self.k = k
        self.patience = patience
        self.window = window
        self.history: Dict[str, List[float]] = {}
        self.strikes: Dict[str, int] = {}

    def record(self, host: str, step_seconds: float) -> None:
        self.history.setdefault(host, []).append(step_seconds)
        self.history[host] = self.history[host][-self.window:]

    def stragglers(self) -> List[str]:
        if len(self.history) < 2:
            return []
        latest = {h: v[-1] for h, v in self.history.items() if v}
        vals = np.asarray(list(latest.values()))
        med = np.median(vals)
        mad = np.median(np.abs(vals - med)) + 1e-9
        out = []
        for h, v in latest.items():
            if v > med + self.k * mad * 1.4826:
                self.strikes[h] = self.strikes.get(h, 0) + 1
            else:
                self.strikes[h] = 0
            if self.strikes.get(h, 0) >= self.patience:
                out.append(h)
        return out


@dataclasses.dataclass
class ElasticPlan:
    mesh_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    dropped_hosts: Tuple[str, ...]
    resume_step: Optional[int]


def plan_elastic_restart(total_hosts: int, dead: Sequence[str],
                         hosts_per_pod: int, model_axis: int,
                         data_axis: int, resume_step: Optional[int]
                         ) -> ElasticPlan:
    """Drop whole pods containing dead hosts; keep TP intact, shrink DP.

    Production rationale: the model axis maps to intra-pod ICI and cannot
    span holes; the data/pod axes are pure gradient-averaging and can
    shrink freely (loss scale handled by the data pipeline's global-batch
    reslicing — see data/pipeline.py shard_batch_at).
    """
    dead_pods = sorted({int(h.split(":")[0].replace("pod", ""))
                        for h in dead})
    n_pods = total_hosts // hosts_per_pod
    alive_pods = [p for p in range(n_pods) if p not in dead_pods]
    if not alive_pods:
        raise RuntimeError("no surviving pods")
    if len(alive_pods) == 1:
        return ElasticPlan((data_axis, model_axis), ("data", "model"),
                           tuple(f"pod{p}" for p in dead_pods), resume_step)
    return ElasticPlan((len(alive_pods), data_axis, model_axis),
                       ("pod", "data", "model"),
                       tuple(f"pod{p}" for p in dead_pods), resume_step)


def run_with_restarts(step_fn: Callable[[int], None], *, n_steps: int,
                      save_every: int, save_fn: Callable[[int], None],
                      restore_fn: Callable[[], int],
                      failure_schedule: Optional[Dict[int, Exception]] = None,
                      max_restarts: int = 8) -> Dict[str, int]:
    """Supervisor loop: run steps, checkpoint periodically, and on failure
    restore from the latest checkpoint and continue. ``failure_schedule``
    maps step -> exception to raise (simulated preemption/HW fault)."""
    failure_schedule = dict(failure_schedule or {})
    restarts = 0
    step = restore_fn()
    while step < n_steps:
        try:
            if step in failure_schedule:
                exc = failure_schedule.pop(step)
                raise exc
            step_fn(step)
            step += 1
            if step % save_every == 0:
                save_fn(step)
        except (RuntimeError, OSError) as e:
            restarts += 1
            if restarts > max_restarts:
                raise RuntimeError(f"exceeded max restarts: {e}") from e
            step = restore_fn()
    return {"final_step": step, "restarts": restarts}
