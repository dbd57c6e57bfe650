"""The device timeline of a traced window, read from ``torch.profiler``'s
Chrome trace.

The traffic loop marks the window (``spbench.window``) and each op's step
(``spbench.execute``) with ``record_function``. Each device event (kernel,
memcpy, memset) is tied by its correlation id to the runtime call that
launched it, and so to the step whose range holds that call and to the
innermost operator that launched it (its ``External id``). Busy time is
the union of device events inside the window; an idle gap is named by
the innermost host event (operator, annotation or runtime call) of the
window's thread at the gap's middle.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset", "memcpy", "memset"}
RUNTIME_CATS = {"cuda_runtime", "cuda_driver", "runtime"}
HOST_CATS = {"cpu_op", "operator", "user_annotation"} | RUNTIME_CATS
# operators that stage a step's input (padding x to the block grid)
STAGING_OPS = {"aten::copy_", "aten::fill_", "aten::zero_"}
TOP = 10


@dataclasses.dataclass
class DeviceEvent:
    name: str
    ts: float                      # microseconds
    dur: float
    in_execute: bool               # launched inside an op's step
    launcher: Optional[str]        # innermost operator that launched it


@dataclasses.dataclass
class Timeline:
    window: Tuple[float, float]    # (start, end), microseconds
    n_execute: int
    events: List[DeviceEvent]
    host: List[Tuple[float, float, str]]   # the window thread's events

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def execute_events(self) -> List[DeviceEvent]:
        return [e for e in self.events if e.in_execute]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        lo, hi = self.window
        spans = sorted((max(e.ts, lo), min(e.ts + e.dur, hi))
                       for e in self.events if e.ts + e.dur > lo
                       and e.ts < hi)
        merged: List[List[float]] = []
        for a, b in spans:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def gaps(self) -> List[Tuple[float, float]]:
        lo, hi = self.window
        out, t = [], lo
        for a, b in self.busy_intervals():
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if hi > t:
            out.append((t, hi))
        return out

    def breakdown(self) -> Dict[str, List]:
        """The device operations that took most time, and the idle gaps
        summed by what the host was doing, each as [name, seconds]."""
        ops: Dict[str, float] = defaultdict(float)
        lo, hi = self.window
        for e in self.events:
            if lo <= e.ts < hi:
                ops[e.name[:120]] += e.dur * 1e-6
        idle: Dict[str, float] = defaultdict(float)
        for (a, b), name in zip(self.gaps(), self._label_gaps()):
            idle[name] += (b - a) * 1e-6
        top = lambda d: [[k, v] for k, v in sorted(  # noqa: E731
            d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(ops), "idle_gaps": top(idle)}

    def _label_gaps(self) -> List[str]:
        """The innermost host event at each gap's middle (events of one
        thread nest, so a sweep with a stack finds it)."""
        mids = [((a + b) / 2, n) for n, (a, b) in enumerate(self.gaps())]
        labels = ["host: no traced event"] * len(mids)
        host = sorted(self.host, key=lambda h: (h[0], -h[1]))
        stack: List[Tuple[float, str]] = []
        j = 0
        for mid, n in sorted(mids):
            while j < len(host) and host[j][0] <= mid:
                while stack and stack[-1][0] < host[j][0]:
                    stack.pop()
                stack.append((host[j][1], host[j][2]))
                j += 1
            while stack and stack[-1][0] < mid:
                stack.pop()
            if stack:
                labels[n] = stack[-1][1][:120]
        return labels


def parse(trace: Dict) -> Optional[Timeline]:
    """The timeline of a Chrome trace (the parsed JSON); None when it holds
    no window or no device event."""
    evs = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    window = None
    execute: List[Tuple[float, float]] = []
    ops: Dict[int, str] = {}
    launches: Dict[int, float] = {}
    device = []
    for e in evs:
        cat = str(e.get("cat", "")).lower()
        args = e.get("args") or {}
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat == "user_annotation" and e["name"] == "spbench.window":
            window = (ts, ts + dur, e.get("pid"), e.get("tid"))
        elif cat == "user_annotation" and e["name"] == "spbench.execute":
            execute.append((ts, ts + dur))
        if cat in ("cpu_op", "operator") and "External id" in args:
            ops[int(args["External id"])] = e["name"]
        if cat in RUNTIME_CATS and "correlation" in args:
            launches[int(args["correlation"])] = ts
        if cat in DEVICE_CATS:
            device.append(e)
    if window is None or not device:
        return None
    execute.sort()
    starts = [a for a, _ in execute]

    def in_execute(t: Optional[float]) -> bool:
        if t is None:
            return False
        k = bisect.bisect_right(starts, t) - 1
        return k >= 0 and execute[k][0] <= t <= execute[k][1]

    events = []
    for e in device:
        args = e.get("args") or {}
        corr = args.get("correlation")
        launch = launches.get(int(corr)) if corr is not None else None
        ext = args.get("External id")
        events.append(DeviceEvent(
            name=e["name"], ts=float(e["ts"]), dur=float(e.get("dur", 0.0)),
            in_execute=in_execute(launch),
            launcher=ops.get(int(ext)) if ext is not None else None))
    lo, hi, pid, tid = window
    host = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
             e["name"]) for e in evs
            if str(e.get("cat", "")).lower() in HOST_CATS
            and e.get("pid") == pid and e.get("tid") == tid
            and e["name"] != "spbench.window"]
    return Timeline(window=(lo, hi), n_execute=len(execute), events=events,
                    host=host)


def load(path) -> Optional[Timeline]:
    with open(path) as f:
        return parse(json.load(f))
