"""The one traffic loop: it reads a mix's parameters (``traffic/<mix>.json``)
and drives a step function through set-up's warm-up and the measured
window.

Parameters of a mix:

- ``op``: the sparse op planned (``spmv``, ``spmm``);
- ``n_rhs``: columns of each right-hand side (1 is a vector);
- ``inputs``: how many right-hand sides set-up draws from the seed, on the
  card, cycled through in order;
- ``chain``: ``"max_abs"`` feeds each result back as the next input,
  divided by its largest magnitude (power iteration); null cycles the
  inputs;
- ``warmup_ops``: ops run in set-up, before the window;
- ``sample_slots``: how many of the window's products are kept for the
  check: a uniform sample drawn from the seed (reservoir sampling), with
  each result copied into a slot allocated in set-up.

In a traced run the profiler records the first ``TRACE_SECONDS`` of the
window; the rest runs untraced.

The loop is closed: each op is due when the previous one's result was
synchronised. An op's latency runs from when it was due to when its
result was synchronised; the window's wall time runs from its start to
the last result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, List, Optional, Tuple

import numpy as np

# the profiler's cost per op grows with its trace, so it records only this
# much of a traced window
TRACE_SECONDS = 5.0


@dataclasses.dataclass
class Window:
    ops: int                       # products completed in the window
    failed: int                    # ops that raised (the window stops)
    wall_s: float                  # window start to the last result
    latencies_s: List[float]       # per op, from due to synchronised
    execute_s: List[float]         # per op, host time around the step
    samples: List[Tuple]           # (input, copied result) pairs
    traced_ops: int = 0            # the first ops, run under the profiler
    untraced_s: float = 0.0        # wall time of the ops after the trace
    error: Optional[str] = None


@dataclasses.dataclass
class _Run:
    """A window's running state; ``done`` is when the last result came (the
    next op's due time)."""
    t0: float
    done: float = 0.0
    i: int = 0
    failed: int = 0
    error: Optional[str] = None
    latencies: List[float] = dataclasses.field(default_factory=list)
    execute: List[float] = dataclasses.field(default_factory=list)
    kept: List[Tuple] = dataclasses.field(default_factory=list)

    def __post_init__(self) -> None:
        self.done = self.t0


def make_inputs(traffic, n_cols: int, seed: int, device) -> List:
    """The mix's right-hand sides, drawn from ``seed`` on ``device`` by one
    generator in a few large calls."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    k = int(traffic["n_rhs"])
    shape = (n_cols,) if k == 1 else (n_cols, k)
    return [torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32)
            for _ in range(int(traffic["inputs"]))]


class Loop:
    """Drives ``step`` (input -> result) under one mix."""

    def __init__(self, traffic, step: Callable, inputs: List, seed: int,
                 device) -> None:
        import torch
        self.traffic = traffic
        self.step = step
        self.inputs = inputs
        self.device = torch.device(device)
        self.annotate = False          # on while the profiler records
        self.chain = traffic.get("chain")
        if self.chain not in (None, "max_abs"):
            raise ValueError(f"unknown chain {self.chain!r}")
        self.n_slots = int(traffic["sample_slots"])
        self._sample_rng = np.random.default_rng([int(seed), 1])
        self._x = inputs[0]
        self._slots: Optional[List] = None

    # ------------------------------------------------------------ helpers
    def _sync(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _range(self, name: str):
        if not self.annotate:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(name)

    def _next_input(self, i: int):
        if self.chain:
            return self._x
        return self.inputs[i % len(self.inputs)]

    def _advance(self, y) -> None:
        if self.chain == "max_abs":
            self._x = y / y.abs().amax()

    # ------------------------------------------------------------- phases
    def warm(self) -> None:
        """Set-up: the mix's own shapes through the step, the chain's
        arithmetic and the sample slots' copy, then the chain restarts
        from its first input."""
        import torch
        y = None
        for i in range(max(int(self.traffic.get("warmup_ops", 2)), 1)):
            y = self.step(self._next_input(i))
            self._advance(y)
        self._slots = [torch.empty_like(y) for _ in range(self.n_slots)]
        if self._slots:
            self._slots[0].copy_(y)
        self._sync()
        self._x = self.inputs[0]

    def window(self, seconds: float,
               stop_trace: Optional[Callable[[], None]] = None) -> Window:
        """Ops for ``seconds``. With ``stop_trace``, the profiler is on at
        the start: the first ``TRACE_SECONDS`` of the window run annotated,
        then ``stop_trace`` turns the profiler off and the rest runs as an
        untraced window does (its wall time is ``untraced_s``)."""
        if self._slots is None:
            raise RuntimeError("warm() first: the window compiles nothing")
        run = _Run(time.monotonic())
        traced = 0
        if stop_trace is not None:
            until = min(TRACE_SECONDS, seconds)
            self.annotate = True
            with self._range("spbench.window"):
                self._ops(run, until)
                self._sync()
            self.annotate = False
            traced = run.i
            stop_trace()
            run.done = time.monotonic()    # the next op is due from here
        resume = run.done
        self._ops(run, seconds)
        self._sync()
        samples = [(x, self._slots[j]) for j, x in sorted(run.kept)]
        return Window(ops=run.i, failed=run.failed,
                      wall_s=run.done - run.t0, latencies_s=run.latencies,
                      execute_s=run.execute, samples=samples,
                      traced_ops=traced, untraced_s=run.done - resume,
                      error=run.error)

    def _ops(self, run: "_Run", seconds: float) -> None:
        """Closed loop until the next op would be due ``seconds`` after
        the window's start, or an op raises."""
        while run.error is None and run.done - run.t0 < seconds:
            x = self._next_input(run.i)
            ts = time.monotonic()
            try:
                with self._range("spbench.execute"):
                    y = self.step(x)
                self._sync()
            except Exception as e:   # the window's boundary: record
                run.failed, run.error = 1, f"{type(e).__name__}: {e}"
                return
            due, run.done = run.done, time.monotonic()
            run.latencies.append(run.done - due)
            run.execute.append(run.done - ts)
            self._keep(run.i, x, y, run.kept)
            self._advance(y)
            run.i += 1

    def _keep(self, i: int, x, y, kept: List) -> None:
        """Reservoir sampling (Vitter's algorithm R) over the window's
        products; ``kept`` holds (slot, input) pairs."""
        if i < self.n_slots:
            j = i
        else:
            j = int(self._sample_rng.integers(0, i + 1))
            if j >= self.n_slots:
                return
        if tuple(y.shape) != tuple(self._slots[j].shape):
            # a result of the wrong shape is kept as it is, to be judged
            self._slots[j] = y.clone()
        else:
            self._slots[j].copy_(y)
        for n, (slot, _) in enumerate(kept):
            if slot == j:
                kept[n] = (j, x)
                return
        kept.append((j, x))
