"""Run one cell of the benchmark on the card this process is started on.

    python -m spbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's configuration picks what runs it
(``manifest.runner``: its ``driver``, or the sparse harness). It prints
the selector's pick (in a model cell, its set-up) on an earlier line,
then as its last line one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics), ``device`` and, traced,
``breakdown``; last in it, ``checks``: each number compared with its
limit, which also close standard error. Without a CUDA card, with fewer
cards than the cell asks for, or with JAX or the JAX package loaded once
the window has closed, it prints no result and exits non-zero.

Every build and kernel cache of the program is kept under the checkout's
``build/``, at fixed paths, so only a checkout's first run compiles.
"""
from __future__ import annotations

import time

T0 = time.monotonic()   # process start, as near as Python lets us see it

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def set_environment() -> None:
    """Cache directories inside the checkout, the program on the path, and
    no JAX behind any library."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(build / "inductor")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ["USE_FLAX"] = "0"
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def power_limit() -> Optional[str]:
    """The first card's power limit, as nvidia-smi reads it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].split(",")[-1].strip() if lines else None


def result_line(outcome, device: Dict, traced: bool) -> Dict:
    """The run's last line; ``device`` holds the card's platform, kind,
    count and power limit."""
    ctx = outcome.context
    device = dict(device, memory_peak_bytes=ctx.memory_peak_bytes)
    line = {"correct": outcome.correct,
            "attempted": ctx.window.ops + ctx.window.failed,
            "failed": ctx.window.failed, "metrics": outcome.metrics,
            "device": device}
    if traced and ctx.timeline is not None:
        device["busy_s"] = ctx.timeline.busy_s()
        device["window_s"] = ctx.timeline.window_s
        line["breakdown"] = ctx.timeline.breakdown()
    line["checks"] = outcome.checks
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_environment()

    from spbench import manifest
    cell = manifest.resolve(args.workload)
    import repro_torch  # noqa: F401  (the system under test, from src/)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"spbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    outcome = manifest.runner(cell)(cell, args.seed, args.seconds,
                                    bool(args.trace), device="cuda", t0=T0)
    if outcome.context.window.error:
        print(f"spbench: the window stopped: {outcome.context.window.error}",
              file=sys.stderr)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips, "power_limit": power_limit()}
    return emit(outcome, device, bool(args.trace))


def emit(outcome, device: Dict, traced: bool) -> int:
    """Print the checks and the result line; 3, and no result, when JAX or
    the JAX package is loaded by now (after the readers and the
    reference)."""
    from spbench import harness
    banned = harness.banned_modules()
    if banned:
        print("spbench: JAX or the JAX package was loaded: "
              + ", ".join(banned), file=sys.stderr)
        return 3
    line = result_line(outcome, device, traced)
    for name, c in outcome.checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0

if __name__ == "__main__":
    sys.exit(main())
