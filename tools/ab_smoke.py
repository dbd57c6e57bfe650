#!/usr/bin/env python3
"""A/B of an older tree's ``chip_smoke.py`` against this tree's, on one GPU,
in one command.

    python3 tools/ab_smoke.py OLD_DIR

OLD_DIR is an unpacked tree of the repository (``git archive`` into a
git-ignored directory such as ``build/``). Runs the two trees'
``chip_smoke.py``, each from its own root, in the order old, new, new, old,
each building its kernels into its own ``build/``. Every run's standard
output and error go to ``build/ab/<i>_<arm>.out`` and ``.err``
(git-ignored). Prints the card line, then one JSON line per kernel x input
and per plan with the run's times in order (a plan's time without the
guard's NaN check where its line gives one), then one line with each run's
exit code and seconds. Exits nonzero when any run did.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def records(text: str):
    """The JSON object lines of a smoke run's standard output."""
    for line in text.splitlines():
        if line.startswith("{"):
            try:
                yield json.loads(line)
            except json.JSONDecodeError:
                continue


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    out_dir = ROOT / "build" / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    trees = {"old": Path(sys.argv[1]).resolve(), "new": ROOT}
    runs = []
    for i, arm in enumerate(("old", "new", "new", "old")):
        tree = trees[arm]
        t0 = time.monotonic()
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tree,
                              capture_output=True, text=True, timeout=1500)
        secs = time.monotonic() - t0
        stem = out_dir / f"{i}_{arm}"
        stem.with_suffix(".out").write_text(proc.stdout)
        stem.with_suffix(".err").write_text(proc.stderr)
        runs.append((arm, proc.returncode, secs, proc.stdout))
        print(f"run {i} {arm}: exit {proc.returncode} in {secs:.0f} s",
              file=sys.stderr, flush=True)
    card = next((ln for _, _, _, out in runs for ln in out.splitlines()
                 if ln and not ln.startswith("{")), None)
    print(card, flush=True)
    rows: dict = {}
    for i, (arm, _, _, out) in enumerate(runs):
        for r in records(out):
            if "kernel" in r:
                key = ("kernel", r["kernel"], r["input"])
                val = {"ms": r["ms"], "share_of_bound": r["share_of_bound"]}
            elif "plan" in r:
                key = ("plan", r["plan"], " ".join(
                    [r["input"]] + ([r["layout"]] if "layout" in r else [])))
                # the time without the guard's NaN check where the line
                # has it, so a tree from before the guard compares alike
                val = {"ms": next(r[k] for k in (
                    "execute_ms_unchecked", "ms_unchecked", "execute_ms",
                    "ms") if k in r)}
            else:
                continue
            rows.setdefault(key, {})[f"{i}_{arm}"] = val
    for (kind, name, inp), by_run in rows.items():
        print(json.dumps({kind: name, "input": inp, **by_run}), flush=True)
    print(json.dumps({"runs": [{"arm": arm, "exit": rc, "s": secs}
                               for arm, rc, secs, _ in runs]}), flush=True)
    return 0 if all(rc == 0 for _, rc, _, _ in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
