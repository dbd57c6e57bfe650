"""perfmodel calibration report: measured wall-clock vs modeled cost (the
port's copy of ``repro.obs.report``; it reads the trace files of either
package and gives the same report from both).

This is the SpChar thesis applied to ourselves: the roofline
``perfmodel`` predicts, the guarded launches measure, and the residual
between the two is the signal that teaches the predictor the *platform*
instead of the model of the platform. This report closes the loop's
reading end — it consumes the JSONL event logs the Tracer writes
(``--trace-out``), keeps every ``launch`` event that carries both a
``measured_ms`` and a ``modeled_ms``, and summarizes residuals per
``(op, layout, backend)``:

    python -m repro_torch.obs.report trace.jsonl [more.jsonl ...] [--json OUT]

Per group it prints the launch count, geometric-mean measured and modeled
times, the mean log10 residual, the implied calibration scale
(``10**mean_residual`` — multiply the model by this to center it on the
platform), and the post-calibration MAPE. A large stable scale with a small
MAPE means the model ranks schedules correctly but needs a constant
recalibrated; a large MAPE means the model is missing a term for that
group — exactly the distinction the tree-retraining feedback needs.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from typing import Dict, List, Optional, Tuple


def load_launches(paths: List[str]) -> List[Dict]:
    """All launch events with a usable measured/modeled pair from one or
    more JSONL event logs (bad lines are skipped and counted on stderr —
    a torn trace file costs lines, not the report)."""
    out: List[Dict] = []
    bad = 0
    for path in paths:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    ev = json.loads(line)
                except ValueError:
                    bad += 1
                    continue
                if ev.get("type") != "launch":
                    continue
                m, p = ev.get("measured_ms"), ev.get("modeled_ms")
                if not isinstance(m, (int, float)) or \
                        not isinstance(p, (int, float)) or m <= 0 or p <= 0:
                    continue
                out.append(ev)
    if bad:
        print(f"warning: skipped {bad} unparseable line(s)", file=sys.stderr)
    return out


def summarize(launches: List[Dict]) -> Dict[str, Dict[str, float]]:
    """Residual stats per ``op/layout/backend`` group (sorted keys)."""
    groups: Dict[Tuple[str, str, str], List[Tuple[float, float]]] = {}
    for ev in launches:
        key = (str(ev.get("op", "?")), str(ev.get("layout", "?")),
               str(ev.get("backend", "?")))
        groups.setdefault(key, []).append(
            (float(ev["measured_ms"]), float(ev["modeled_ms"])))
    report: Dict[str, Dict[str, float]] = {}
    for (op, layout, backend), pairs in sorted(groups.items()):
        logs = [math.log10(m / p) for m, p in pairs]
        mean_resid = sum(logs) / len(logs)
        scale = 10.0 ** mean_resid
        # MAPE after applying the group's calibration scale: what error
        # remains once the constant offset is absorbed
        mape = sum(abs(m - p * scale) / m for m, p in pairs) / len(pairs)
        gm = lambda xs: 10.0 ** (sum(math.log10(x) for x in xs) / len(xs))
        report["/".join((op, layout, backend))] = {
            "launches": float(len(pairs)),
            "measured_gm_ms": gm([m for m, _ in pairs]),
            "modeled_gm_ms": gm([p for _, p in pairs]),
            "residual_log10": mean_resid,
            "calibration_scale": scale,
            "calibrated_mape": mape,
        }
    return report


def main(argv: Optional[List[str]] = None) -> Dict[str, Dict[str, float]]:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("traces", nargs="+", metavar="TRACE_JSONL",
                    help="JSONL event log(s) written by --trace-out")
    ap.add_argument("--json", dest="json_out", default=None, metavar="OUT",
                    help="also write the report as JSON to this path")
    args = ap.parse_args(argv)
    launches = load_launches(args.traces)
    report = summarize(launches)
    if not report:
        print("no launch events with measured+modeled times found "
              f"in {len(args.traces)} trace(s)")
    else:
        print(f"{'op/layout/backend':36s} {'n':>5s} {'meas_ms':>9s} "
              f"{'model_ms':>9s} {'resid':>7s} {'scale':>9s} {'mape':>6s}")
        for key, row in report.items():
            print(f"{key:36s} {row['launches']:5.0f} "
                  f"{row['measured_gm_ms']:9.3f} "
                  f"{row['modeled_gm_ms']:9.3f} "
                  f"{row['residual_log10']:+7.2f} "
                  f"{row['calibration_scale']:9.2f} "
                  f"{row['calibrated_mape']:6.2f}")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(report, f, indent=1, sort_keys=True)
    return report


if __name__ == "__main__":
    main()
