"""The readings a cell's limits are set from, on the card, in one process.

    python -m spbench.readings --workload <cell> --seeds 1,2,3 --seconds 3

For each seed: the program through a short window at the cell's own load
(``prod_gap`` of its kept products: the lower reading), then the control,
the plain reference in TF32 put in the program's place and driven through
the same window on the same inputs (the upper reading). One JSON line per
seed, then, for each number compared, the largest program reading and the
smallest control reading beside its limit. A configuration run by a driver
(``drivers/<name>.py``) takes that driver's ``readings``. Every row gives
its readings as ``program`` and ``control``, each keyed by the name of the
number in the cell's limits, so this module names no driver's numbers. The
benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys

from spbench import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run.set_environment()
    from spbench import manifest
    cell = manifest.resolve(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    name = cell.config.get("driver")
    take = (readings if name is None
            else manifest.driver(cell.package, name).readings)
    lines = take(cell, seeds, args.seconds, args.device)
    for number in lines[0]["program"]:
        print(json.dumps({
            "workload": args.workload, "number": number,
            "program_max": max(r["program"][number] for r in lines),
            "control_min": min(r["control"][number] for r in lines),
            "limit": cell.limits[number]}), flush=True)
    return 0


def readings(cell, seeds, seconds: float, device="cuda", log=print):
    import torch
    from spbench import harness, reference
    from spbench.drive import Loop, make_inputs
    device = torch.device(device)
    tuner = harness.fit_tuner(cell)
    out = []
    for seed in seeds:
        mat = harness.generate(cell, seed)
        p, svc, _ = harness.build_plan(cell, mat, tuner, device)
        pick = p.describe()
        inputs = make_inputs(cell.traffic, mat["shape"][1], seed, device)
        loop = Loop(cell.traffic, p.execute, inputs, seed, device)
        loop.warm()
        win = loop.window(seconds)
        del p, svc, loop
        harness.free_cuda()
        ref = reference.Reference(mat, device)
        _, prog = reference.judge(ref, win.samples, cell.limits, win.ops,
                                  win.failed)
        del win
        ctrl_loop = Loop(cell.traffic, ref.control, inputs, seed, device)
        ctrl_loop.warm()
        cwin = ctrl_loop.window(seconds)
        _, ctrl = reference.judge(ref, cwin.samples, cell.limits, cwin.ops,
                                  cwin.failed)
        row = {"seed": seed, "pick": pick,
               "program": {"prod_gap": prog["prod_gap"]["value"]},
               "control": {"prod_gap": ctrl["prod_gap"]["value"]},
               "program_products": prog["products_checked"]["value"],
               "control_products": ctrl["products_checked"]["value"]}
        log(json.dumps(row), flush=True)
        out.append(row)
        del ref, ctrl_loop, cwin, inputs
        harness.free_cuda()
    return out


if __name__ == "__main__":
    sys.exit(main())
