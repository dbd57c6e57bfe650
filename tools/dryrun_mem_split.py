#!/usr/bin/env python3
"""A dry-run cell's memory peak per device, as ``MemTracker`` files it.

    PYTHONPATH=src python3 tools/dryrun_mem_split.py --arch llama3.2-3b \\
        --shape train_4k [--multi-pod]

Builds the cell with ``repro_torch.launch.dryrun.build_cell`` (full size:
run it on a host with tens of GB free, not beside other jobs) and prints
one JSON line per device of ``MemTracker``'s peak snapshot, by reference
type (GB), then the cell's ``memory`` report. Every tensor of the step is
on ``meta``, and the report counts that device alone; under torch 2.11 the
tracker also files the fake tensors of DTensor's sharding propagation
(global shapes, on the mesh's device type ``cpu``), which the line for
``cpu`` shows.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)
    import torch
    from torch.distributed._tools import mem_tracker
    from repro_torch.launch import dryrun

    exit_ = mem_tracker.MemTracker.__exit__

    def report_exit(self, *a):
        out = exit_(self, *a)
        for dev, snap in self.get_tracker_snapshot("peak").items():
            print(json.dumps({"device": str(dev), "torch": torch.__version__,
                              "peak_GB": {str(k).rpartition(".")[2]:
                                          v / 1e9 for k, v in snap.items()
                                          if v}}), flush=True)
        return out

    mem_tracker.MemTracker.__exit__ = report_exit
    try:
        rep = dryrun.build_cell(args.arch, args.shape, args.multi_pod)
    finally:
        mem_tracker.MemTracker.__exit__ = exit_
    print(json.dumps({"arch": args.arch, "shape": args.shape,
                      "mesh": rep["mesh"], "status": rep["status"][:200],
                      "memory": rep.get("memory")}))
    return 0 if rep["status"] == "ok" else 1


if __name__ == "__main__":
    sys.exit(main())
