"""Serve a small model with batched requests, then the two SpChar decode
paths (port of ``examples/serve_lm.py``):

  1. ``launch.serve``: prefill + greedy decode of ``--requests`` requests
     on a reduced ``--arch`` (mixtral-8x22b's family by default);
  2. ``serving.decode.decode_moe_ticks``: each decode tick's MoE expert
     compute through ``plan("moe_gmm")``, its tile from the
     selector-backed ``ScheduleCache`` per routing fingerprint;
  3. ``decode_multirhs_ticks``: each tick's decode vectors against one
     shared sparse operand, first one ``spmv`` plan per request, then one
     multi-RHS ``spmm`` plan per tick (one launch instead of ``batch``).

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np

from repro_torch.core.autotune import Schedule
from repro_torch.core.synthetic import gen_zipf
from repro_torch.launch.serve import main as serve_main
from repro_torch.selector import ScheduleCache
from repro_torch.serving.decode import decode_moe_ticks
from repro_torch.sparse import PreparedStore, launch_count, plan


def decode_multirhs_ticks(n_ticks: int, n: int = 512, batch: int = 4,
                          store: Optional[PreparedStore] = None,
                          seed: int = 0, device="cuda") -> dict:
    """Batch each decode tick's vectors into ONE multi-RHS SpMM plan.

    Per request, a tick runs one ``spmv`` plan; stacking the tick's
    ``batch`` vectors as the columns of an (n, batch) RHS makes it one
    ``spmm`` plan, which reads every A block once for the whole batch:
    one launch per tick instead of ``batch``. The outputs agree column for
    column (``rtol=atol=2e-4``); the launch counters show the collapse.
    """
    store = store if store is not None else PreparedStore()
    A = gen_zipf(n, seed=seed, a=1.5)  # the tick's shared sparse operand
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((n_ticks, batch, n)).astype(np.float32)

    sched_mv = Schedule("bsr", 64, 1.0, layout="sell", slice_height=8)
    sched_mm = Schedule("bsr", 64, 1.0, layout="sell", slice_height=8,
                        n_rhs=batch)
    l0 = launch_count("spmv")
    t0 = time.perf_counter()
    per_req = [np.stack([
        plan("spmv", (A,), schedule=sched_mv, store=store,
             device=device).execute(x).cpu().numpy() for x in xs[t]],
        axis=1) for t in range(n_ticks)]
    t_spmv = time.perf_counter() - t0
    spmv_launches = launch_count("spmv") - l0

    l0 = launch_count("spmm")
    t0 = time.perf_counter()
    batched = [plan("spmm", (A,), schedule=sched_mm, store=store,
                    device=device).execute(xs[t].T).cpu().numpy()
               for t in range(n_ticks)]
    t_spmm = time.perf_counter() - t0
    spmm_launches = launch_count("spmm") - l0

    for a, b in zip(per_req, batched):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4)
    return {"ticks": n_ticks, "batch": batch,
            "spmv_launches": spmv_launches, "spmm_launches": spmm_launches,
            "spmv_s": t_spmv, "spmm_s": t_spmm,
            "speedup": t_spmv / max(t_spmm, 1e-9)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x22b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    res = serve_main(["--arch", args.arch, "--reduced",
                      "--requests", str(args.requests), "--batch", "4",
                      "--prompt-len", "64", "--gen-len", str(args.gen_len),
                      "--attn-chunk", "32", "--device", args.device])
    print(f"throughput: {res['throughput_tok_s']:.1f} tok/s")

    moe = decode_moe_ticks(args.gen_len, cache=ScheduleCache(),
                           device=args.device)
    tiles = sorted({bs for bs, _ in moe["ticks"]})
    print(f"decode MoE: {len(moe['ticks'])} ticks, tile_m choices {tiles}, "
          f"cache hit rate {moe['cache_hit_rate']:.2f} "
          f"({moe['cache_entries']:.0f} entries), prepared-operand hit rate "
          f"{moe['prep_hit_rate']:.2f}")

    mr = decode_multirhs_ticks(min(args.gen_len, 8), device=args.device)
    print(f"decode multi-RHS: {mr['ticks']} ticks x batch {mr['batch']}: "
          f"{mr['spmv_launches']} spmv launches -> {mr['spmm_launches']} "
          f"spmm launches, {mr['speedup']:.1f}x wall-clock")
    return {"serve": res, "moe": moe, "multirhs": mr}


if __name__ == "__main__":
    main()
