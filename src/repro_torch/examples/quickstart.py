"""Quickstart: the SpChar characterization loop end-to-end in ~a minute.

  1. build a corpus of sparse matrices (9 domains + 9 synthetic categories)
  2. compute the paper's static metrics (Eq. 1-6)
  3. simulate the kernel schedules and model GFLOPS on the port's
     platforms (``A100_SXM``, ``H100_SXM``, ``L40S``)
  4. train decision trees, cross-validate (Fig. 5), extract importances
     (Fig. 9/12/15), and compare across platforms (§3.5: features in every
     platform's top 5 are algorithm-intrinsic, the rest
     architecture-induced)
  5. use a tuner trained for ``H100_SXM`` to pick a kernel schedule for a
     new matrix and run it on ``--device`` (the card by default)

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core import (H100_SXM, PLATFORMS, ScheduleTuner,
                              build_slice, characterize, characterize_slice,
                              compare_platforms, corpus, grouped_importance)
from repro_torch.core.synthetic import gen_exponential
from repro_torch.sparse import plan

TREE_KW = dict(max_depth=24, min_samples_leaf=1, min_samples_split=2)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where step 5 runs its plan (cpu: the kernels' "
                         "plain PyTorch versions)")
    args = ap.parse_args(argv)

    print("== 1. corpus ==")
    mats = corpus(n_matrices=45, n_min=384, n_max=1024, seed=0)
    print(f"{len(mats)} matrices across "
          f"{len(set(d for _, d, _ in mats))} domains")

    print("\n== 2. static metrics for one matrix ==")
    name, domain, A = mats[0]
    for k, v in list(characterize(A).items())[:6]:
        print(f"  {k:22s} {v:.3f}")

    print("\n== 3+4. characterization loop ==")
    results = []
    for kernel in ("spmv", "spgemm", "spadd"):
        for plat in PLATFORMS.values():
            data = build_slice(kernel, mats, plat)
            res = characterize_slice(data, "gflops", k=5, **TREE_KW)
            results.append(res)
        g = grouped_importance(results[-1])
        print(f"  {kernel:7s} mape={results[-1].cv['mape']:.3f} "
              f"r2={results[-1].cv['r2']:.2f} groups="
              + ", ".join(f"{k}:{v:.2f}" for k, v in g.items()))
    cmp = compare_platforms(results, top=5)
    for kern, d in cmp.items():
        print(f"  {kern}: intrinsic={d['algorithm_intrinsic']} "
              f"induced={d['architecture_induced']}")

    print("\n== 5. loop-driven schedule selection (plan/execute facade) ==")
    tuner = ScheduleTuner("spmv", H100_SXM).fit(mats, max_mats=24)
    B = gen_exponential(2048, seed=7)
    # plan() resolves the Schedule through the fitted tuner, preps the
    # container once on the device, and returns the launch
    p = plan("spmv", (B,), selector=tuner, device=args.device)
    x = np.random.default_rng(0).standard_normal(B.shape[1]).astype(np.float32)
    y = p.execute(x).cpu().numpy()
    print(f"  new matrix (scale-free): {p.describe()} "
          f"(modeled={p.modeled_time_s or 0:.2e}s); "
          f"executed y[:3]={y[:3].round(3)}")


if __name__ == "__main__":
    main()
