"""Characterize a user matrix and pick kernel schedules for it — the
"characterization loop" as a user-facing tool (paper §6 goal: help HW/SW
designers map architectural features to inputs/algorithms).

Run:  PYTHONPATH=src python -m repro_torch.examples.characterize \
          [--category uniform] [--n 1024] [--device cpu]
      PYTHONPATH=src python -m repro_torch.examples.characterize --serve 16
(the --serve mode routes requests through the online selection service
instead of re-running the tuner per matrix; see repro_torch/selector/.)
"""
import argparse

from repro_torch.core import (GENERATORS, PLATFORMS, ScheduleTuner,
                              characterize, corpus, run_spadd_model,
                              run_spgemm_model, run_spmv_model,
                              stall_breakdown)


def serve_mode(n_requests: int, platform_name: str = "h100_sxm",
               device: str = "cuda") -> None:
    """Serve ``n_requests`` schedule requests through the selector service
    (a thin wrapper over its CLI, repro_torch.selector.serve)."""
    from repro_torch.selector.serve import main as serve_main

    serve_main(["--requests", str(n_requests), "--platform", platform_name,
                "--device", device])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--category", default=None, choices=sorted(GENERATORS),
                    help="matrix family (default: exponential)")
    ap.add_argument("--n", type=int, default=None,
                    help="matrix size (default: 2048)")
    ap.add_argument("--platform", default=None, choices=sorted(PLATFORMS),
                    help="serving platform for --serve (default: h100_sxm)")
    ap.add_argument("--serve", type=int, default=0, metavar="N",
                    help="serve N requests through the online selector "
                         "service instead of one-off characterization")
    ap.add_argument("--device", default="cuda",
                    help="where the plans run (cpu: the kernels' plain "
                         "PyTorch versions)")
    args = ap.parse_args(argv)

    if args.serve:
        if args.category is not None or args.n is not None:
            ap.error("--serve draws requests from the held-out corpus; "
                     "--category/--n do not apply")
        serve_mode(args.serve, args.platform or "h100_sxm", args.device)
        return
    if args.platform is not None:
        ap.error("--platform only applies to --serve; the characterization "
                 "report covers every platform")

    category, n = args.category or "exponential", args.n or 2048
    A = GENERATORS[category](n, seed=0)
    print(f"matrix: {category} n={n} nnz={A.nnz}")
    print("\nstatic metrics (paper Eq. 1-6):")
    for k, v in characterize(A).items():
        print(f"  {k:22s} {v:10.4f}")

    print("\nper-platform kernel forecast (modeled):")
    print(f"  {'kernel':8s} {'platform':9s} {'GFLOPS':>8s} {'bound':>8s} "
          f"{'frontend%':>10s} {'backend%':>9s}")
    for kern, fn in (("spmv", lambda p: run_spmv_model(A, p)),
                     ("spgemm", lambda p: run_spgemm_model(A, A, p)),
                     ("spadd", lambda p: run_spadd_model(A, A.transpose(), p))):
        for plat in PLATFORMS.values():
            c, t, tg = fn(plat)
            sb = stall_breakdown(t)
            print(f"  {kern:8s} {plat.name:9s} {tg['gflops']:8.1f} "
                  f"{t['bound']:>8s} {100*sb['frontend_stall_frac']:9.1f}% "
                  f"{100*sb['backend_stall_frac']:8.1f}%")

    print("\nloop-driven schedule selection (SpMV, plan/execute facade):")
    from repro_torch.sparse import plan
    mats = corpus(n_matrices=27, n_min=384, n_max=1024, seed=1)
    for plat in PLATFORMS.values():
        tuner = ScheduleTuner("spmv", plat).fit(mats, max_mats=16)
        p = plan("spmv", (A,), selector=tuner, device=args.device)
        print(f"  {plat.name:9s} -> {p.describe()} "
              f"t={p.modeled_time_s or 0:.3e}s")


if __name__ == "__main__":
    main()
