#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: drives the plan/execute SpMV/SpMM
path on one NVIDIA GPU at full matrix size and holds every kernel against
its plain PyTorch version and a float64 CSR oracle.

    python3 chip_smoke.py            # needs one CUDA card; ~2-5 min

Phases (any failure exits nonzero; nothing is caught and passed over):
  1. build the CUDA kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a) and
     print the build time and the card's name and power limit;
  2. main path: ``plan("spmv"|"spmm")`` over ELL and SELL on
     ``gen_spatial(524288)`` (bs=32) and ``gen_zipf(8192)`` (bs=128) through
     a ``PreparedStore``, then ``plan_bucket("spmv")`` over four distinct
     ``gen_zipf`` members (one launch) and over four requests on one matrix
     (one multi-RHS launch). The kernels' launch counts are zeroed just
     before and read just after; each output is checked against the float64
     oracle: ``max|y - y_ref| <= 1e-4 * max|y_ref|`` (fp32 sums of up to
     8,192 products, taken in another order);
  3. per kernel x input, at the main path's prepared shapes: the kernel
     against its plain version (same inputs, same tolerance) and the oracle,
     the kernel's median time (CUDA events, after warm-up), the plain
     version's, one cuSPARSE call computing the same product
     (``torch.sparse_csr_tensor(...) @ x``, a yardstick the port never
     calls), and the byte/operation bound on an H100 (3.35 TB/s,
     67 TFLOP/s fp32);
  4. print the ``kernels`` JSON line, the card line and, last,
     ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
FP32_FLOP_PER_S = 67e12            # H100 SXM fp32 outside the tensor cores
TOL = 1e-4                         # relative to max|y_ref|
K_RHS = 8
SOURCE = "src/repro_torch/csrc/bsr_spmv.cu"
TPU_KERNELS = {                    # kernel -> the Pallas function it replaces
    "bsr_spmv_ell": "src/repro/kernels/bsr_spmv/kernel.py:78",
    "bsr_spmm_ell": "src/repro/kernels/bsr_spmv/kernel.py:112",
    "bsr_spmv_sell": "src/repro/kernels/bsr_spmv/kernel.py:144",
    "bsr_spmm_sell": "src/repro/kernels/bsr_spmv/kernel.py:183",
}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def rel_err(y, ref) -> float:
    y = np.asarray(y, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(y - ref).max() / max(np.abs(ref).max(), 1e-30))


def cuda_timer(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median ms of ``fn`` over ``iters`` runs, each bracketed by CUDA
    events, after ``warmup`` runs."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def kernel_args(st, multi: bool):
    """(kernel name, CUDA wrapper, plain version, index tensors) of a
    prepared operand."""
    from repro_torch.kernels.bsr_spmv import kernel as K
    from repro_torch.kernels.bsr_spmv import ref as R
    a = st.arrays
    if st.layout == "ell":
        idx = (a["block_indices"], a["block_cols"])
        return (("bsr_spmm_ell", K.bsr_spmm_cuda, R.ref_bsr_spmm, idx)
                if multi else
                ("bsr_spmv_ell", K.bsr_spmv_cuda, R.ref_bsr_spmv, idx))
    idx = (a["cell_block"], a["cell_col"], a["cell_ptr"], a["row_perm"])
    return (("bsr_spmm_sell", K.bsr_spmm_sell_cuda, R.ref_bsr_spmm_sell_perm,
             idx) if multi else
            ("bsr_spmv_sell", K.bsr_spmv_sell_cuda, R.ref_bsr_spmv_sell_perm,
             idx))


def bound(st, multi: bool, k: int):
    """(bound_ms, bound_by, bytes, flops) of one launch on these inputs:
    each index array, each referenced block (the real ones and the shared
    zero block; bucket-pad blocks are never read), the blocked x and y once;
    2*bs*bs*k operations per slot that holds a real block."""
    bs = st.block_size
    zero = st._zero_idx
    blocks_bytes = (zero + 1) * bs * bs * 4
    if st.layout == "ell":
        idx = st.arrays["block_indices"]
        index_bytes = 2 * idx.numel() * 4
        n_real = int((idx != zero).sum())
        n_br = idx.shape[0]
    else:
        cb = st.arrays["cell_block"]
        index_bytes = 4 * (2 * cb.numel() + st.arrays["cell_ptr"].numel()
                           + st.arrays["row_perm"].numel())
        n_real = int((cb != zero).sum())
        n_br = st.arrays["row_perm"].shape[0]
    n_bc = -(-st.meta.shape[1] // bs)
    kk = k if multi else 1
    nbytes = blocks_bytes + index_bytes + 4 * kk * bs * (n_bc + n_br)
    flops = 2.0 * n_real * bs * bs * kk
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes, flops)


def run(device: str, spatial_n: int, zipf_n: int, bucket_ns, seed: int,
        timer) -> dict:
    """All phases on ``device``; returns the ``kernels`` record."""
    import torch
    from repro_torch.core import (Schedule, gen_spatial, gen_zipf,
                                  spmm_oracle, spmv_oracle)
    from repro_torch.kernels.bsr_spmv import kernel as K
    from repro_torch.sparse import (PreparedStore, content_key, launch_count,
                                    plan, plan_bucket, reset_counters)

    rng = np.random.default_rng(seed)
    t0 = time.monotonic()
    inputs = []
    for name, gen, n, bs in (("spatial", gen_spatial, spatial_n, 32),
                             ("zipf", gen_zipf, zipf_n, 128)):
        A = gen(n, seed=seed)
        x = rng.standard_normal(A.shape[1]).astype(np.float32)
        X = rng.standard_normal((A.shape[1], K_RHS)).astype(np.float32)
        inputs.append({"name": f"{name}_{n}_bs{bs}", "A": A, "bs": bs,
                       "x": x, "X": X, "y_ref": spmv_oracle(A, x),
                       "Y_ref": spmm_oracle(A, X)})
        log(f"input {name} n={n}: nnz={A.nnz} "
            f"({time.monotonic() - t0:.1f}s)")
    members = [gen_zipf(n, seed=i) for i, n in enumerate(bucket_ns)]
    mxs = [rng.standard_normal(m.shape[1]).astype(np.float32)
           for m in members]
    m_refs = [spmv_oracle(m, x) for m, x in zip(members, mxs)]
    pure = members[0]
    pure_xs = [rng.standard_normal(pure.shape[1]).astype(np.float32)
               for _ in range(4)]
    pure_refs = [spmv_oracle(pure, x) for x in pure_xs]
    member_keys = [content_key(m) for m in members]
    log(f"host inputs and oracles ready ({time.monotonic() - t0:.1f}s)")

    def sched(layout, bs):
        return (Schedule("bsr", bs, 1.0, layout="sell", slice_height=8)
                if layout == "sell" else Schedule("bsr", bs, 1.0))

    # ---------------------------------------------------------- main path
    store = PreparedStore(byte_budget=16 << 30)
    prepared = {}
    K.reset_launch_counts()
    reset_counters()
    t_main = time.monotonic()
    for inp in inputs:
        for layout in ("ell", "sell"):
            s = sched(layout, inp["bs"])
            pv = plan("spmv", (inp["A"],), schedule=s, store=store,
                      device=device)
            y = pv.execute(inp["x"]).cpu().numpy()
            pm = plan("spmm", (inp["A"],), schedule=s, store=store,
                      device=device)
            Y = pm.execute(inp["X"]).cpu().numpy()
            e_v, e_m = rel_err(y, inp["y_ref"]), rel_err(Y, inp["Y_ref"])
            log(f"plan {inp['name']} {layout}: spmv rel_err={e_v:.3e} "
                f"({pv.last_measured_s * 1e3:.3f} ms) spmm rel_err="
                f"{e_m:.3e} ({pm.last_measured_s * 1e3:.3f} ms)")
            check(y.shape == inp["y_ref"].shape and np.isfinite(y).all()
                  and e_v <= TOL, f"plan spmv {inp['name']} {layout}")
            check(Y.shape == inp["Y_ref"].shape and np.isfinite(Y).all()
                  and e_m <= TOL, f"plan spmm {inp['name']} {layout}")
            prepared[(inp["name"], layout)] = pv.operands[0]
    zipf_sell = sched("sell", 128)
    before = (launch_count("spmv"), K.LAUNCHES["bsr_spmv_sell"])
    bucket = plan_bucket("spmv", members, zipf_sell, store=store,
                         device=device, member_keys=member_keys)
    ys = bucket.execute(mxs)
    after = (launch_count("spmv"), K.LAUNCHES["bsr_spmv_sell"])
    log(f"bucket of {len(members)} distinct members: launch_count(spmv) "
        f"{before[0]} -> {after[0]}, bsr_spmv_sell launches "
        f"{before[1]} -> {after[1]}")
    check(after[0] - before[0] == 1 and after[1] - before[1] == 1,
          "a bucket of distinct members is exactly one launch")
    for i, (y, ref) in enumerate(zip(ys, m_refs)):
        e = rel_err(y.cpu().numpy(), ref)
        check(e <= TOL, f"bucket member {i} rel_err {e:.3e}")
    before = (launch_count("spmv"), K.LAUNCHES["bsr_spmm_sell"])
    pure_plan = plan_bucket("spmv", [pure] * 4, zipf_sell, store=store,
                            device=device, member_keys=[member_keys[0]] * 4)
    ys = pure_plan.execute(pure_xs)
    after = (launch_count("spmv"), K.LAUNCHES["bsr_spmm_sell"])
    log(f"content-pure bucket of 4: launch_count(spmv) {before[0]} -> "
        f"{after[0]}, bsr_spmm_sell launches {before[1]} -> {after[1]}")
    check(after[0] - before[0] == 1 and after[1] - before[1] == 1,
          "a content-pure bucket is exactly one multi-RHS launch")
    for i, (y, ref) in enumerate(zip(ys, pure_refs)):
        e = rel_err(y.cpu().numpy(), ref)
        check(e <= TOL, f"content-pure member {i} rel_err {e:.3e}")
    main_launches = dict(K.LAUNCHES)
    log(f"main path {time.monotonic() - t_main:.1f}s, kernel launches "
        f"{main_launches}, store {store.telemetry()['bytes_in_use']:.0f} B")
    for name, n in main_launches.items():
        check(n > 0, f"kernel {name} launched on the main path")

    # ------------------------------------------------ kernels one by one
    results = {}
    for inp in inputs:
        A = inp["A"]
        csr = torch.sparse_csr_tensor(
            torch.as_tensor(A.row_ptrs.astype(np.int64), device=device),
            torch.as_tensor(A.col_idxs.astype(np.int64), device=device),
            torch.as_tensor(A.nnz_vals, device=device), size=A.shape,
            check_invariants=True)
        for layout in ("ell", "sell"):
            st = prepared[(inp["name"], layout)]
            bs = st.block_size
            n_bc = -(-st.meta.shape[1] // bs)
            for multi in (False, True):
                name, cuda_fn, plain_fn, idx = kernel_args(st, multi)
                xh = inp["X"] if multi else inp["x"]
                ref = inp["Y_ref"] if multi else inp["y_ref"]
                xt = torch.as_tensor(xh, device=device)
                xb = torch.zeros((n_bc * bs,) + xh.shape[1:],
                                 dtype=torch.float32, device=device)
                xb[: xh.shape[0]] = xt
                xb = xb.reshape((n_bc, bs) + xh.shape[1:])
                blocks = st.arrays["blocks"]
                y_k = cuda_fn(*idx, blocks, xb)
                y_p = plain_fn(*idx, blocks, xb)
                if device == "cuda":
                    torch.cuda.synchronize()
                rows = A.shape[0]
                yk = y_k.reshape(-1, *xh.shape[1:])[:rows].cpu().numpy()
                yp = y_p.reshape(-1, *xh.shape[1:])[:rows].cpu().numpy()
                e_kp, e_ko, e_po = (rel_err(yk, yp), rel_err(yk, ref),
                                    rel_err(yp, ref))
                check(np.isfinite(yk).all() and e_kp <= TOL and e_ko <= TOL
                      and e_po <= TOL,
                      f"{name} on {inp['name']}: kernel vs plain {e_kp:.3e},"
                      f" kernel vs oracle {e_ko:.3e}, plain vs oracle "
                      f"{e_po:.3e}")
                ms = timer(lambda: cuda_fn(*idx, blocks, xb))
                plain_ms = timer(lambda: plain_fn(*idx, blocks, xb),
                                 iters=5, warmup=1)
                rhs = xt if multi else xt.unsqueeze(1)
                lib_ms = timer(lambda: csr @ rhs)
                b_ms, b_by, nbytes, flops = bound(st, multi, K_RHS)
                rec = {"kernel": name, "input": inp["name"],
                       "max_abs_err": float(np.abs(yk - yp).max()),
                       "rel_err_vs_plain": e_kp, "rel_err_vs_oracle": e_ko,
                       "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                       "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
                       "flops": flops, "share_of_bound": b_ms / ms}
                print(json.dumps(rec), flush=True)
                results.setdefault(name, []).append(rec)
    kernels = []
    for name, recs in results.items():
        head = recs[0]          # gen_spatial: the largest input
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": TPU_KERNELS[name],
            "launches": main_launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "input": head["input"]})
    return {"kernels": kernels}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; this smoke runs only on the card")
        return 2
    # plain versions run on the card here: keep their matmuls in full fp32,
    # as the reference accumulates (TF32 would miss its tolerance)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    from repro_torch.kernels import _build
    t0 = time.monotonic()
    _build.load("bsr_spmv")
    log(f"built bsr_spmv.cu in {time.monotonic() - t0:.1f}s")
    record = run("cuda", spatial_n=524288, zipf_n=8192,
                 bucket_ns=(8192, 7168, 6144, 5120), seed=0,
                 timer=cuda_timer)
    print(json.dumps(record), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
