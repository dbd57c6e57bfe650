#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: drives the plan/execute paths of
spmv/spmm, spgemm and spadd on one NVIDIA GPU at full matrix size, the
tree-driven ``SelectorService`` on SpMV and SpMM requests, the
continuous-batching ``ServingEngine`` under Zipf trace replays (with its
journal, checkpoints and crash restarts), and the MoE decode loop, an MoE prefill and prefill attention at mixtral-8x22b width,
all under the guard (``GuardedExecutor``), and holds every kernel against
its plain PyTorch version (and the sparse ones against a float64 CSR
oracle).

    python3 chip_smoke.py            # needs one CUDA card; ~7-8 min

Phases (any failure exits nonzero; nothing is caught and passed over):
  1. build the five CUDA sources of ``src/repro_torch/csrc`` (one nvcc per
     source, all started together, sm_90a) and print each build time, the
     card's name and power limit, and each kernel's registers, stack and
     local memory (where spills go) and static shared memory as
     ``cuobjdump -res-usage`` reads them from the built libraries;
  2. matvec main path: ``plan("spmv"|"spmm")`` over ELL and SELL on
     ``gen_spatial(524288)`` (bs=32) and ``gen_zipf(8192)`` (bs=128)
     through a ``PreparedStore``, then ``plan_bucket("spmv")`` over four
     distinct ``gen_zipf`` members in each layout (one launch each) and
     over four requests on one matrix (one multi-RHS launch); each plan
     executes twice and prints a ``{"plan": "spmv"|"spmm", "input",
     "layout", "ms_first", "ms"}`` line; each output within
     ``1e-4 * max|y_ref|`` of the float64 oracle (fp32 sums of up to 8,192
     products, taken in another order); then the guard's cost: the
     spatial ELL spmv plan built under ``GuardedExecutor(nan_guard=False)``
     and under ``nan_guard=True``, warm ``last_measured_s`` of each in
     turns (off, on, on, off), one ``{"guard_cost": ...}`` line (spgemm's
     spatial pairs plan gets the same in phase 3);
  2b. selector phase, ``{"selector": ...}`` lines: ``ScheduleTuner("spmv",
     H100_SXM)`` and its ``n_rhs=8`` twin fit (and timed) on the serve
     CLI's default corpus; one ``SelectorService`` each
     (``confidence_threshold=0``: the tree serves, as the verify sweep
     densifies every candidate on the host; a ``ScheduleCache``; a
     ``PreparedStore`` that holds the picked operand) serves two ticks of
     ``process_pending(backend="auto")`` over ``gen_spatial(SERVE_N)`` and
     the four zipf members (dense shortcut: ``torch.matmul``), each with
     its x (k = 1) or X (k = 8); every output within ``1e-4 * max|ref|`` of
     the float64 oracle, tick 2 all cache hits and no store miss (no host
     prep), and the picked layouts' SpMV/SpMM kernels launched (counts
     zeroed before the phase); each decision's source, schedule,
     confidence, modeled and measured ms and residual, the service
     telemetry and peak memory are printed, and each picked kernel gets a
     row (as in phase 7) on the service's own prepared operand, taken from
     its store with no host prep; then the tree's picks for
     ``gen_spatial(131072)`` and ``gen_spatial(524288)`` with the block
     bytes they imply (from block counts, ``"served": false``);
  2c. engine phase, ``{"engine": ...}`` lines: ``ScheduleTuner("spmv",
     H100_SXM)`` fit on the serve CLI's corpus; ``ServingEngine``s over
     ``SelectorService(confidence_threshold=0, device="cuda")`` (the tree
     serves: the verify sweep would build every candidate's BSR on the
     host, which cannot run at this scale) and ONE ``PreparedStore`` (48
     GiB budget) shared by every engine of the phase, so host prep is paid
     once; tenants ``tenant_population(8, 16384..65536, seed=500)`` (the
     serve CLI's population seed; each tenant's pick, confidence, block
     bytes, first fingerprint and ``content_key`` time printed) with RHS
     ``tenant_rhs(seed=0)``. Each replay warms a fresh engine (drains of
     1, 2, 4 and 8 per tenant, then ``reset_metrics``) and replays
     ``generate_trace(256, qps, 8, a=1.1, seed=0)``: ``sub`` (50 qps) and
     ``sat`` (800 qps) at ``slot_max=8, slo_ms=25``, ``nobatch`` (800 qps,
     ``batching=False``), ``overload`` (800 qps, ``deadline_ms=40``,
     ``queue_max=128``, the shared store), ``durable`` (50 qps, a
     ``RequestJournal`` and an ``EngineCheckpoint`` under
     ``build/engine_smoke``, ``checkpoint_every=16``); then ``crash``: 128
     requests at 50 qps under ``FaultInjector(0.05, sites=("crash",),
     seed=8)`` and ``run_with_restarts(max_restarts=30)``, then
     ``reconcile`` of its journal. One line per replay holds its
     ``report()`` scorecard, its launches and its worst output error;
     ``sat`` adds its host split (tick time, timed here, against the
     engine's ``drain``, ``launch`` and ``select`` spans). Checks: the
     ledger identities once dry; every executed output within
     ``1e-4 * max|ref|`` of the float64 oracle of the matrix its schedule
     serves (a q < 1 ELL pick drops the blocks past its row cap); every
     completed request executed once; ``multi_request_drains > 0`` at
     ``sat``; ``overload`` sheds or rejects; ``crash`` restarts with the
     journal's ``open == 0``, no duplicate outcome and every fired fault
     recovered; ``bsr_spmv_ell`` and ``bsr_spmm_ell`` launched by the
     replays' drains (counts zeroed before each replay, read after). Then
     the picked kernels' rows (as in phase 7) on the hottest large
     tenant's served operand, from the shared store;
  3. spgemm main path: ``plan("spgemm", (A, A))`` with ``layout="ell"``
     (padded pairs) and ``"sell"`` (flat cells) on ``gen_spatial(65536)``
     (bs=32, C 9.55 GB) and ``gen_zipf(8192)`` (bs=128), then
     ``plan_bucket("spgemm")`` in both layouts over the four zipf members
     squared (one launch each);
  4. spadd main path: ``plan("spadd", (A, B))`` on
     ``gen_spatial(524288, seed=0) + gen_spatial(524288, seed=1)`` (bs=32)
     and ``gen_zipf(8192, seed=0) + gen_zipf(8192, seed=1)`` (bs=128), then
     ``plan_bucket("spadd")`` over four zipf pairs (one launch).
     Phases 3-4 check C on the device, never through a dense C: its block
     structure against the symbolic phase's, and C @ X on 8 random columns
     against ``A @ (B @ X)`` (spgemm) or ``A @ X + B @ X`` (spadd) from the
     float64 oracle, within ``1e-4 * max|ref|``;
  5. moe main path at mixtral-8x22b width (d_model 6144, d_ff 16384, 8
     experts; the 3.22 GB of float32 expert weights made on the card from
     a seeded ``torch.Generator`` and placed there once): 16 ticks of
     ``decode_moe_ticks`` (batch 4, balanced and hot routing in turn, one
     ``ScheduleCache`` and one ``PreparedStore``, ``H100_SXM``), then one
     prefill ``plan("moe_gmm")`` on 4096 tokens routed top-1 with
     p_e proportional to 1/(e+1), its tile from ``moe_tile_schedule``;
     every output within ``1e-4 * max|ref|`` of the plain version; then,
     at the decode (tick 0) and the prefill input, a NaN and +-Inf in the
     weights (of an empty expert where there is one, and of the expert
     with the most tokens) and a value and a NaN in pad rows of x, set in
     place and restored: the kernel's NaN, +Inf and -Inf masks must equal
     the plain version's;
  6. flash main path: ``plan("flash_attention", (), causal=True)`` on
     mixtral's prefill attention (48 q heads, 8 kv heads expanded to 48 by
     the caller, D=128, float32) at B=1, S=4096 and at B=8, S=1024, each
     within ``1e-4 * max|ref|`` of the plain version; then one small
     bfloat16 call against the plain version on float32 inputs at the JAX
     test's 3e-2;
  7. per kernel x input, at the main path's shapes: the kernel against its
     plain version over the whole output (spgemm, moe and flash within
     ``1e-4 * max|plain|``, spadd bit for bit), the kernel's median time
     (CUDA events, after warm-up), the plain version's, one library call
     computing the same function (cuSPARSE ``csr @ x``, ``csr @ csr``,
     ``csr + csr``; on zipf, where cuSPARSE runs out of resources for
     ``csr @ csr`` and C is dense, ``torch.mm`` of the densified fp32
     operands with TF32 off; ``torch.bmm`` over the
     gathered expert weights; ``scaled_dot_product_attention``; yardsticks
     the port never calls; each row names its call)
     and the bound on an H100: the larger of bytes / 3.35 TB/s and fp32
     operations / 67 TFLOP/s, operations counted on real tokens (moe) and
     on the causal half (flash); moe and flash run on the TF32 tensor
     cores, so their operation time is passes x operations / 494.7
     TFLOP/s (3 passes for float32 operands, split TF32), with the fp32
     bound beside it as ``bound_ms_fp32``; the moe rows also give the
     tiles' live rows and the share of rows the kernel computes. Each of
     the four SpMV/SpMM kernels is also
     run with an Inf and then a NaN in ``x_blocks[0]`` (which their pad
     slots and cells read; the operands are shape-bucketed, so the SELL
     bucket-pad cells of the last sorted row are among them) and must give
     NaN in exactly the outputs where its plain (all-slot, all-cell)
     version does.
Each main path zeroes its kernels' launch counts just before it and reads
them just after; every kernel must have launched there. Every plan runs
under the process's default ``GuardedExecutor`` (NaN guard on; on the
card its chain is the CUDA kernel alone, so a fault raises and is never
served by the plain version or the host); after each phase a
``{"guard": {"phase", ...counters, "quarantined"}}`` line prints its
ledger, and any counter above 0 or quarantined combo fails the run. Each
plan line gives its warm time with the guard's check (``ms`` /
``execute_ms``) and, from one more execute with the check off, without it
(``ms_unchecked`` / ``execute_ms_unchecked``), which is what a tree from
before the guard measured. The non-finite checks call the kernel
wrappers directly, outside the guard.
The last lines are the ``kernels`` JSON line, the card line and
``{"ok": true, "device": ...}``.
"""
from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
FP32_FLOP_PER_S = 67e12            # H100 SXM fp32 outside the tensor cores
TF32_FLOP_PER_S = 494.7e12         # H100 SXM dense TF32 tensor cores
TF32_PASSES = 3                    # split TF32: TF32 products per fp32 one
TOL = 1e-4                         # relative to max|ref|
K_RHS = 8
CHUNK_BYTES = 256 << 20            # device-side checks work in chunks
SOURCES = ("bsr_spmv", "bsr_spgemm", "bsr_spadd", "moe_gmm",
           "flash_attention")
KERNEL_SOURCE = {
    "bsr_spmv_ell": "bsr_spmv", "bsr_spmm_ell": "bsr_spmv",
    "bsr_spmv_sell": "bsr_spmv", "bsr_spmm_sell": "bsr_spmv",
    "bsr_spgemm_pairs": "bsr_spgemm", "bsr_spgemm_cells": "bsr_spgemm",
    "bsr_spadd": "bsr_spadd", "moe_gmm": "moe_gmm",
    "flash_attention": "flash_attention",
}
TPU_KERNELS = {                    # kernel -> the Pallas function it replaces
    "bsr_spmv_ell": "src/repro/kernels/bsr_spmv/kernel.py:78",
    "bsr_spmm_ell": "src/repro/kernels/bsr_spmv/kernel.py:112",
    "bsr_spmv_sell": "src/repro/kernels/bsr_spmv/kernel.py:144",
    "bsr_spmm_sell": "src/repro/kernels/bsr_spmv/kernel.py:183",
    "bsr_spgemm_pairs": "src/repro/kernels/bsr_spgemm/kernel.py:96",
    "bsr_spgemm_cells": "src/repro/kernels/bsr_spgemm/kernel.py:44",
    "bsr_spadd": "src/repro/kernels/bsr_spadd/kernel.py:32",
    "moe_gmm": "src/repro/kernels/moe_gmm/kernel.py:41",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:60",
}
# mixtral-8x22b (src/repro/configs/mixtral_8x22b.py), at full width
MOE_DIMS = {"d_model": 6144, "d_ff": 16384, "experts": 8, "batch": 4,
            "ticks": 16, "prefill": 4096}
FLASH_DIMS = {"heads": 48, "kv_heads": 8, "d": 128,
              "inputs": ((1, 4096), (8, 1024))}
BF16_TOL = 3e-2                    # the JAX bf16 attention test's
# the serve CLI's default training corpus (repro_torch.selector.serve)
SELECTOR_CORPUS = {"n_matrices": 18, "n_min": 256, "n_max": 768, "seed": 0}
# the selector phase serves gen_spatial(SERVE_N): at 131072 the tree's
# bs=256 ELL pick is 27.9 GB of blocks (34.4 GB shape-bucketed, held on the
# host and the card once per prepared operand, and copied again into the
# bucket's stack), so 65536 (11.1 GB of blocks) is served and 131072 and
# 524288 are only picked
SERVE_N = 65536
# the engine phase's tenants: the serve CLI's population (seed + 500) at
# 16384-65536 rows, cut from SuiteSparse's 10^5-10^7; the tree picks bs=256
# ELL for all eight, ~19 GB of blocks (at 32768-131072, ~72 GB)
ENGINE_POP = {"n_tenants": 8, "n_min": 16384, "n_max": 65536, "seed": 500}
ENGINE_STORE_BYTES = 48 << 30
ENGINE_REQUESTS = 256
ENGINE_KW = {"slot_max": 8, "slo_ms": 25.0}
ENGINE_REPLAYS = (                 # (label, offered qps, engine settings)
    ("sub", 50.0, ENGINE_KW),
    ("sat", 800.0, ENGINE_KW),
    ("nobatch", 800.0, dict(ENGINE_KW, batching=False)),
    ("overload", 800.0, dict(ENGINE_KW, deadline_ms=40.0, queue_max=128)),
    ("durable", 50.0, dict(ENGINE_KW, checkpoint_every=16)),
)
ENGINE_CRASH = {"qps": 50.0, "n_requests": 128, "rate": 0.05, "seed": 8,
                "max_restarts": 30, "checkpoint_every": 16,
                "backoff_base_s": 1e-5}
ENGINE_DIR = Path(__file__).resolve().parent / "build" / "engine_smoke"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


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


def sync(device: str) -> None:
    import torch
    if device == "cuda":
        torch.cuda.synchronize()


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def memory_line(phase: str, device: str) -> None:
    """Peak device memory of a phase; frees the phase's cached blocks."""
    import torch
    if device != "cuda":
        return
    emit({"phase": phase,
          "max_memory_allocated": torch.cuda.max_memory_allocated()})
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def guard_line(phase: str) -> None:
    """The process guard's ledger after a phase; fails the run on any fall
    or quarantined combo."""
    from repro_torch.sparse import default_executor, default_quarantine
    tel = default_executor().telemetry()
    n_q = len(default_quarantine())
    emit({"guard": {"phase": phase, **tel, "quarantined": n_q}})
    falls = {k: v for k, v in tel.items() if v > 0}
    check(sum(tel.values()) == 0 and n_q == 0,
          f"guard after {phase}: falls {falls}, {n_q} combos quarantined")


def guard_cost(label: str, make_plan, runtime, out_bytes: int) -> None:
    """Warm execute times of one plan built under ``GuardedExecutor
    (nan_guard=False)`` and under ``nan_guard=True``, in turns (off, on,
    on, off), each the second of two executes, as the plan's own
    ``last_measured_s`` reads it; the check reads each output once, so
    its least time is the output's bytes at the HBM rate."""
    from repro_torch.sparse import GuardedExecutor
    execs = {flag: GuardedExecutor(nan_guard=flag) for flag in (False, True)}
    plans = {flag: make_plan(ex) for flag, ex in execs.items()}
    times = {False: [], True: []}
    for flag in (False, True, True, False):
        p = plans[flag]
        for _ in range(2):
            out = p.execute(*runtime)
            del out
        times[flag].append(p.last_measured_s * 1e3)
    for ex in execs.values():
        check(sum(ex.telemetry().values()) == 0 and not len(ex.quarantine),
              f"guard cost {label}: no fall")
    emit({"guard_cost": {"plan": label, "off_ms": times[False],
                         "on_ms": times[True], "check_bytes": out_bytes,
                         "check_bound_ms": out_bytes / HBM_BYTES_PER_S
                         * 1e3}})


def unchecked_ms(p, *runtime) -> float:
    """ms of one more execute of ``p`` with the process guard's NaN check
    off (the plan's own executor is the process default), so a plan line
    can give its time without the check beside its time with it."""
    from repro_torch.sparse import default_executor
    ex = default_executor()
    flag, ex.nan_guard = ex.nan_guard, False
    try:
        p.execute(*runtime)
    finally:
        ex.nan_guard = flag
    return p.last_measured_s * 1e3


def sched(layout: str, bs: int):
    from repro_torch.core import Schedule
    return (Schedule("bsr", bs, 1.0, layout="sell", slice_height=8)
            if layout == "sell" else Schedule("bsr", bs, 1.0))


def library_time(fn, timer, device: str):
    """(ms, error, nnz) of one PyTorch sparse call, the yardstick: (None,
    why, None) when the installed torch cannot run it on this device. A
    call that takes over a second is timed once more instead of five
    times. ``nnz`` is the stored count of a sparse result (else None)."""
    try:
        t0 = time.monotonic()
        out = fn()
        sync(device)
        first_s = time.monotonic() - t0
    except (RuntimeError, NotImplementedError) as e:
        return None, f"{type(e).__name__}: {str(e)[:200]}", None
    nnz = int(out._nnz()) if out.is_sparse_csr or out.is_sparse else None
    del out
    return timer(fn, iters=5 if first_s < 1 else 1, warmup=0), None, nnz


def torch_csr(A, device: str):
    import torch
    return torch.sparse_csr_tensor(
        torch.as_tensor(A.row_ptrs.astype(np.int64), device=device),
        torch.as_tensor(A.col_idxs.astype(np.int64), device=device),
        torch.as_tensor(A.nnz_vals, device=device), size=A.shape,
        check_invariants=True)


# ------------------------------------------------------------ spmv / spmm

def kernel_args(st, multi: bool):
    """(kernel name, CUDA wrapper, plain version, index tensors, count
    keyword) of a prepared operand; the count keyword is the one the
    wrappers alone take (``valid_counts`` / ``cell_valid`` of the
    operand)."""
    from repro_torch.kernels.bsr_spmv import kernel as K
    from repro_torch.kernels.bsr_spmv import ref as R
    a = st.arrays
    if st.layout == "ell":
        idx = (a["block_indices"], a["block_cols"])
        count = {"valid_counts": a["valid_counts"]}
        return (("bsr_spmm_ell", K.bsr_spmm_cuda, R.ref_bsr_spmm, idx, count)
                if multi else
                ("bsr_spmv_ell", K.bsr_spmv_cuda, R.ref_bsr_spmv, idx,
                 count))
    idx = (a["cell_block"], a["cell_col"], a["cell_ptr"], a["row_perm"])
    count = {"cell_valid": a["cell_valid"]}
    return (("bsr_spmm_sell", K.bsr_spmm_sell_cuda, R.ref_bsr_spmm_sell_perm,
             idx, count) if multi else
            ("bsr_spmv_sell", K.bsr_spmv_sell_cuda, R.ref_bsr_spmv_sell_perm,
             idx, count))


def bound(nbytes: float, flops: float, flop_per_s: float = FP32_FLOP_PER_S):
    """(bound_ms, bound_by): the larger of the byte and operation times,
    the operations at ``flop_per_s``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_per_s * 1e3
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def matvec_work(st, multi: bool, k: int):
    """(bytes, flops) of one launch on these inputs: each index array, each
    referenced block (the real ones and the shared zero block; bucket-pad
    blocks are never read), the blocked x and y once; 2*bs*bs*k operations
    per slot that holds a real block."""
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
    return nbytes, 2.0 * n_real * bs * bs * kk


def check_nonfinite_pattern(name: str, cuda_fn, plain_fn, idx, count: dict,
                            blocks, xb, inp_name: str) -> None:
    """With an Inf, then a NaN, in ``x_blocks[0]`` (the column every ELL
    pad slot and SELL pad cell reads), kernel ``name`` (its wrapper called
    with its ``count`` keyword) gives NaN in exactly the outputs where its
    plain all-slot version does, the same infinities, and agrees with it
    on the finite rest."""
    for bad in (float("inf"), float("nan")):
        xbad = xb.clone()
        xbad[0, 0] = bad
        y_k = cuda_fn(*idx, blocks, xbad, **count)
        y_p = plain_fn(*idx, blocks, xbad)
        same_nan = bool((y_k.isnan() == y_p.isnan()).all())
        inf = y_p.isinf()
        same_inf = bool((y_k.isinf() == inf).all()
                        and (y_k[inf] == y_p[inf]).all())
        fin = y_p.isfinite()
        d = float((y_k[fin] - y_p[fin]).abs().max()) if fin.any() else 0.0
        m = float(y_p[fin].abs().max()) if fin.any() else 0.0
        emit({"check": f"{name} non-finite x_blocks[0]",
              "input": inp_name, "x_blocks0": str(bad),
              "nan_outputs": int(y_p.isnan().sum()),
              "inf_outputs": int(inf.sum()), "nan_pattern_equal": same_nan,
              "inf_equal": same_inf, "finite_max_abs_err": d})
        check(same_nan and same_inf and d <= TOL * max(m, 1e-30),
              f"{name} on {inp_name} with {bad} in x_blocks[0]: NaN "
              f"pattern equal {same_nan}, infinities equal {same_inf}, "
              f"finite outputs {d:.3e} apart")


def matvec_plan_line(p, x, inp_name: str, layout: str) -> np.ndarray:
    """Two executes of a spmv/spmm plan (the first launches each kernel
    for the first time), each timed by the plan itself; emits their times
    and returns the second's output on the host."""
    p.execute(x)
    first = p.last_measured_s
    y = p.execute(x).cpu().numpy()
    ms = p.last_measured_s * 1e3
    emit({"plan": p.op, "input": inp_name, "layout": layout,
          "ms_first": first * 1e3, "ms": ms,
          "ms_unchecked": unchecked_ms(p, x)})
    return y


def matvec_row(st, multi: bool, inp_name: str, xh: np.ndarray,
               ref: np.ndarray, csr, timer, device: str) -> dict:
    """One spmv (or, with ``multi``, spmm) kernel x input row on the
    prepared operand ``st``: the kernel against its plain version and the
    float64 oracle ``ref`` over the whole output, the non-finite
    ``x_blocks[0]`` check, the kernel's and the plain version's times, the
    library call ``csr @ x`` and the bound."""
    import torch
    name, cuda_fn, plain_fn, idx, count = kernel_args(st, multi)
    bs = st.block_size
    n_bc = -(-st.meta.shape[1] // bs)
    xt = torch.as_tensor(xh, device=device)
    xb = torch.zeros((n_bc * bs,) + xh.shape[1:], dtype=torch.float32,
                     device=device)
    xb[: xh.shape[0]] = xt
    xb = xb.reshape((n_bc, bs) + xh.shape[1:])
    blocks = st.arrays["blocks"]
    y_k = cuda_fn(*idx, blocks, xb, **count)
    y_p = plain_fn(*idx, blocks, xb)
    sync(device)
    rows = ref.shape[0]
    yk = y_k.reshape(-1, *xh.shape[1:])[:rows].cpu().numpy()
    yp = y_p.reshape(-1, *xh.shape[1:])[:rows].cpu().numpy()
    del y_k, y_p
    e_kp, e_ko, e_po = rel_err(yk, yp), rel_err(yk, ref), rel_err(yp, ref)
    check(np.isfinite(yk).all() and e_kp <= TOL and e_ko <= TOL
          and e_po <= TOL,
          f"{name} on {inp_name}: kernel vs plain {e_kp:.3e}, kernel vs "
          f"oracle {e_ko:.3e}, plain vs oracle {e_po:.3e}")
    check_nonfinite_pattern(name, cuda_fn, plain_fn, idx, count, blocks, xb,
                            inp_name)
    ms = timer(lambda: cuda_fn(*idx, blocks, xb, **count))
    plain_ms = timer(lambda: plain_fn(*idx, blocks, xb), iters=5, warmup=1)
    rhs = xt if multi else xt.unsqueeze(1)
    lib_ms, lib_err, _ = library_time(lambda: csr @ rhs, timer, device)
    nbytes, flops = matvec_work(st, multi, xh.shape[1] if multi else 1)
    b_ms, b_by = bound(nbytes, flops)
    rec = {"kernel": name, "input": inp_name,
           "max_abs_err": float(np.abs(yk - yp).max()),
           "rel_err_vs_plain": e_kp, "rel_err_vs_oracle": e_ko,
           "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "library_error": lib_err, "bound_ms": b_ms, "bound_by": b_by,
           "bytes": nbytes, "flops": flops, "share_of_bound": b_ms / ms}
    emit(rec)
    return rec


def run_matvec(device: str, inputs, members, seed: int, timer) -> dict:
    """The spmv/spmm main path and its four kernels' rows; returns
    {kernel: [records]} and the main-path launch counts."""
    import torch
    from repro_torch.core import spmm_oracle, spmv_oracle
    from repro_torch.kernels.bsr_spmv import kernel as K
    from repro_torch.sparse import (PreparedStore, content_key, launch_count,
                                    plan, plan_bucket, reset_counters)

    rng = np.random.default_rng(seed)
    t0 = time.monotonic()
    for inp in inputs:
        A = inp["A"]
        inp["x"] = rng.standard_normal(A.shape[1]).astype(np.float32)
        inp["X"] = rng.standard_normal((A.shape[1], K_RHS)).astype(
            np.float32)
        inp["y_ref"], inp["Y_ref"] = (spmv_oracle(A, inp["x"]),
                                      spmm_oracle(A, inp["X"]))
    mxs = [rng.standard_normal(m.shape[1]).astype(np.float32)
           for m in members]
    m_refs = [spmv_oracle(m, x) for m, x in zip(members, mxs)]
    pure = members[0]
    pure_xs = [rng.standard_normal(pure.shape[1]).astype(np.float32)
               for _ in range(4)]
    pure_refs = [spmv_oracle(pure, x) for x in pure_xs]
    member_keys = [content_key(m) for m in members]
    log(f"matvec oracles ready ({time.monotonic() - t0:.1f}s)")

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
            y = matvec_plan_line(pv, inp["x"], inp["name"], layout)
            pm = plan("spmm", (inp["A"],), schedule=s, store=store,
                      device=device)
            Y = matvec_plan_line(pm, inp["X"], inp["name"], layout)
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
    for layout in ("ell", "sell"):
        name = f"bsr_spmv_{layout}"
        before = (launch_count("spmv"), K.LAUNCHES[name])
        bucket = plan_bucket("spmv", members, sched(layout, 128),
                             store=store, device=device,
                             member_keys=member_keys)
        ys = bucket.execute(mxs)
        after = (launch_count("spmv"), K.LAUNCHES[name])
        log(f"{layout} bucket of {len(members)} distinct members: "
            f"launch_count(spmv) {before[0]} -> {after[0]}, {name} "
            f"launches {before[1]} -> {after[1]}")
        check(after[0] - before[0] == 1 and after[1] - before[1] == 1,
              f"a {layout} bucket of distinct members is exactly one launch")
        for i, (y, ref) in enumerate(zip(ys, m_refs)):
            e = rel_err(y.cpu().numpy(), ref)
            check(e <= TOL, f"{layout} bucket member {i} rel_err {e:.3e}")
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
    log(f"matvec main path {time.monotonic() - t_main:.1f}s, kernel "
        f"launches {main_launches}")
    for name, n in main_launches.items():
        check(n > 0, f"kernel {name} launched on the main path")
    head = inputs[0]
    guard_cost(f"spmv {head['name']} ell",
               lambda ex: plan("spmv", (head["A"],),
                               schedule=sched("ell", head["bs"]),
                               store=store, device=device, executor=ex),
               (head["x"],), head["A"].shape[0] * 4)

    # ------------------------------------------------ kernels one by one
    results = {}
    for inp in inputs:
        csr = torch_csr(inp["A"], device)
        for layout in ("ell", "sell"):
            st = prepared[(inp["name"], layout)]
            for multi in (False, True):
                rec = matvec_row(st, multi, inp["name"],
                                 inp["X"] if multi else inp["x"],
                                 inp["Y_ref"] if multi else inp["y_ref"],
                                 csr, timer, device)
                results.setdefault(rec["kernel"], []).append(rec)
    return results, main_launches



# ------------------------------------------------------------- selector

def describe(s) -> str:
    if s.backend == "dense":
        return f"dense rhs={s.n_rhs}"
    lay = (f"sell C={s.slice_height}" if s.layout == "sell"
           else f"ell q={s.ell_quantile}")
    return f"{s.backend} bs={s.block_size} {lay} rhs={s.n_rhs}"


def block_bytes(A, bs: int) -> dict:
    """What preparing A at block size ``bs`` would hold, from its block
    counts (nothing is built): the nonempty blocks, their bytes, the bytes
    of the shape-bucketed block array a plan stores (``bucket_edge`` of
    the blocks plus the zero block) and of an ELL pass over every slot
    (block-rows x widest row)."""
    from repro_torch.sparse import bucket_edge
    n_br, n_bc = -(-A.shape[0] // bs), -(-A.shape[1] // bs)
    rows = np.repeat(np.arange(A.shape[0], dtype=np.int64) // bs,
                     A.row_lengths())
    keys = np.unique(rows * n_bc + A.col_idxs.astype(np.int64) // bs)
    per_row = np.bincount(keys // n_bc, minlength=n_br)
    tile = bs * bs * 4
    return {"blocks": int(keys.size), "block_bytes": int(keys.size) * tile,
            "bucketed_block_bytes": bucket_edge(int(keys.size) + 1) * tile,
            "ell_slot_bytes": n_br * int(per_row.max()) * tile}


def run_selector(device: str, serve_n: int, big, members, seed: int,
                 timer) -> dict:
    """The selector phase: two fitted ``ScheduleTuner``s (SpMV and SpMM at
    k = 8, the serve CLI's corpus, the ``H100_SXM`` record), one
    ``SelectorService`` each (the tree serves: ``confidence_threshold=0``;
    a ``ScheduleCache``; a store that holds the picked operand), two ticks
    of ``process_pending(backend="auto")`` over ``gen_spatial(serve_n)``
    and the zipf members, every output against the float64 oracle; tick 2
    from the cache and the store; the picked layouts' kernels launched
    (counted over the ticks only). Each picked kernel's row on the served
    operand, as the store holds it, is returned as {kernel: [record]}.
    Then the tree's picks on the larger inputs ``big`` and the bytes they
    imply, which are not served."""
    import torch
    from repro_torch.core import (H100_SXM, ScheduleTuner, corpus,
                                  gen_spatial, spmm_oracle, spmv_oracle)
    from repro_torch.kernels.bsr_spmv import kernel as K
    from repro_torch.selector import (ScheduleCache, SchedulePredictor,
                                      SelectorService, fingerprint)
    from repro_torch.sparse import PreparedStore, content_key, plan

    train = corpus(**SELECTOR_CORPUS)
    tuners, fit = {}, {}
    for k in (1, K_RHS):
        t0 = time.monotonic()
        tuners[k] = ScheduleTuner("spmv", H100_SXM, n_rhs=k).fit(
            train, max_mats=SELECTOR_CORPUS["n_matrices"])
        fit[k] = {"fit_s": time.monotonic() - t0,
                  "simulations": tuners[k].fit_simulations_}
    emit({"selector": {"tuners": {f"rhs{k}": v for k, v in fit.items()},
                       "corpus": SELECTOR_CORPUS, "platform": "h100_sxm"}})

    spatial = gen_spatial(serve_n, seed=seed)
    reqs = [(f"spatial_{serve_n}", spatial)] + [
        (f"zipf_{m.shape[0]}_seed{i}", m) for i, m in enumerate(members)]
    rng = np.random.default_rng(seed + 5)
    kernels, launches, rows = [], {}, {}
    for k, tuner in tuners.items():
        K.reset_launch_counts()
        xs = {name: rng.standard_normal(
            A.shape[1] if k == 1 else (A.shape[1], k)).astype(np.float32)
            for name, A in reqs}
        oracle = spmv_oracle if k == 1 else spmm_oracle
        refs = {name: oracle(A, xs[name]) for name, A in reqs}
        store = PreparedStore(byte_budget=48 << 30)
        svc = SelectorService(tuner, cache=ScheduleCache(),
                              confidence_threshold=0.0, prepared_store=store,
                              device=device, batch_max=8)
        for tick in (1, 2):
            hits, misses = svc.cache.hits, store.misses
            for name, A in reqs:
                svc.submit(f"t{tick}:{name}", A, xs[name])
            t0 = time.monotonic()
            decs = svc.process_pending(backend="auto")
            tick_s = time.monotonic() - t0
            check(len(decs) == len(reqs), f"selector rhs{k} tick {tick}: "
                  "every request decided")
            for d in decs:
                name = d.name.split(":", 1)[1]
                e = rel_err(d.y, refs[name])
                emit({"selector": {
                    "rhs": k, "tick": tick, "request": name,
                    "source": d.source, "schedule": describe(d.schedule),
                    "confidence": d.confidence, "bucket": d.bucket,
                    "modeled_ms": (d.modeled_time_s * 1e3
                                   if d.modeled_time_s else None),
                    "measured_ms": d.measured_ms, "residual": d.residual,
                    "rel_err": e}})
                check(d.y is not None and d.y.shape == refs[name].shape
                      and np.isfinite(d.y).all() and e <= TOL,
                      f"selector rhs{k} tick {tick} {name}: rel_err "
                      f"{e:.3e}")
            emit({"selector": {"rhs": k, "tick": tick, "tick_s": tick_s,
                               "cache_hits": svc.cache.hits - hits,
                               "store_misses": store.misses - misses}})
            if tick == 2:
                check(svc.cache.hits - hits >= len(reqs)
                      and all(d.source == "cache" for d in decs),
                      f"selector rhs{k}: tick 2 served from the cache")
                check(store.misses == misses,
                      f"selector rhs{k}: tick 2 served from the store "
                      "(no host prep)")
        pick = decs[0].schedule
        check(pick.backend == "bsr", f"selector rhs{k}: the spatial input "
              f"takes a BSR schedule, got {describe(pick)}")
        kernels.append(f"bsr_{'spmv' if k == 1 else 'spmm'}_{pick.layout}")
        for name, n in K.LAUNCHES.items():
            launches[name] = launches.get(name, 0) + n
        emit({"selector": {"rhs": k, "telemetry": svc.telemetry(),
                           "max_memory_allocated":
                           torch.cuda.max_memory_allocated()
                           if device == "cuda" else None}})
        # the picked kernel's row on the operand the service served, from
        # its store (a miss here would be a second host prep)
        name, A = reqs[0]
        misses = store.misses
        p = plan("spmv" if k == 1 else "spmm", (A,), schedule=pick,
                 store=store, device=device, operand_key=content_key(A))
        check(store.misses == misses, f"selector rhs{k}: the kernel row "
              "runs on the served operand")
        rec = matvec_row(p.operands[0], k > 1,
                         f"selector {name} bs{pick.block_size}", xs[name],
                         refs[name], torch_csr(A, device), timer, device)
        rows.setdefault(rec["kernel"], []).append(rec)
        del svc, store, p
        if device == "cuda":
            torch.cuda.empty_cache()
    emit({"selector": {"kernels": kernels, "launches": launches}})
    for name in kernels:
        check(launches[name] > 0, f"selector: {name} launched by the "
              "served picks")

    for n, A in big:
        A = A if A is not None else gen_spatial(n, seed=seed)
        fp = fingerprint(A)
        for k, tuner in tuners.items():
            pred = SchedulePredictor(tuner).predict(fp)
            emit({"selector": {
                "input": f"spatial_{n}", "rhs": k, "served": False,
                "schedule": describe(pred.schedule),
                "confidence": pred.confidence,
                "modeled_ms": pred.tree_time_s * 1e3,
                **(block_bytes(A, pred.schedule.block_size)
                   if pred.schedule.backend == "bsr" else {})}})
    return rows


# --------------------------------------------------------------- engine

def engine_watch(engine, outs: list) -> None:
    """Collect each drained request's (matrix, decision) from the engine's
    service: the engine keeps no outputs. The outputs are checked after
    the replay, so the check's host time stays out of the latencies."""
    inner = engine.service.drain_bucket

    def drain_bucket(members, backend="auto"):
        decs = inner(members, backend=backend)
        outs.extend((req.csr, dec) for (req, _), dec in zip(members, decs))
        return decs

    engine.service.drain_bucket = drain_bucket


def served_matrix(A, schedule):
    """The matrix a schedule serves: A itself, or for an ELL schedule with
    ``ell_quantile < 1`` A without the blocks past each block row's cap
    (``ell_block_cap``: the first ``cap`` blocks of a block row, in column
    order, are kept, as ``ELLBSR.from_bsr`` keeps them), so its float64
    oracle is what the schedule computes."""
    from repro_torch.core import CSR, ell_block_cap
    if schedule.layout != "ell" or schedule.ell_quantile >= 1.0:
        return A
    bs = schedule.block_size
    n_bc = -(-A.shape[1] // bs)
    rows = np.repeat(np.arange(A.shape[0], dtype=np.int64),
                     A.row_lengths())
    key = (rows // bs) * n_bc + A.col_idxs.astype(np.int64) // bs
    uniq, inv = np.unique(key, return_inverse=True)
    brow = uniq // n_bc
    first = np.searchsorted(brow, brow)          # each block row's first
    cap = ell_block_cap(np.bincount(brow), schedule.ell_quantile)
    keep = (np.arange(uniq.size) - first < cap)[inv]
    return CSR.from_coo(rows[keep], A.col_idxs[keep], A.nnz_vals[keep],
                        A.shape)


def engine_outputs(label: str, outs: list, refs, tenant_of) -> float:
    """Every executed output against its tenant's float64 oracle; returns
    the largest error relative to max|ref|."""
    worst = 0.0
    for A, dec in outs:
        ref = refs[tenant_of[id(A)]]
        check(dec.y is not None and dec.y.shape == ref.shape
              and np.isfinite(dec.y).all(), f"engine {label}: {dec.name} "
              "gave a finite output of its tenant's shape")
        worst = max(worst, rel_err(dec.y, ref))
    check(worst <= TOL, f"engine {label}: outputs within {TOL} of max|ref| "
          f"(worst {worst:.3e})")
    return worst


def engine_split(ticks: list, tracer, rep: dict, hash_ms: float) -> dict:
    """The ``sat`` replay's host time split from its tick times (timed
    here) and the engine's trace spans: admission = tick time minus the
    ``drain`` spans; drain host work = ``drain`` minus ``launch`` spans;
    launch = the ``launch`` spans (x upload, kernel, NaN check, sync)."""
    spans = {}
    for ev in tracer.events():
        spans[ev["type"]] = spans.get(ev["type"], 0.0) + ev["dur_us"] / 1e3
    tick_ms = sum(ticks) * 1e3
    return {"ticks": len(ticks), "tick_ms": tick_ms,
            "admission_ms": tick_ms - spans["drain"],
            "select_ms": spans.get("select", 0.0),
            "content_key_ms_est": hash_ms,
            "drain_ms": spans["drain"],
            "drain_host_ms": spans["drain"] - spans["launch"],
            "launch_ms": spans["launch"],
            "prep_ms": spans.get("prep", 0.0),
            "replay_ms": rep["elapsed_s"] * 1e3,
            "outside_ticks_ms": rep["elapsed_s"] * 1e3 - tick_ms,
            "service_rate_qps": rep["completed"] / max(sum(ticks), 1e-9)}


def run_engine(device: str, pop: dict, timer) -> tuple:
    """The engine phase: ``ServingEngine`` over a tree-served
    ``SelectorService`` (``confidence_threshold=0``: the verify sweep would
    build every candidate's BSR on the host, which cannot run at this
    scale), one ``PreparedStore`` shared by every engine of the phase (the
    host prep is paid once), the population ``tenant_population(**pop)``
    and its RHS ``tenant_rhs(seed=0)``. Each replay of ``ENGINE_REPLAYS``
    warms a fresh engine (drains of 1, 2, 4 and 8 per tenant, then
    ``reset_metrics``) and replays ``generate_trace(256, qps, a=1.1,
    seed=0)``; then the crash replay runs under ``run_with_restarts``.
    Launch counts are zeroed just before each replay and read just after.
    Returns the kernel rows on the hottest large tenant's served operand
    and the replays' launches."""
    import torch
    from repro_torch.core import (H100_SXM, ScheduleTuner, corpus,
                                  spmm_oracle, spmv_oracle)
    from repro_torch.kernels.bsr_spmv import kernel as K
    from repro_torch.obs import Tracer, install_tracer
    from repro_torch.selector import (ScheduleCache, SchedulePredictor,
                                      SelectorService, fingerprint)
    from repro_torch.serving import (EngineCheckpoint, RequestJournal,
                                     ServingEngine, generate_trace,
                                     reconcile, replay, run_with_restarts,
                                     tenant_population, tenant_rhs)
    from repro_torch.sparse import (FaultInjector, PreparedStore,
                                    content_key, install_injector, plan)

    t0 = time.monotonic()
    tuner = ScheduleTuner("spmv", H100_SXM).fit(
        corpus(**SELECTOR_CORPUS), max_mats=SELECTOR_CORPUS["n_matrices"])
    fit_s = time.monotonic() - t0
    t0 = time.monotonic()
    population = tenant_population(pop["n_tenants"], n_min=pop["n_min"],
                                   n_max=pop["n_max"], seed=pop["seed"])
    xs = tenant_rhs(population, seed=0)
    tenant_of = {id(A): t for t, (_, A) in enumerate(population)}
    emit({"engine": {"population": pop, "fit_s": fit_s,
                     "population_s": time.monotonic() - t0,
                     "corpus": SELECTOR_CORPUS, "platform": "h100_sxm"}})
    predictor = SchedulePredictor(tuner)
    picks, ck_ms, tenant_bytes = [], [], []
    for name, A in population:
        t0 = time.monotonic()
        fp = fingerprint(A)
        fp_s = time.monotonic() - t0
        hashes = []
        for _ in range(3):
            t0 = time.monotonic()
            content_key(A)
            hashes.append((time.monotonic() - t0) * 1e3)
        ck_ms.append(statistics.median(hashes))
        pred = predictor.predict(fp)
        picks.append(pred.schedule)
        nbytes = (block_bytes(A, pred.schedule.block_size)
                  if pred.schedule.backend == "bsr" else {})
        tenant_bytes.append(nbytes.get("block_bytes", 0))
        emit({"engine": {"tenant": name, "rows": A.shape[0], "nnz": A.nnz,
                         "schedule": describe(pred.schedule),
                         "confidence": pred.confidence,
                         "modeled_ms": pred.tree_time_s * 1e3,
                         "fingerprint_s": fp_s,
                         "content_key_ms": ck_ms[-1], **nbytes}})
    check(all(s.backend == "bsr" for s in picks),
          "engine: every tenant takes a BSR schedule (a kernel serves it)")
    # each output's oracle: the float64 product of the matrix its schedule
    # serves (a q < 1 ELL pick truncates rows past its block cap)
    served = [served_matrix(A, s) for (_, A), s in zip(population, picks)]
    refs = [spmv_oracle(B, x) for B, x in zip(served, xs)]
    emit({"engine": {"truncated_nnz": {
        name: A.nnz - B.nnz for (name, A), B in zip(population, served)}}})

    store = PreparedStore(byte_budget=ENGINE_STORE_BYTES)
    shutil.rmtree(ENGINE_DIR, ignore_errors=True)

    def make(outs, **kw):
        svc = SelectorService(tuner, cache=ScheduleCache(),
                              confidence_threshold=0.0, prepared_store=store,
                              device=device)
        engine = ServingEngine(svc, **kw)
        engine_watch(engine, outs)
        return engine

    def warm(engine) -> float:
        t0 = time.monotonic()
        for reps in (1, 2, 4, 8):
            for t, (name, A) in enumerate(population):
                for j in range(reps):
                    engine.submit(f"warm{reps}.{j}:{name}", A, xs[t],
                                  tenant=t)
            engine.drain_all()
        engine.reset_metrics()
        return time.monotonic() - t0

    launches, reports = {}, {}

    def read_launches(total: dict) -> dict:
        """This replay's launches (counted since the last reset), added
        into ``total``."""
        got = {k: v for k, v in K.LAUNCHES.items() if v}
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
        return got

    n = len(population)
    for label, qps, kw in ENGINE_REPLAYS:
        outs = []
        settings = dict(kw)
        if label == "durable":
            d = ENGINE_DIR / label
            kw = dict(kw, journal=RequestJournal(str(d / "journal")),
                      checkpointer=EngineCheckpoint(str(d)))
        engine = make(outs, **kw)
        warm_s = warm(engine)
        outs.clear()
        trace = generate_trace(ENGINE_REQUESTS, qps, n, a=1.1, seed=0)
        tracer, ticks = None, []
        if label == "sat":
            inner_tick = engine.tick

            def timed_tick(inner_tick=inner_tick):
                t0 = time.perf_counter()
                done = inner_tick()
                ticks.append(time.perf_counter() - t0)
                return done

            engine.tick = timed_tick
            tracer = install_tracer(Tracer())
        K.reset_launch_counts()
        try:
            rep = replay(engine, trace, population, rhs_seed=0)
        finally:
            if tracer is not None:
                install_tracer(None)
        got = read_launches(launches)
        extra = {}
        if label == "durable":
            engine.close()
            led = reconcile(RequestJournal(str(ENGINE_DIR / label
                                               / "journal")).scan())
            check(led["open"] == 0 and led["duplicate_outcomes"] == 0,
                  f"engine durable: journal closes ({led})")
            extra["journal_ledger"] = led
        if tracer is not None:
            hash_ms = sum(ck_ms[tenant_of[id(A)]] for A, _ in outs)
            extra["host_split"] = engine_split(ticks, tracer, rep, hash_ms)
        check(rep["admitted"] == rep["completed"] + rep["shed"]
              and rep["submitted"] == rep["admitted"] + rep["rejected"]
              and rep["submitted"] == ENGINE_REQUESTS
              and rep["queue_depth"] == 0 and rep["slot_backlog"] == 0,
              f"engine {label}: ledger identities once dry ({rep})")
        check(len(outs) + rep["drain_dedups"] == rep["completed"],
              f"engine {label}: every completed request executed once")
        worst = engine_outputs(label, outs, refs, tenant_of)
        emit({"engine": {"replay": label, "qps": qps, "settings": settings,
                         "warm_s": warm_s, "launches": got,
                         "max_rel_err": worst, **extra, **rep}})
        log(f"engine {label}: offered {rep['offered_qps']:.1f} qps, "
            f"achieved {rep['achieved_qps']:.1f} qps, p50/p99 "
            f"{rep['latency_p50_ms']:.2f}/{rep['latency_p99_ms']:.2f} ms, "
            f"mean drain {rep['mean_drain_size']:.2f}, shed "
            f"{rep['shed']:.0f}, rejected {rep['rejected']:.0f}")
        reports[label] = rep
        del engine, outs
    check(reports["sat"]["multi_request_drains"] > 0,
          "engine sat: content-pure slots drained as multi-RHS launches")
    check(reports["overload"]["shed"] + reports["overload"]["rejected"] > 0,
          "engine overload: sheds or rejects")

    # crash replay: killed at seeded crash points, restarted under the
    # supervisor from the newest checkpoint and the journal's open suffix
    cfg = ENGINE_CRASH
    d = ENGINE_DIR / "crash"
    outs = []

    def build():
        return make(outs, slot_max=8, slo_ms=25.0,
                    journal=RequestJournal(str(d / "journal")),
                    checkpointer=EngineCheckpoint(str(d)),
                    checkpoint_every=cfg["checkpoint_every"])

    def resolve(rec):
        t = int(rec.get("tenant", -1))
        return (population[t][1], xs[t]) if 0 <= t < n else None

    trace = generate_trace(cfg["n_requests"], cfg["qps"], n, a=1.1, seed=0)
    K.reset_launch_counts()
    inj = install_injector(FaultInjector(cfg["rate"], sites=("crash",),
                                         seed=cfg["seed"]))
    t0 = time.monotonic()
    try:
        summary = run_with_restarts(
            build, lambda engine, attempt: replay(engine, trace, population,
                                                  rhs_seed=0),
            resolve=resolve, max_restarts=cfg["max_restarts"],
            backoff_base_s=cfg["backoff_base_s"])
    finally:
        install_injector(None)
    crash_s = time.monotonic() - t0
    got = read_launches(launches)
    rep = summary.pop("result")
    led = reconcile(RequestJournal(str(d / "journal")).scan())
    faults = inj.telemetry()
    check(summary["restarts"] >= 1 and led["open"] == 0
          and led["duplicate_outcomes"] == 0
          and led["submitted"] == cfg["n_requests"]
          and faults["fault_fired"] == faults["fault_recovered"],
          f"engine crash: restarted, journal closes exactly once "
          f"({summary}, {led}, {faults})")
    check(rep["admitted"] == rep["completed"] + rep["shed"],
          f"engine crash: last incarnation's ledger ({rep})")
    check(len(outs) == led["completed"],
          f"engine crash: {len(outs)} executions for {led['completed']} "
          "completed requests")
    worst = engine_outputs("crash", outs, refs, tenant_of)
    emit({"engine": {"replay": "crash", "qps": cfg["qps"], "settings": cfg,
                     "replay_s": crash_s, "launches": got,
                     "max_rel_err": worst, "journal_ledger": led,
                     "faults": faults,
                     **{f"recovery_{k}": v for k, v in summary.items()},
                     **rep}})
    log(f"engine crash: {summary['restarts']:.0f} restarts, "
        f"{summary['replayed']:.0f} replayed, mttr "
        f"{summary['mttr_ms']:.1f} ms, {crash_s:.1f}s")
    emit({"engine": {"launches": launches}})
    for name in ("bsr_spmv_ell", "bsr_spmm_ell"):
        check(launches.get(name, 0) > 0,
              f"engine: {name} launched by the engine's drains")

    # the picked kernels' rows on the hottest large tenant's (the hottest
    # with an eighth of the largest's block bytes) served operand, from
    # the shared store (a miss would be a second host prep)
    t = next(i for i, nb in enumerate(tenant_bytes)
             if nb >= max(tenant_bytes) / 8)
    name, A = population[t]
    misses = store.misses
    p = plan("spmv", (A,), schedule=picks[t], store=store, device=device,
             operand_key=content_key(A))
    check(store.misses == misses, "engine: the kernel rows run on the "
          "served operand")
    X = np.random.default_rng(5).standard_normal(
        (A.shape[1], K_RHS)).astype(np.float32)
    csr = torch_csr(A, device)
    rows = {}
    for multi, xh, ref in ((False, xs[t], refs[t]),
                           (True, X, spmm_oracle(served[t], X))):
        rec = matvec_row(p.operands[0], multi,
                         f"engine {name} bs{picks[t].block_size}", xh, ref,
                         csr, timer, device)
        rows.setdefault(rec["kernel"], []).append(rec)
    del p, csr, store
    return rows, launches


# ------------------------------------------------------ spgemm / spadd

def bsr_probe(C, X: np.ndarray, device: str) -> np.ndarray:
    """float64 ``C @ X`` of a "bsr" SparseTensor, on its device, chunked
    over C's blocks (C is never densified)."""
    import torch
    bs = C.block_size
    blocks = C.arrays["blocks"]
    ptrs = C.arrays["block_ptrs"].long()
    cols = C.arrays["block_cols"].long()
    n_br = ptrs.numel() - 1
    rows = torch.repeat_interleave(torch.arange(n_br, device=device),
                                   ptrs.diff())
    n_bc = -(-C.shape[1] // bs)
    xb = torch.zeros((n_bc * bs, X.shape[1]), dtype=torch.float64,
                     device=device)
    xb[: X.shape[0]] = torch.as_tensor(X, dtype=torch.float64, device=device)
    xb = xb.view(n_bc, bs, X.shape[1])
    y = torch.zeros((n_br, bs, X.shape[1]), dtype=torch.float64,
                    device=device)
    step = max(1, CHUNK_BYTES // (bs * bs * 8))
    for c0 in range(0, blocks.shape[0], step):
        prods = torch.bmm(blocks[c0:c0 + step].double(),
                          xb[cols[c0:c0 + step]])
        y.index_add_(0, rows[c0:c0 + step], prods)
    return y.view(n_br * bs, -1)[: C.shape[0]].cpu().numpy()


def check_product(C, structure, X, ref, what: str, device: str) -> float:
    """C's block structure equals the symbolic phase's, its values are
    finite, and C @ X is within TOL of the float64 reference."""
    import torch
    check(C.layout == "bsr" and C.device.type == device, f"{what}: device")
    check(np.array_equal(C.arrays["block_ptrs"].cpu().numpy(),
                         structure["c_ptrs"])
          and np.array_equal(C.arrays["block_cols"].cpu().numpy(),
                             structure["c_cols"])
          and tuple(C.arrays["blocks"].shape) == (
              structure["n_c"], structure["bs"], structure["bs"]),
          f"{what}: structure is the symbolic phase's")
    check(bool(torch.isfinite(C.arrays["blocks"]).all()),
          f"{what}: finite blocks")
    e = rel_err(bsr_probe(C, X, device), ref)
    check(e <= TOL, f"{what}: probe rel_err {e:.3e}")
    return e


def diff_stats(a, b):
    """(max|a - b|, max|b|) over two equal-shape tensors, chunked."""
    fa, fb = a.reshape(-1), b.reshape(-1)
    step = CHUNK_BYTES // 4
    d = m = 0.0
    for i in range(0, fa.numel(), step):
        d = max(d, float((fa[i:i + step] - fb[i:i + step]).abs().max()))
        m = max(m, float(fb[i:i + step].abs().max()))
    return d, m


def pairop_work(prep, mode: str):
    """(bytes, flops, padded_slots) of one launch of a single plan: C
    written once, each real A and B tile read once, the index arrays
    launched; 2*bs^3 operations per REAL pair (spgemm) or one add per
    element (spadd)."""
    bs, n_c = prep["bs"], prep["n_c"]
    tile = bs * bs * 4
    nbytes = (n_c + prep["zero_a"] + prep["zero_b"]) * tile
    padded = None
    if mode == "pairs":
        padded = n_c * int(prep["dev"]["pair_a"].shape[1])
        nbytes += 2 * 4 * padded
        flops = 2.0 * bs ** 3 * prep["n_pairs"]
    elif mode == "cells":
        nbytes += 4 * (2 * prep["dev"]["cell_a"].numel() + n_c + 1)
        flops = 2.0 * bs ** 3 * prep["n_pairs"]
    else:
        nbytes += 2 * 4 * n_c
        flops = float(n_c * bs * bs)
    return nbytes, flops, padded


def pairop_row(name: str, mode: str, inp_name: str, prep, lib, timer,
               device: str) -> dict:
    """One kernel x input row: kernel against plain over all of C, times,
    bound, and the yardstick ``lib`` ((call name, fn))."""
    import torch
    from repro_torch.sparse import ops_builtin
    cuda_fn, plain_fn, _, _ = ops_builtin._PAIROP_FNS[mode]
    args, kw = ops_builtin.pairop_args(prep["dev"], mode, prep["n_c"])
    c_k = cuda_fn(*args, **kw)
    c_p = plain_fn(*args)
    sync(device)
    if mode == "spadd":
        exact = bool(torch.equal(c_k, c_p))
        check(exact, f"{name} on {inp_name}: kernel equals plain bit for bit")
    d, m = diff_stats(c_k, c_p)
    check(d <= TOL * m, f"{name} on {inp_name}: max|C_kernel - C_plain| "
          f"{d:.3e} > {TOL} * {m:.3e}")
    del c_k, c_p
    ms = timer(lambda: cuda_fn(*args, **kw))
    plain_ms = timer(lambda: plain_fn(*args), iters=3, warmup=1)
    lib_ms, lib_err, lib_nnz = library_time(lib[1], timer, device)
    nbytes, flops, padded = pairop_work(prep, mode)
    b_ms, b_by = bound(nbytes, flops)
    rec = {"kernel": name, "input": inp_name, "max_abs_err": d,
           "rel_err_vs_plain": d / max(m, 1e-30), "ms": ms,
           "plain_ms": plain_ms, "library_ms": lib_ms,
           "library_call": lib[0], "library_error": lib_err,
           "library_nnz": lib_nnz,
           "bound_ms": b_ms, "bound_by": b_by,
           "bytes": nbytes, "flops": flops, "share_of_bound": b_ms / ms,
           "n_c": prep["n_c"], "real_pairs": prep.get("n_pairs"),
           "padded_slots": padded}
    emit(rec)
    return rec


def run_plan(op: str, pair, schedule, store, device: str, label: str):
    """plan() + two executes (cold output allocation, then warm), both
    timed by the plan itself; returns (plan, C of the second execute)."""
    from repro_torch.sparse import plan
    t0 = time.monotonic()
    p = plan(op, pair, schedule=schedule, store=store, device=device)
    prep_s = time.monotonic() - t0
    p.execute()
    first = p.last_measured_s
    unchecked = unchecked_ms(p)
    C = p.execute()
    emit({"plan": op, "input": label, "prep_s": prep_s,
          "execute_ms_first": first * 1e3,
          "execute_ms": p.last_measured_s * 1e3,
          "execute_ms_unchecked": unchecked})
    return p, C


def run_spgemm(device: str, gemm_inputs, members, member_keys, seed: int,
               timer) -> tuple:
    """The spgemm main path (both layouts, single plans and buckets) and
    the two spgemm kernels' rows."""
    import torch
    from repro_torch.core import spmm_oracle
    from repro_torch.kernels.bsr_spgemm import kernel as GK
    from repro_torch.sparse import (PreparedStore, launch_count, plan,
                                    plan_bucket, reset_counters)

    rng = np.random.default_rng(seed + 1)
    t0 = time.monotonic()
    for inp in gemm_inputs:
        A = inp["A"]
        inp["X"] = rng.standard_normal((A.shape[1], K_RHS))
        inp["ref"] = spmm_oracle(A, spmm_oracle(A, inp["X"]))
    mX = [rng.standard_normal((m.shape[1], K_RHS)) for m in members]
    m_refs = [spmm_oracle(m, spmm_oracle(m, x)) for m, x in zip(members, mX)]
    log(f"spgemm oracles ready ({time.monotonic() - t0:.1f}s)")

    store = PreparedStore(byte_budget=64 << 30)
    preps = {}
    GK.reset_launch_counts()
    reset_counters()
    t_main = time.monotonic()
    for inp in gemm_inputs:
        for layout in ("ell", "sell"):
            p, C = run_plan("spgemm", (inp["A"], inp["A"]),
                            sched(layout, inp["bs"]), store, device,
                            f"{inp['name']} {layout}")
            prep = p.operands[0]
            e = check_product(C, prep, inp["X"], inp["ref"],
                              f"spgemm {inp['name']} {layout}", device)
            log(f"spgemm {inp['name']} {layout}: n_c={prep['n_c']} "
                f"pairs={prep['n_pairs']} probe rel_err={e:.3e} "
                f"({p.last_measured_s * 1e3:.3f} ms)")
            preps[(inp["name"], layout)] = prep
            del C
    pairs = [(m, m) for m in members]
    keys = [k for k in member_keys for _ in range(2)]
    for layout in ("ell", "sell"):
        name = "bsr_spgemm_cells" if layout == "sell" else "bsr_spgemm_pairs"
        bucket = plan_bucket("spgemm", pairs, sched(layout, 128),
                             store=store, device=device, member_keys=keys)
        before = (launch_count("spgemm"), GK.LAUNCHES[name])
        Cs = bucket.execute()
        after = (launch_count("spgemm"), GK.LAUNCHES[name])
        log(f"spgemm bucket of {len(pairs)} {layout}: launch_count "
            f"{before[0]} -> {after[0]}, {name} {before[1]} -> {after[1]} "
            f"({bucket.last_measured_s * 1e3:.3f} ms)")
        check(after[0] - before[0] == 1 and after[1] - before[1] == 1,
              f"a spgemm bucket ({layout}) is exactly one launch")
        ms = bucket.last_measured_s * 1e3
        for i, (C, st) in enumerate(zip(Cs, bucket.operands[0]["members"])):
            check_product(C, st, mX[i], m_refs[i],
                          f"spgemm bucket {layout} member {i}", device)
        del Cs
        emit({"plan": "spgemm_bucket", "input": f"zipf x{len(pairs)} "
              f"{layout}", "execute_ms": ms,
              "execute_ms_unchecked": unchecked_ms(bucket)})
        del bucket
    main_launches = dict(GK.LAUNCHES)
    log(f"spgemm main path {time.monotonic() - t_main:.1f}s, kernel "
        f"launches {main_launches}")
    for name, n in main_launches.items():
        check(n > 0, f"kernel {name} launched on the main path")
    head = gemm_inputs[0]
    prep = preps[(head["name"], "ell")]
    guard_cost(f"spgemm {head['name']} pairs",
               lambda ex: plan("spgemm", (head["A"], head["A"]),
                               schedule=sched("ell", head["bs"]),
                               store=store, device=device, executor=ex),
               (), prep["n_c"] * prep["bs"] ** 2 * 4)

    results = {}
    for inp in gemm_inputs:
        if inp["library"] == "dense":
            # C is dense and cuSPARSE csr @ csr runs out of resources here:
            # full fp32 (TF32 is off, see main)
            op = torch.as_tensor(inp["A"].to_dense(), dtype=torch.float32,
                                 device=device)
            lib = ("torch.mm of the dense fp32 operands",
                   lambda: torch.mm(op, op))
        else:
            op = torch_csr(inp["A"], device)
            lib = ("cuSPARSE csr @ csr", lambda: op @ op)
        for layout in ("ell", "sell"):
            mode = "cells" if layout == "sell" else "pairs"
            name = f"bsr_spgemm_{mode}"
            results.setdefault(name, []).append(pairop_row(
                name, mode, inp["name"], preps[(inp["name"], layout)],
                lib, timer, device))
        del op, lib
    del preps, store
    return results, main_launches


def run_spadd(device: str, add_inputs, add_pairs, seed: int,
              timer) -> tuple:
    """The spadd main path (single plans and one bucket) and the spadd
    kernel's rows."""
    from repro_torch.core import spmm_oracle
    from repro_torch.kernels.bsr_spadd import kernel as AK
    from repro_torch.sparse import (PreparedStore, content_key, launch_count,
                                    plan_bucket, reset_counters)

    rng = np.random.default_rng(seed + 2)
    t0 = time.monotonic()
    for inp in add_inputs:
        inp["X"] = rng.standard_normal((inp["A"].shape[1], K_RHS))
        inp["ref"] = (spmm_oracle(inp["A"], inp["X"])
                      + spmm_oracle(inp["B"], inp["X"]))
    bX = [rng.standard_normal((a.shape[1], K_RHS)) for a, _ in add_pairs]
    b_refs = [spmm_oracle(a, x) + spmm_oracle(b, x)
              for (a, b), x in zip(add_pairs, bX)]
    keys = [content_key(m) for pair in add_pairs for m in pair]
    log(f"spadd oracles ready ({time.monotonic() - t0:.1f}s)")

    store = PreparedStore(byte_budget=64 << 30)
    preps = {}
    AK.reset_launch_counts()
    reset_counters()
    t_main = time.monotonic()
    for inp in add_inputs:
        p, C = run_plan("spadd", (inp["A"], inp["B"]), sched("ell", inp["bs"]),
                        store, device, inp["name"])
        prep = p.operands[0]
        e = check_product(C, prep, inp["X"], inp["ref"],
                          f"spadd {inp['name']}", device)
        log(f"spadd {inp['name']}: n_c={prep['n_c']} probe rel_err={e:.3e} "
            f"({p.last_measured_s * 1e3:.3f} ms)")
        preps[inp["name"]] = prep
        del C
    bucket = plan_bucket("spadd", add_pairs, sched("ell", 128), store=store,
                         device=device, member_keys=keys)
    before = (launch_count("spadd"), AK.LAUNCHES["bsr_spadd"])
    Ds = bucket.execute()
    after = (launch_count("spadd"), AK.LAUNCHES["bsr_spadd"])
    log(f"spadd bucket of {len(add_pairs)}: launch_count {before[0]} -> "
        f"{after[0]}, bsr_spadd {before[1]} -> {after[1]} "
        f"({bucket.last_measured_s * 1e3:.3f} ms)")
    check(after[0] - before[0] == 1 and after[1] - before[1] == 1,
          "a spadd bucket is exactly one launch")
    ms = bucket.last_measured_s * 1e3
    for i, (D, st) in enumerate(zip(Ds, bucket.operands[0]["members"])):
        check_product(D, st, bX[i], b_refs[i], f"spadd bucket member {i}",
                      device)
    del Ds
    emit({"plan": "spadd_bucket", "input": f"zipf x{len(add_pairs)}",
          "execute_ms": ms, "execute_ms_unchecked": unchecked_ms(bucket)})
    del bucket
    main_launches = dict(AK.LAUNCHES)
    log(f"spadd main path {time.monotonic() - t_main:.1f}s, kernel "
        f"launches {main_launches}")
    check(main_launches["bsr_spadd"] > 0, "bsr_spadd launched on the main "
          "path")

    results = {"bsr_spadd": []}
    for inp in add_inputs:
        ca, cb = torch_csr(inp["A"], device), torch_csr(inp["B"], device)
        results["bsr_spadd"].append(pairop_row(
            "bsr_spadd", "spadd", inp["name"], preps[inp["name"]],
            ("cuSPARSE csr + csr", lambda: ca + cb), timer, device))
        del ca, cb
    del preps, store
    return results, main_launches


# ------------------------------------------------- moe_gmm / flash_attention

def max_diff(a, b):
    """(max|a - b|, max|b|) of two equal-shape tensors."""
    return float((a - b).abs().max()), float(b.abs().max())


def kernel_row(name: str, inp_name: str, cuda_fn, plain_fn, lib_fn, nbytes,
               flops, timer, extra: dict, tc_passes: int = 0) -> dict:
    """One kernel x input row: the kernel against its plain version over
    the whole output, times, yardstick, bound. A kernel on the TF32
    tensor cores (``tc_passes`` TF32 products per fp32 product) is bound by
    ``tc_passes * flops`` at the TF32 peak; its fp32 bound is kept beside
    as ``bound_ms_fp32``."""
    y_k = cuda_fn()
    y_p = plain_fn()
    d, m = max_diff(y_k, y_p)
    check(bool(y_k.isfinite().all()) and d <= TOL * m,
          f"{name} on {inp_name}: max|kernel - plain| {d:.3e} > "
          f"{TOL} * {m:.3e}")
    del y_k, y_p
    ms = timer(cuda_fn)
    plain_ms = timer(plain_fn, iters=5, warmup=1)
    lib_ms = timer(lib_fn, iters=5, warmup=1)
    b_ms, b_by = bound(nbytes, flops)
    if tc_passes:
        extra = {**extra, "bound_ms_fp32": b_ms}
        b_ms, b_by = bound(nbytes, tc_passes * flops, TF32_FLOP_PER_S)
    rec = {"kernel": name, "input": inp_name, "max_abs_err": d,
           "rel_err_vs_plain": d / max(m, 1e-30), "ms": ms,
           "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
           "bound_by": b_by, "bytes": nbytes, "flops": flops,
           "share_of_bound": b_ms / ms, **extra}
    emit(rec)
    return rec


def moe_row(inp_name: str, x, te, w, tile_m: int, n_real: int, device: str,
            timer) -> dict:
    """The grouped-GEMM row at one routed input. Bytes: x, every weight
    matrix of an expert that owns a tile, out and tile_expert once; FLOP
    on the real tokens only (2 * T_real * K * N), never on pad rows; the
    kernel runs float32 products as split TF32 (3 passes) on the tensor
    cores, so the operation bound is TF32's, the fp32 one beside it. The
    row also gives the tiles' live rows (``live_row_ends``, summed) and the
    share of rows the kernel runs as products (``computed_rows``). The
    yardstick is one ``torch.bmm`` over the tiles with their expert weights
    gathered beforehand (outside the timed call)."""
    import torch
    from repro_torch.kernels.moe_gmm import kernel as MK
    from repro_torch.kernels.moe_gmm import ref as MR
    x = torch.as_tensor(x, device=device)
    te = torch.as_tensor(te, device=device)
    m, k = x.shape
    n = w.shape[2]
    n_tiles = m // tile_m
    gathered = w[te.long()]
    xt = x.view(n_tiles, tile_m, k)
    experts = len(np.unique(te.cpu().numpy()))
    nbytes = (m * k + experts * k * n + m * n) * 4 + te.numel() * 4
    live = MR.live_row_ends(te, x, tile_m).tolist()
    rec = kernel_row(
        "moe_gmm", inp_name,
        lambda: MK.moe_gmm_cuda(te, x, w, tile_m=tile_m),
        lambda: MR.ref_gmm(te, x, w, tile_m=tile_m),
        lambda: torch.bmm(xt, gathered), nbytes, 2.0 * n_real * k * n, timer,
        {"tile_m": tile_m, "rows": m, "real_rows": n_real,
         "padded_row_share": 1.0 - n_real / m, "live_rows": sum(live),
         "computed_row_share": MK.computed_rows(live, tile_m) / m},
        tc_passes=TF32_PASSES)
    del gathered
    return rec


def moe_nonfinite_check(inp_name: str, x, te, w, tile_m: int,
                        device: str) -> None:
    """Non-finite operands at full width. In place, and restored before the
    checks: a NaN in the weights of an empty expert (else of the expert
    with the fewest tokens) and a +Inf and a -Inf in those of the expert
    with the most tokens; in a copy of x, a value in a pad row of that
    expert's tile and a NaN in a pad row of another tile. The kernel's
    NaN, +Inf and -Inf masks must equal the plain version's, its finite
    entries lie within ``TOL * max|plain|``."""
    import torch
    from repro_torch.kernels.moe_gmm import kernel as MK
    from repro_torch.kernels.moe_gmm import ref as MR
    x = np.array(x, np.float32)
    te = np.asarray(te)
    n_e, k, n = w.shape
    real = np.abs(x).sum(axis=1) > 0              # the routed tokens' rows
    tile_of_row = np.repeat(te, tile_m)
    per_expert = np.bincount(tile_of_row[real], minlength=n_e)
    e1 = int(np.argmax(per_expert))
    empty = [e for e in range(n_e) if per_expert[e] == 0]
    e0 = empty[0] if empty else min((e for e in range(n_e) if e != e1),
                                    key=lambda e: per_expert[e])

    def pad_rows(e):
        return np.flatnonzero((tile_of_row == e) & ~real)

    check(pad_rows(e1).size > 5, f"moe non-finite {inp_name}: pad rows")
    r_val = int(pad_rows(e1)[5])
    e_nan = next((e for e in empty[1:] + [e0] + list(range(n_e))
                  if e != e1 and pad_rows(e).size > 20), None)
    check(e_nan is not None, f"moe non-finite {inp_name}: a second tile")
    r_nan = int(pad_rows(e_nan)[20])
    # +Inf and -Inf where e1's first token is positive: both signs reach
    # its row
    pos = np.flatnonzero(x[np.flatnonzero(real & (tile_of_row == e1))[0]]
                         > 0)
    k1, k2 = int(pos[len(pos) // 6]), int(pos[2 * len(pos) // 3])
    x[r_val, 3] = 1.5
    x[r_nan, 8] = np.nan
    spots = [(e0, 5, 7, float("nan")), (e1, k1, 300 % n, float("inf")),
             (e1, k2, 9000 % n, float("-inf"))]
    saved = [w[e, kk, nn].clone() for e, kk, nn, _ in spots]
    for e, kk, nn, v in spots:
        w[e, kk, nn] = v
    xd, ted = (torch.as_tensor(a, device=device) for a in (x, te))
    out = MK.moe_gmm_cuda(ted, xd, w, tile_m=tile_m)
    plain = MR.ref_gmm(ted, xd, w, tile_m=tile_m)
    live = MR.live_row_ends(ted, xd, tile_m).tolist()
    sync(device)
    for (e, kk, nn, _), old in zip(spots, saved):
        w[e, kk, nn] = old
    masks = {name: (int(fn(plain).sum()),
                    bool(torch.equal(fn(out), fn(plain))))
             for name, fn in (("nan", torch.isnan), ("posinf", torch.isposinf),
                              ("neginf", torch.isneginf))}
    fin = plain.isfinite()
    d, m = max_diff(out[fin], plain[fin])
    emit({"check": "moe_gmm non-finite w and pad rows", "input": inp_name,
          "nan_expert": e0, "nan_expert_empty": bool(empty),
          "inf_expert": e1, "nan_pad_row_tile_live_rows":
          live[r_nan // tile_m], "masks": masks,
          "rel_err_finite": d / max(m, 1e-30)})
    check(all(same for _, same in masks.values()) and d <= TOL * m,
          f"moe non-finite {inp_name}: masks {masks}, {d:.3e} > {TOL} * "
          f"{m:.3e}")
    check(all(count > 0 for count, _ in masks.values()),
          f"moe non-finite {inp_name}: NaN, +Inf and -Inf all reach the "
          "output")


def run_moe(device: str, dims: dict, seed: int, timer) -> tuple:
    """The moe main path (the decode loop, then one prefill plan) and the
    grouped GEMM's rows at the decode and prefill inputs."""
    import torch
    from repro_torch.core import H100_SXM
    from repro_torch.kernels.moe_gmm import kernel as MK
    from repro_torch.kernels.moe_gmm import ref as MR
    from repro_torch.selector import ScheduleCache
    from repro_torch.serving import decode_moe_ticks
    from repro_torch.sparse import (PreparedStore, launch_count,
                                    moe_tile_schedule, plan, reset_counters,
                                    route_and_pad)

    e, d_model, d_ff = dims["experts"], dims["d_model"], dims["d_ff"]
    n_ticks, n_pre = dims["ticks"], dims["prefill"]
    gen = torch.Generator(device=device).manual_seed(seed + 3)
    w = torch.randn((e, d_model, d_ff), generator=gen, device=device)
    rng = np.random.default_rng(seed + 3)
    p_e = 1.0 / np.arange(1, e + 1)
    eot = rng.choice(e, size=n_pre, p=p_e / p_e.sum())
    tokens = rng.standard_normal((n_pre, d_model)).astype(np.float32)
    sync(device)
    log(f"moe inputs ready: w {tuple(w.shape)} ({w.numel() * 4 / 1e9:.2f} "
        f"GB) on {w.device}")

    cache, store = ScheduleCache(), PreparedStore()
    MK.reset_launch_counts()
    reset_counters()
    t_main = time.monotonic()
    dec = decode_moe_ticks(n_ticks, d_model=d_model, d_ff=d_ff, n_experts=e,
                           batch=dims["batch"], cache=cache, store=store,
                           seed=seed, platform=H100_SXM, device=device, w=w)
    decode_s = time.monotonic() - t_main
    check(launch_count("moe_gmm") == n_ticks
          and MK.LAUNCHES["moe_gmm"] == n_ticks,
          f"moe decode: {n_ticks} ticks are {n_ticks} launches (plan "
          f"{launch_count('moe_gmm')}, kernel {MK.LAUNCHES['moe_gmm']})")
    sched = moe_tile_schedule(np.bincount(eot, minlength=e), d_model,
                              H100_SXM, cache=cache)
    x_pre, te_pre, _ = route_and_pad(tokens, eot, e, tile_m=sched.block_size)
    pre_plan = plan("moe_gmm", (te_pre,), schedule=sched, store=store,
                    device=device)
    out_pre = pre_plan.execute(x_pre, w)
    main_launches = dict(MK.LAUNCHES)
    log(f"moe main path {time.monotonic() - t_main:.1f}s, kernel launches "
        f"{main_launches}")
    check(main_launches["moe_gmm"] == n_ticks + 1, "moe_gmm launched on "
          "every tick and the prefill")

    errs = []
    for (x, te), (tm, _), out in zip(dec["routed"], dec["ticks"],
                                     dec["outputs"]):
        ref = MR.ref_gmm(torch.as_tensor(te, device=device),
                         torch.as_tensor(x, device=device), w, tile_m=tm)
        d, m = max_diff(out, ref)
        check(out.shape == ref.shape and bool(out.isfinite().all())
              and d <= TOL * m, f"moe decode tick: {d:.3e} > {TOL} * {m:.3e}")
        errs.append(d / max(m, 1e-30))
    ref = MR.ref_gmm(torch.as_tensor(te_pre, device=device),
                     torch.as_tensor(x_pre, device=device), w,
                     tile_m=sched.block_size)
    d, m = max_diff(out_pre, ref)
    check(bool(out_pre.isfinite().all()) and d <= TOL * m,
          f"moe prefill: {d:.3e} > {TOL} * {m:.3e}")
    del ref, out_pre
    rows = [tuple(x.shape)[0] for x, _ in dec["routed"]]
    emit({"phase": "moe_decode", "d_model": d_model, "d_ff": d_ff,
          "experts": e, "batch": dims["batch"], "ticks": n_ticks,
          "launches": n_ticks, "tile_m": [tm for tm, _ in dec["ticks"]],
          "rows": rows, "padded_row_share": 1.0 - n_ticks * dims["batch"]
          / sum(rows),
          "cache_hit_rate": dec["cache_hit_rate"],
          "cache_entries": dec["cache_entries"],
          "prep_hit_rate": dec["prep_hit_rate"],
          "prep_entries": dec["prep_entries"],
          "ms_per_tick": decode_s * 1e3 / n_ticks,
          "max_rel_err_vs_plain": max(errs)})
    emit({"phase": "moe_prefill", "tokens": n_pre, "tile_m":
          sched.block_size, "rows": int(x_pre.shape[0]),
          "tokens_per_expert": np.bincount(eot, minlength=e).tolist(),
          "execute_ms": pre_plan.last_measured_s * 1e3,
          "rel_err_vs_plain": d / max(m, 1e-30)})

    # decode rows: the first tick of each tile size (tick 0 first), then
    # the prefill
    first = {}
    for (x, te), (tm, _) in zip(dec["routed"], dec["ticks"]):
        first.setdefault(tm, (x, te))
    del dec
    recs = [moe_row(f"decode_b{dims['batch']}_tm{tm}", x, te, w, tm,
                    dims["batch"], device, timer)
            for tm, (x, te) in first.items()]
    recs.append(moe_row(f"prefill_{n_pre}_tm{sched.block_size}", x_pre,
                        te_pre, w, sched.block_size, n_pre, device, timer))
    tm, (x, te) = next(iter(first.items()))          # tick 0
    moe_nonfinite_check(f"decode_b{dims['batch']}_tm{tm}", x, te, w, tm,
                        device)
    moe_nonfinite_check(f"prefill_{n_pre}_tm{sched.block_size}", x_pre,
                        te_pre, w, sched.block_size, device)
    del w
    return {"moe_gmm": recs}, main_launches


def gqa_inputs(b: int, s: int, dims: dict, gen, device: str):
    """(B*H, S, D) float32 q, k, v: k and v made with ``kv_heads`` heads and
    expanded to ``heads`` by the caller, as the JAX kernel expects."""
    import torch
    h, kvh, d = dims["heads"], dims["kv_heads"], dims["d"]
    q = torch.randn((b, h, s, d), generator=gen, device=device)
    k, v = (torch.randn((b, kvh, s, d), generator=gen, device=device)
            .repeat_interleave(h // kvh, dim=1) for _ in range(2))
    return tuple(t.reshape(b * h, s, d).contiguous() for t in (q, k, v))


def run_flash(device: str, dims: dict, seed: int, timer) -> tuple:
    """The flash main path (causal prefill attention at each input), one
    small bfloat16 check, and the kernel's rows."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import ref as FR
    from repro_torch.sparse import launch_count, plan, reset_counters

    gen = torch.Generator(device=device).manual_seed(seed + 4)
    inputs = [(f"B{b}_S{s}_H{dims['heads']}_D{dims['d']}", b, s,
               gqa_inputs(b, s, dims, gen, device))
              for b, s in dims["inputs"]]
    FK.reset_launch_counts()
    reset_counters()
    t_main = time.monotonic()
    outs = []
    for name, _, _, qkv in inputs:
        p = plan("flash_attention", (), causal=True, device=device)
        outs.append(p.execute(*qkv))
        emit({"plan": "flash_attention", "input": name,
              "execute_ms": p.last_measured_s * 1e3})
    main_launches = dict(FK.LAUNCHES)
    log(f"flash main path {time.monotonic() - t_main:.1f}s, kernel launches "
        f"{main_launches}")
    check(launch_count("flash_attention") == len(inputs)
          and main_launches["flash_attention"] == len(inputs),
          "flash_attention launched once per input")
    for (name, _, _, qkv), out in zip(inputs, outs):
        d, m = max_diff(out, FR.ref_attention(*qkv, causal=True))
        check(bool(out.isfinite().all()) and d <= TOL * m,
              f"flash {name}: {d:.3e} > {TOL} * {m:.3e}")
    del outs

    small = [torch.randn((2, 128, 64), generator=gen, device=device)
             for _ in range(3)]
    half = [t.to(torch.bfloat16) for t in small]
    o16 = FK.flash_attention_cuda(*half, causal=True, block_q=64, block_k=64)
    e_ref = float((o16 - FR.ref_attention(*small)).abs().max())
    d, m = max_diff(o16, FR.ref_attention(*half))
    check(e_ref <= BF16_TOL and d <= TOL * m,
          f"flash bf16: {e_ref:.3e} from the float32 plain version "
          f"(tolerance {BF16_TOL}), {d:.3e} from the plain version on the "
          "same bf16 inputs")
    emit({"phase": "flash_bf16", "max_abs_err_vs_f32": e_ref,
          "max_abs_err_vs_plain": d})

    recs = []
    for name, b, s, (q, k, v) in inputs:
        bh, dd = q.shape[0], q.shape[2]
        q4, k4, v4 = (t.view(b, bh // b, s, dd) for t in (q, k, v))
        recs.append(kernel_row(
            "flash_attention", name,
            lambda: FK.flash_attention_cuda(q, k, v, causal=True),
            lambda: FR.ref_attention(q, k, v, causal=True),
            lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                   is_causal=True),
            4 * bh * s * dd * 4, 4.0 * bh * s * s * dd / 2, timer,
            {"bh": bh, "s": s, "d": dd}, tc_passes=TF32_PASSES))
    return {"flash_attention": recs}, main_launches


def run(device: str, spatial_n: int, zipf_n: int, bucket_ns, gemm_n: int,
        serve_n: int, unserved_ns, engine_pop: dict, seed: int,
        timer) -> dict:
    """All phases on ``device``, each followed by its guard line; returns
    the ``kernels`` record."""
    from repro_torch.core import gen_spatial, gen_zipf
    from repro_torch.sparse import content_key

    t0 = time.monotonic()
    spatial = gen_spatial(spatial_n, seed=seed)
    members = [gen_zipf(n, seed=i) for i, n in enumerate(bucket_ns)]
    zipf = members[0] if bucket_ns[0] == zipf_n else gen_zipf(zipf_n,
                                                                 seed=seed)
    member_keys = [content_key(m) for m in members]
    log(f"inputs generated ({time.monotonic() - t0:.1f}s)")

    results, launches = run_matvec(
        device, [{"name": f"spatial_{spatial_n}_bs32", "A": spatial,
                  "bs": 32},
                 {"name": f"zipf_{zipf_n}_bs128", "A": zipf, "bs": 128}],
        members, seed, timer)
    memory_line("matvec", device)
    guard_line("matvec")

    r = run_selector(device, serve_n,
                     [(n, spatial if n == spatial_n else None)
                      for n in unserved_ns], members, seed, timer)
    for name, recs in r.items():
        results[name] += recs
    memory_line("selector", device)
    guard_line("selector")

    r, l = run_engine(device, engine_pop, timer)
    for name, recs in r.items():
        results[name] += recs
    for name, n in l.items():
        launches[name] += n
    memory_line("engine", device)
    guard_line("engine")

    # each with the library call that computes A @ A on it
    gemm_inputs = [{"name": f"spatial_{gemm_n}_bs32",
                    "A": gen_spatial(gemm_n, seed=seed), "bs": 32,
                    "library": "csr"},
                   {"name": f"zipf_{zipf_n}_bs128", "A": zipf, "bs": 128,
                    "library": "dense"}]
    r, l = run_spgemm(device, gemm_inputs, members, member_keys, seed, timer)
    results.update(r)
    launches.update(l)
    memory_line("spgemm", device)
    guard_line("spgemm")

    add_inputs = [{"name": f"spatial_{spatial_n}_bs32+seed1", "A": spatial,
                   "B": gen_spatial(spatial_n, seed=seed + 1), "bs": 32},
                  {"name": f"zipf_{zipf_n}_bs128+seed1", "A": zipf,
                   "B": gen_zipf(zipf_n, seed=seed + 1), "bs": 128}]
    add_pairs = [(m, gen_zipf(n, seed=100 + i))
                 for i, (m, n) in enumerate(zip(members, bucket_ns))]
    r, l = run_spadd(device, add_inputs, add_pairs, seed, timer)
    results.update(r)
    launches.update(l)
    memory_line("spadd", device)
    guard_line("spadd")

    for phase, fn, dims in (("moe", run_moe, MOE_DIMS),
                            ("flash", run_flash, FLASH_DIMS)):
        r, l = fn(device, dims, seed, timer)
        results.update(r)
        launches.update(l)
        memory_line(phase, device)
        guard_line(phase)

    kernels = []
    for name, recs in results.items():
        # head: gen_spatial, moe decode tick 0, flash B1 S4096; "inputs"
        # gives every row of the kernel, the selector's picks among them
        head = recs[0]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{KERNEL_SOURCE[name]}.cu",
            "replaces": TPU_KERNELS[name],
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "input": head["input"],
            **({"bound_ms_fp32": head["bound_ms_fp32"]}
               if "bound_ms_fp32" in head else {}),
            "inputs": [{k: r[k] for k in (
                "input", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "max_abs_err")} for r in recs]})
    check(sorted(k["name"] for k in kernels) == sorted(TPU_KERNELS),
          "every kernel has a row")
    over = [(r["kernel"], r["input"], r["share_of_bound"])
            for recs in results.values() for r in recs
            if r["share_of_bound"] > 1.0]
    check(not over, f"no kernel beats its bound: {over}")
    return {"kernels": kernels}


def build_all() -> None:
    """One nvcc per source, all started together; prints each build's
    seconds."""
    from repro_torch.kernels import _build

    def timed(name):
        t0 = time.monotonic()
        _build.build(name)
        return time.monotonic() - t0

    with ThreadPoolExecutor(len(SOURCES)) as ex:
        futures = {name: ex.submit(timed, name) for name in SOURCES}
        seconds = {name: f.result() for name, f in futures.items()}
    for name in SOURCES:
        _build.load(name)
    emit({"build_s": seconds})
    emit({"resource_usage": {name: resource_usage(_build.library_path(name))
                             for name in SOURCES}})


def resource_usage(lib: Path):
    """{kernel symbol: {"REG": n, "STACK": n, "SHARED": n, "LOCAL": n}} of
    a built library, as ``cuobjdump -res-usage`` reads it (a STACK or LOCAL
    above 0 holds spilled registers); None where the toolkit has no
    cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    out = subprocess.run([tool, "-res-usage", str(lib)], capture_output=True,
                         text=True, timeout=120).stdout
    usage, fn = {}, None
    for line in out.splitlines():
        line = line.strip()
        if line.startswith("Function "):
            fn = line[len("Function "):].rstrip(":")
        elif fn and line.startswith("REG:"):
            usage[fn] = {k: int(v) for k, v in
                         (f.split(":") for f in line.split()
                          if f.split(":")[-1].isdigit())}
            fn = None
    return usage


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
    build_all()
    t0 = time.monotonic()
    record = run("cuda", spatial_n=524288, zipf_n=8192,
                 bucket_ns=(8192, 7168, 6144, 5120), gemm_n=65536,
                 serve_n=SERVE_N, unserved_ns=(131072, 524288),
                 engine_pop=ENGINE_POP, seed=0, timer=cuda_timer)
    log(f"all phases {time.monotonic() - t0:.1f}s")
    print(json.dumps(record), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
