#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: drives the plan/execute paths of
spmv/spmm, spgemm and spadd on one NVIDIA GPU at full matrix size, the
tree-driven ``SelectorService`` on SpMV and SpMM requests, the
continuous-batching ``ServingEngine`` under Zipf trace replays (with its
journal, checkpoints and crash restarts), the characterization loop and
its calibration report, mutable matrices between solves, sharded SpMV/SpMM
with per-shard selection, the MoE decode loop, an MoE prefill and prefill
attention at mixtral-8x22b width, the LM substrate's serving path
(llama3.2-3b at full size, mixtral-8x22b at full width), its training step
(llama3.2-3b at full size, and data-parallel on a mesh of one) and its ssm,
hybrid, audio and vlm families with their roofline terms, and two dry-run
cells, all under the guard (``GuardedExecutor``), and holds every kernel against
its plain PyTorch version (and the sparse ones against a float64 CSR
oracle).

    python3 chip_smoke.py            # needs one CUDA card; ~14-17 min

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
     (``confidence_threshold=0``: the tree serves inside its corpus, as
     the verify sweep densifies every candidate on the host, and past it,
     ``gen_spatial(SERVE_N)`` among them, the bytes route; a
     ``ScheduleCache``; a ``PreparedStore`` that holds the picked operand)
     serves two ticks of ``process_pending(backend="auto")`` over
     ``gen_spatial(SERVE_N)`` and the four zipf members (dense shortcut:
     ``torch.matmul``), each with its x (k = 1) or X (k = 8); every
     output within ``1e-4 * max|ref|`` of the float64 oracle, tick 2 all
     cache hits and no store miss (no host prep), and the picked layouts'
     SpMV/SpMM kernels launched (counts
     zeroed before the phase); each decision's source, schedule,
     confidence, modeled and measured ms and residual, the service
     telemetry and peak memory are printed, and each picked kernel gets a
     row (as in phase 7) on the service's own prepared operand, taken from
     its store with no host prep; then the tree's picks for
     ``gen_spatial(131072)`` and ``gen_spatial(524288)`` with the block
     bytes they imply (from block counts, ``"served": false``);
  2c. engine phase, ``{"engine": ...}`` lines: ``ScheduleTuner("spmv",
     H100_SXM)`` fit on the serve CLI's corpus; ``ServingEngine``s over
     ``SelectorService(confidence_threshold=0, device="cuda")`` (every
     tenant lies past the corpus, so the bytes route serves; the verify
     sweep would build every candidate's BSR on the host, which cannot
     run at this scale) and ONE ``PreparedStore`` (48 GiB budget) shared
     by every engine of the phase, so host prep is paid once; tenants
     ``tenant_population(8, 16384..65536, seed=500)`` (the serve CLI's
     population seed; each tenant's pick (from a twin service), its
     source, confidence, block bytes, first fingerprint and
     ``content_key`` time printed) with RHS ``tenant_rhs(seed=0)``. Each
     replay warms a fresh engine (drains of 1, 2, 4 and 8 per tenant,
     then ``reset_metrics``) and replays
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
  2d. charloop phase, ``{"charloop": ...}`` and ``{"calibration": ...}``
     lines: the tree step (``build_slice`` and ``characterize_slice(k=5)``
     for spmv, spgemm and spadd on quickstart's corpus under each of
     ``PLATFORMS``, ``A100_SXM``, ``H100_SXM`` and ``L40S``: nine slices,
     each with its CV MAPE and R², top 3 importances and groups; then
     ``compare_platforms`` over the three, algorithm-intrinsic against
     architecture-induced, and the fig17 check: SpADD's median modeled
     GFLOPS H100 >= A100 >= L40S, the records' bandwidth order); then,
     under a ``Tracer``, every engine tenant
     planned at the service's pick of the selector phase's SpMV and SpMM
     tuners (through ``SelectorService(confidence_threshold=0)``; SpMV
     from the engine's shared store, SpMM one tenant at a time), each
     plan executed 10 times and checked against the float64 oracle; the
     trace written to ``build/charloop_smoke/trace.jsonl`` and read back
     by ``repro_torch.obs.report.main``: one calibration line per
     ``op/layout/backend`` group, each group that launched present with
     positive launches and measured and modeled times, and the groups
     holding the H100 card step's launches alone; then, outside the
     trace, the pick step: per record a ``ScheduleTuner("spmv", record)``
     fit on the serve CLI's corpus, every tenant planned at its pick on
     this card through the engine's store (a pick another record made
     before is a store hit), executed 10 times and checked against the
     float64 oracle,
     one line per record with each tenant's pick, its modeled ms under
     that record and its measured ms on this card;
  2e. mutate phase, ``{"mutate": ...}`` lines: ``MutableMatrix(slack=4)``
     over a copy of ``gen_spatial(524288)`` at bs=32 ELL, then SELL, with
     a ``PreparedStore``: 24 value steps of 1% of the nonzeros (set and add
     in turn), each followed by ``plan("spmv", store=store).execute(x)``
     within ``1e-4 * max|ref|`` of the float64 oracle of the mutated CSR
     and no store miss; the steps' median time split into host work
     (``apply_delta`` + ``plan``) and waiting on the card, the position
     lookup alone, against one full rebuild of the same generation; 3
     insert steps (2 block-rows x 2 new blocks, within slack), each
     checked against the oracle with ``valid_counts`` / ``cell_valid``
     equal to the recounted real slots / cells; the layout's kernel row
     on the mutated operand (as in phase 7); a delta past the spare pool
     (an epoch swap); on ELL the ``delta-apply`` and ``slack-overflow``
     faults, ``fired == recovered``. Then a ``DriftMonitor`` on a 128 x
     128 matrix driven toward dense (detections, quarantines, refits) and
     the smallest engine tenant mutated between drains of a
     ``ServingEngine``: every output before the delta matches the old
     oracle, every one after it the new;
  2f. sharded phase, ``{"sharded": ...}`` lines: (a) ``plan_sharded(
     "spmv"|"spmm", (gen_spatial(524288),), n_shards=4)`` at bs=32 in ELL
     and SELL, ``strategy="nnz"`` and ``"rows"``: each execute exactly one
     plan launch and one launch of the layout's member-axis kernel (the
     shards stacked as members), the output within ``1e-4 * max|y_ref|`` of
     the float64 oracle and of the unsharded plan of the same schedule,
     the bounds, shard nnz, Eq. 5 imbalance, the stacked bytes beside the
     unsharded operand's and both warm execute times (``cuda_timer``, x on
     the card); (b) ``plan_sharded("spmv", ..., selector=SelectorService(
     tuner, confidence_threshold=0))`` on ``gen_zipf(8192)`` and the
     engine phase's largest tenant: each shard's tree pick reckoned in
     block bytes before anything is built, then each shard's pick,
     provenance and confidence, ``RowPartition.imbalance()``, the output
     against the oracle of the matrix each shard's schedule serves, and a
     warm re-plan with store hits >= 2 and no miss, every source
     ``selector-cache``; the service's own guard counts no fall; (c) four
     explicit schedules (bs 32 ELL, bs 16 SELL, bs 64 ELL, bs 32 SELL) at
     the spatial size: one plan launch of two ELL and two SELL kernel
     launches, each shard on its own CUDA stream, the wall time of one
     execute beside the sum of the four shards' kernel times;
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
  6b. lm phase, ``{"lm": ...}`` lines: llama3.2-3b at full width and
     depth (3.2 B float32 parameters drawn on the card from a seeded
     ``torch.Generator``) served through ``repro_torch.launch.serve.main``
     (8 requests, batch 4, prompt 512, 32 generated tokens): tok/s,
     prefill ms, decode ms per token, peak memory, and the reference's
     decode-versus-forward property (the last decode step's logits within
     ``3e-2 * max|logits|`` of a prefill over prompt plus generated
     tokens); mixtral-8x22b at full width cut to 2 of its 56 layers, a
     4 x 512 prefill (its cache, ``expert_imbalance`` and
     ``dropped_fraction``) and 16 decode steps; then
     ``repro_torch.examples.serve_lm.main`` on the card (a reduced
     mixtral served, 16 ``decode_moe_ticks``, ``decode_multirhs_ticks``:
     32 SpMV launches against 8 SpMM launches, counted by the kernels);
  6c. train phase, ``{"train": ...}`` lines: llama3.2-3b at full width and
     depth (3.2 B float32 parameters drawn on the card): before the
     optimizer exists, the loss and global grad norm of step 0's batch (4 x
     512 tokens) three ways, the full batch, 2 microbatches and remat
     ``"none"`` against ``"dots_no_batch"``, each within 1e-2 relative of
     the full batch's (bf16 compute); then ``launch.train.main(..., model=)``
     for 6 steps (2 microbatches, ``dots_no_batch``, attention chunk 256,
     warmup 2, lr 3e-4, no checkpoint written: 51 GB): every loss and grad
     norm finite, each step run once with no restart (as in every
     ``launch.train`` run below without ``--simulate-failures``),
     ``step_ms``, ``tok_s``, ``mfu`` (``model_flops`` of the
     4 x 512 train shape over the step time over 989.4 TFLOP/s dense bf16)
     and peak memory; one more step split into its forwards, backwards and
     optimizer (each ended by a synchronize), and the ``device_profile`` of
     one more (busy share, top kernels); then the reference's two failing
     system tests' argvs on the card: a reduced llama3.2-3b loses more than
     0.5 in 40 steps, and a reduced mamba2-780m with ``--simulate-failures``
     (failures at steps 4 and 8) ends at step 12 after 2 restarts, with
     checkpoints every 4 steps (the reference's argv: each restore lands
     on the step that failed) and every 3 (the restores re-run steps 3 and
     6-7), each loss within 1e-5 relative of an uninterrupted run's at its
     step;
  6d. families phase, ``{"families": ...}`` lines: mamba2-780m (full size;
     8 requests of 512 + 32 tokens through ``launch.serve``, then 3 train
     steps of 4 x 512), recurrentgemma-9b (full width, one (rglru, rglru,
     local_attn) group of 12; a 4 x 512 prefill and 16 decode steps, then 2
     train steps of 4 x 512), whisper-large-v3 (full size, 1500 stub
     frames padded to 1536; 4 requests of 64 + 32 tokens through
     ``launch.serve``, then 2 train steps of 4 x 256) and qwen2-vl-72b (full width, 1 of 80
     layers; a 4 x 512 prefill and 16 decode steps): each the decode-
     versus-forward check (the last decode step's logits within
     ``3e-2 * max|logits|`` of a full forward's at that position), finite
     train losses and grad norms, step ms, ``mfu`` and peak memory; for
     mamba2 also one SSD chunk at full size through the reference's
     ``where(tri, exp(li), 0)`` and the port's masked decay: the port's
     values and gradients finite and its values within 1e-4 relative of
     the reference form's;
  6e. roofline records: the lm, train and families lines carry the
     three-term roofline of each timed step: the step's operators counted
     by ``repro_torch.roofline.OpCounter`` on a ``meta`` model of the same
     config and shape (``count_roofline``), on ``H100_SXM``'s rates:
     compute, memory and collective seconds (0 on one card), the
     bottleneck, the useful ratio, the roofline fraction and
     ``measured_over_bound``, the measured step time over the largest term.
     The counts run in a background process that sees no card
     (``start_background``, one thread), started when the spgemm phase
     starts: beside the kernel phases, whose times are CUDA events, and
     before every LM timed window;
  6f. dp phase, a ``{"dp": ...}`` line: ``launch.train --data-parallel 1``
     on the card (an NCCL group of one, ``make_debug_mesh(1, 1)``, the
     logical rules installed, each fp32 gradient reduce-scattered onto its
     FSDP shard, AdamW on the shards) at the train phase's argv for 3
     steps: its losses within 1e-6 of the train phase's first 3, its step
     ms beside that phase's, and the counted bytes of one step's gradient
     reduction (every parameter's fp32 gradient once, the matrices by
     reduce-scatter);
  6g. dryrun phase, ``{"dryrun": ...}`` lines: ``python -m
     repro_torch.launch.dryrun`` for llama3.2-3b ``train_4k`` on 16 x 16
     and on 2 x 16 x 16 (context parallelism, and the gradients'
     all-reduce over the pods) and mixtral-8x22b ``decode_32k`` on 2 x 16
     x 16, each in a background process started with the counts (no card
     visible; their fake process groups of 256 and 512 ranks never meet
     this process's NCCL one), read after the families phase: each cell's
     terms, memory per device, build seconds and collectives; every cell
     ``ok`` with a useful ratio in (0, 1].
Each phase ends with a ``{"phase_s": ...}`` line, its seconds.
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

import gc
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
# the byte budget of every phase's PreparedStore on the 80 GB card
STORE_BYTES = 48 << 30
# the selector phase serves gen_spatial(SERVE_N) (the bytes route's bs=32
# SELL pick); 131072 and 524288 are only picked by the tree, whose bs=256
# ELL pick at 131072 is 27.9 GB of blocks (34.4 GB shape-bucketed)
SERVE_N = 65536
# the engine phase's tenants: the serve CLI's population (seed + 500) at
# 16384-65536 rows, cut from SuiteSparse's 10^5-10^7; past the corpus the
# service picks bs=32 for all eight, 3.35 GB of blocks (the tree picked
# bs=256 ELL, ~19 GB)
ENGINE_POP = {"n_tenants": 8, "n_min": 16384, "n_max": 65536, "seed": 500}
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
# the charloop phase's tree step: quickstart's corpus (45 matrices, 384-1024
# rows, and the 18 synthetic ones) under each of the port's three records,
# 5-fold CV
CHARLOOP_CORPUS = {"n_matrices": 45, "n_min": 384, "n_max": 1024, "seed": 0}
CHARLOOP_EXECUTES = 10
CHARLOOP_DIR = Path(__file__).resolve().parent / "build" / "charloop_smoke"
# the mutate phase: MutableMatrix(slack=4) over the smoke's
# gen_spatial(524288) at bs=32, ELL and SELL; 24 value steps of 1% of the
# nonzeros each (set and add in turn), 3 insert steps of 2 block-rows x 2
# new blocks (12 of the 16 spare blocks), then one delta past the pool
MUTATE_SLACK = 4
MUTATE_STEPS = 24
MUTATE_SHARE = 0.01
MUTATE_INSERT_STEPS = 3
DRIFT_STEPS = 10
# the sharded phase: 4 row shards of the smoke's gen_spatial(524288) at
# bs=32 (ELL and SELL, nnz-balanced and equal-row bounds), per-shard tree
# picks on gen_zipf(8192) and the engine's largest tenant, and four
# explicit schedules at the spatial size
SHARD_COUNT = 4
# the lm phase: llama3.2-3b (src/repro/configs/llama3_2_3b.py) at full
# width and depth, served as 8 requests of 512 + 32 tokens in batches of 4;
# mixtral-8x22b at full width cut to 2 of its 56 layers, a 4 x 512 prefill
# and 16 decode steps
LM_SERVE = {"arch": "llama3.2-3b", "requests": 8, "batch": 4, "prompt": 512,
            "gen": 32, "chunk": 128}
LM_MOE = {"arch": "mixtral-8x22b", "layers": 2, "batch": 4, "prompt": 512,
          "decode": 16, "chunk": 128}
# the train phase: llama3.2-3b at full width and depth (3.2 B float32
# parameters, grads, m and v: 51.4 GB), 6 steps of 4 x 512 tokens in 2
# microbatches; then the reference's two system tests' argvs (reduced)
TRAIN_FULL = {"arch": "llama3.2-3b", "batch": 4, "seq": 512,
              "microbatches": 2, "remat": "dots_no_batch", "chunk": 256,
              "steps": 6, "warmup": 2, "lr": 3e-4}
TRAIN_LOSS = {"arch": "llama3.2-3b", "batch": 8, "seq": 64, "steps": 40,
              "lr": 3e-3, "warmup": 10, "chunk": 32, "remat": "none"}
TRAIN_RESTART = {"arch": "mamba2-780m", "batch": 4, "seq": 64, "steps": 12,
                 "lr": 3e-4, "warmup": 10, "chunk": 32, "remat": "none",
                 "save_every": 4}
TRAIN_AGREE = 1e-2                 # bf16 compute, summed in other orders
TRAIN_REPLAY = 1e-5                # index_add_ backward orders its atomics
# the steps run with failures at 4 and 8, by checkpoint interval: every 4
# restores the step that failed, every 3 re-runs steps 3 and 6-7
TRAIN_RESTART_STEPS = {4: list(range(12)),
                       3: [0, 1, 2, 3, 3, 4, 5, 6, 7, 6, 7, 8, 9, 10, 11]}
TRAIN_DIR = Path(__file__).resolve().parent / "build" / "train_smoke"
BF16_FLOP_PER_S = 989.4e12         # H100 SXM dense bf16 tensor cores
# the families phase: the ssm, hybrid, audio and vlm configs at full width
# (recurrentgemma-9b cut to one (rglru, rglru, local_attn) group,
# qwen2-vl-72b to 1 of 80 layers: 80 would need about 290 GB in float32;
# whisper-large-v3 at full size)
FAMILIES = {
    # at bf16 the decode-versus-forward error grows with depth in both
    # packages: at 48 layers the reference's is 4.71e-2 (the port's
    # 4.08e-2; tools/lm_bf16_depth.py on the CPU), past the 3e-2 that
    # holds at the other configs' depths, so mamba2's bf16 bound is 6e-2;
    # its float32 check holds to 1e-4 like every config's
    "mamba2-780m": {"bf16_tol": 6e-2,
                    "serve": {"requests": 8, "batch": 4, "prompt": 512,
                              "gen": 32, "chunk": 256},
                    "train": {"batch": 4, "seq": 512, "steps": 3,
                              "lr": 3e-4, "warmup": 1, "chunk": 256,
                              "remat": "dots_no_batch"}},
    "recurrentgemma-9b": {"cut": {"n_layers": 3},
                          "serve": {"batch": 4, "prompt": 512, "gen": 17,
                                    "chunk": 256},
                          "train": {"batch": 4, "seq": 512, "steps": 2,
                                    "lr": 3e-4, "warmup": 1, "chunk": 256,
                                    "remat": "dots_no_batch"}},
    # chunk 256: the encoder's 1536 frames in 6 chunks (64-frame chunks
    # make 16 times the chunk steps, each a few host-dispatched kernels);
    # the decoder's 64-token prompt is one chunk either way
    "whisper-large-v3": {"serve": {"requests": 4, "batch": 4, "prompt": 64,
                                   "gen": 32, "chunk": 256},
                         "train": {"batch": 4, "seq": 256, "steps": 2,
                                   "lr": 3e-4, "warmup": 1, "chunk": 256,
                                   "remat": "dots_no_batch"}},
    "qwen2-vl-72b": {"cut": {"n_layers": 1},
                     "serve": {"batch": 4, "prompt": 512, "gen": 17,
                               "chunk": 256}},
}
# the dp phase: launch.train --data-parallel 1 (an NCCL group of one) at
# TRAIN_FULL's argv for 3 steps, its losses against the train phase's
DP_STEPS = 3
DP_AGREE = 1e-6
# the dryrun phase: the dry-run CLI on three full-size cells: llama3.2-3b
# train_4k (context parallelism: its 24 heads do not divide the model
# axis) on both meshes, mixtral-8x22b decode_32k on the pods
DRYRUN_CELLS = (("llama3.2-3b", "train_4k", False),
                ("llama3.2-3b", "train_4k", True),
                ("mixtral-8x22b", "decode_32k", True))
DRYRUN_DIR = Path(__file__).resolve().parent / "build" / "dryrun_smoke"
BACKGROUND_TIMEOUT_S = 900
# the card's name and power limit, printed beside every time of the new
# phases (main sets it; a CPU rehearsal has no card)
CARD = "no card"


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


def peak_reset(device: str) -> None:
    import torch
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()


def peak(device: str):
    """The card's peak allocated bytes since ``peak_reset`` (None off
    the card)."""
    import torch
    return torch.cuda.max_memory_allocated() if device == "cuda" else None


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def memory_line(phase: str, device: str) -> None:
    """Peak device memory of a phase; frees the phase's cached blocks (and
    the tensors its finished objects' reference cycles still hold, such as
    the engine phase's shared store)."""
    import torch
    if device != "cuda":
        return
    emit({"phase": phase,
          "max_memory_allocated": torch.cuda.max_memory_allocated()})
    gc.collect()
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
    from repro_torch.selector.streamed import block_patterns
    from repro_torch.sparse import bucket_edge
    p = block_patterns(A, [bs])[bs]
    tile = bs * bs * 4
    widest = int(p.blocks_per_row.max())
    return {"blocks": p.n_blocks, "block_bytes": p.n_blocks * tile,
            "bucketed_block_bytes": bucket_edge(p.n_blocks + 1) * tile,
            "ell_slot_bytes": p.n_block_rows * widest * tile}


def run_selector(device: str, serve_n: int, big, members, seed: int,
                 timer) -> dict:
    """The selector phase: two fitted ``ScheduleTuner``s (SpMV and SpMM at
    k = 8, the serve CLI's corpus, the ``H100_SXM`` record), one
    ``SelectorService`` each (``confidence_threshold=0``: the tree serves
    inside its corpus, the bytes route past it;
    a ``ScheduleCache``; a store that holds the picked operand), two ticks
    of ``process_pending(backend="auto")`` over ``gen_spatial(serve_n)``
    and the zipf members, every output against the float64 oracle; tick 2
    from the cache and the store; the picked layouts' kernels launched
    (counted over the ticks only). Each picked kernel's row on the served
    operand, as the store holds it, is returned as {kernel: [record]}.
    Then the tree's picks on the larger inputs ``big`` and the bytes they
    imply, which are not served. Returns the rows and the tuners by k."""
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
        store = PreparedStore(byte_budget=STORE_BYTES)
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
    return rows, tuners


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
    """The engine phase: ``ServingEngine`` over a ``SelectorService``
    (``confidence_threshold=0``: past the corpus the bytes route serves;
    the verify sweep would build every candidate's BSR on the host, which
    cannot run at this scale), one ``PreparedStore`` shared by every
    engine of the phase (the host prep is paid once), the population
    ``tenant_population(**pop)`` and its RHS ``tenant_rhs(seed=0)``. Each
    replay of ``ENGINE_REPLAYS`` warms a fresh engine (drains of 1, 2, 4
    and 8 per tenant, then ``reset_metrics``) and replays
    ``generate_trace(256, qps, a=1.1, seed=0)``; then the crash replay runs
    under ``run_with_restarts``.
    Launch counts are zeroed just before each replay and read just after.
    Returns the kernel rows on the hottest large tenant's served operand,
    the replays' launches, and the population with the shared store (the
    charloop phase plans on them)."""
    import torch
    from repro_torch.core import (H100_SXM, ScheduleTuner, corpus,
                                  spmm_oracle, spmv_oracle)
    from repro_torch.kernels.bsr_spmv import kernel as K
    from repro_torch.obs import Tracer, install_tracer
    from repro_torch.selector import (ScheduleCache, SelectorService,
                                      fingerprint)
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
    # the engine's service picks what this twin picks: selection builds
    # nothing (the tree inside the corpus, the bytes route past it)
    twin = SelectorService(tuner, cache=ScheduleCache(),
                           confidence_threshold=0.0, device=device)
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
        dec = twin.select(A, name=name)
        picks.append(dec.schedule)
        nbytes = (block_bytes(A, dec.schedule.block_size)
                  if dec.schedule.backend == "bsr" else {})
        tenant_bytes.append(nbytes.get("block_bytes", 0))
        emit({"engine": {"tenant": name, "rows": A.shape[0], "nnz": A.nnz,
                         "schedule": describe(dec.schedule),
                         "source": dec.source,
                         "confidence": dec.confidence,
                         "modeled_ms": dec.modeled_time_s * 1e3,
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

    store = PreparedStore(byte_budget=STORE_BYTES)
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
    for layout in sorted({s.layout for s in picks}):
        check(launches.get(f"bsr_spmv_{layout}", 0)
              + launches.get(f"bsr_spmm_{layout}", 0) > 0,
              f"engine: the {layout} picks launched by the engine's drains")
    check(launches.get("bsr_spmm_ell", 0) + launches.get("bsr_spmm_sell", 0)
          > 0, "engine: a content-pure bucket launched an SpMM kernel")

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
    del p, csr
    return rows, launches, {"population": population, "store": store}


# ------------------------------------------------------------ charloop

def run_charloop(device: str, tuners: dict, population, store,
                 corpus_kw: dict) -> dict:
    """The charloop phase. Tree step: ``build_slice`` and
    ``characterize_slice(k=5)`` (quickstart's tree settings) for spmv,
    spgemm and spadd over ``corpus(**corpus_kw)`` under each record of
    ``PLATFORMS`` (A100, H100, L40S), each slice's CV scores, top
    importances and groups, then ``compare_platforms`` and the fig17
    check (SpADD's median modeled GFLOPS never lower under a record with
    more bandwidth). Card step, under a ``Tracer``: each tenant of
    ``population`` planned at the service's pick of each fitted tuner in
    ``tuners`` (SpMV at k = 1 through the engine phase's ``store``, which
    holds those picks; SpMM at k = 8 without a store, one tenant at a
    time), each plan executed ``CHARLOOP_EXECUTES`` times against the
    float64 oracle. Report step: the trace written as JSONL, read back by
    ``repro_torch.obs.report.main``, one ``{"calibration": ...}`` line per
    group. Pick step, after the trace: per record a SpMV tuner fit on the
    serve CLI's corpus, each tenant planned at its pick on the card
    through ``store`` (records that pick one schedule share its operand,
    never a cached pick: each has its own ``ScheduleCache``) and checked
    against the oracle. Returns the card and pick steps' launches."""
    from repro_torch.core import (H100_SXM, PLATFORMS, ScheduleTuner,
                                  build_slice, characterize_slice,
                                  compare_platforms, corpus,
                                  grouped_importance)
    from repro_torch.examples.quickstart import TREE_KW
    from repro_torch.kernels.bsr_spmv import kernel as K
    from repro_torch.obs import Tracer, install_tracer
    from repro_torch.obs import report

    t0 = time.monotonic()
    mats = corpus(**corpus_kw)
    results, spadd_gflops = [], {}
    for kern in ("spmv", "spgemm", "spadd"):
        for rec in PLATFORMS.values():
            t1 = time.monotonic()
            data = build_slice(kern, mats, rec)
            build_s = time.monotonic() - t1
            t1 = time.monotonic()
            res = characterize_slice(data, "gflops", k=5, **TREE_KW)
            fit_s = time.monotonic() - t1
            results.append(res)
            if kern == "spadd":
                spadd_gflops[rec.name] = float(np.median(data.y["gflops"]))
            emit({"charloop": {
                "kernel": kern, "platform": res.platform,
                "matrices": len(mats), "features": len(res.feature_names),
                "cv_mape": res.cv["mape"], "cv_r2": res.cv["r2"],
                "top3": res.importances[:3],
                "groups": grouped_importance(res), "build_slice_s": build_s,
                "characterize_s": fit_s}})
            check(np.isfinite(res.cv["mape"]) and np.isfinite(res.cv["r2"])
                  and abs(sum(v for _, v in res.importances) - 1.0) < 1e-6,
                  f"charloop {kern} {rec.name}: finite CV scores, "
                  "importances sum to 1")
    emit({"charloop": {"compare_platforms": compare_platforms(results,
                                                              top=5),
                       "tree_step_s": time.monotonic() - t0}})
    by_bw = sorted(PLATFORMS.values(), key=lambda p: -p.hbm_bw)
    ordered = all(spadd_gflops[a.name] >= spadd_gflops[b.name]
                  for a, b in zip(by_bw, by_bw[1:]))
    emit({"charloop": {"fig17_spadd_median_gflops": spadd_gflops,
                       "bandwidth_order": [p.name for p in by_bw],
                       "higher_bw_wins": ordered}})
    check(ordered, "charloop fig17: SpADD's median modeled GFLOPS never "
          f"lower under more bandwidth ({spadd_gflops})")

    rng = np.random.default_rng(7)
    K.reset_launch_counts()
    tracer = install_tracer(Tracer())
    t0 = time.monotonic()
    try:
        rows = plan_tenants(device, tuners, population, store, rng)
    finally:
        install_tracer(None)
    card_s = time.monotonic() - t0
    groups = {(r["op"], r["layout"], r["backend"]) for r in rows}
    for row in rows:
        emit({"charloop": row})
    launches = {n: v for n, v in K.LAUNCHES.items() if v}
    shutil.rmtree(CHARLOOP_DIR, ignore_errors=True)
    CHARLOOP_DIR.mkdir(parents=True)
    path = CHARLOOP_DIR / "trace.jsonl"
    n_events = tracer.write_jsonl(str(path))
    rep = report.main([str(path), "--json", str(CHARLOOP_DIR
                                                 / "report.json")])
    for key, row in rep.items():
        emit({"calibration": {key: row}})
    emit({"charloop": {"card_step_s": card_s, "trace_events": n_events,
                       "max_rel_err": max(r["rel_err"] for r in rows),
                       "launches": launches,
                       "groups": len(rep)}})
    for op, layout, backend in sorted(groups):
        row = rep.get(f"{op}/{layout}/{backend}")
        check(row is not None and row["launches"] > 0
              and row["measured_gm_ms"] > 0 and row["modeled_gm_ms"] > 0,
              f"charloop: calibration group {op}/{layout}/{backend} "
              f"reported ({row})")
    # the report holds the H100 card step's launches and no other record's
    traced = sum(row["launches"] for row in rep.values())
    check(traced == len(tuners) * len(population) * CHARLOOP_EXECUTES,
          f"charloop: the calibration groups hold the {H100_SXM.name} "
          f"plans alone ({traced} launches)")
    for name in {f"bsr_{op}_{layout}" for op, layout, _ in groups
                 if layout != "dense"}:
        check(launches.get(name, 0) > 0, f"charloop: {name} launched")

    # pick step: each record's tuner picks, each pick run on this card
    K.reset_launch_counts()
    t0 = time.monotonic()
    layouts = set()
    for rec in PLATFORMS.values():
        t1 = time.monotonic()
        tuner = ScheduleTuner("spmv", rec).fit(
            corpus(**SELECTOR_CORPUS), max_mats=SELECTOR_CORPUS["n_matrices"])
        fit_s = time.monotonic() - t1
        rows = plan_tenants(device, {1: tuner}, population, store, rng)
        layouts |= {r["layout"] for r in rows}
        emit({"charloop": {"picks": rec.name, "card": CARD, "fit_s": fit_s,
                           "corpus": SELECTOR_CORPUS, "tenants": rows}})
    picked = {n: v for n, v in K.LAUNCHES.items() if v}
    emit({"charloop": {"pick_step_s": time.monotonic() - t0,
                       "launches": picked}})
    for name in {f"bsr_spmv_{lay}" for lay in layouts if lay != "dense"}:
        check(picked.get(name, 0) > 0, f"charloop picks: {name} launched")
    for name, n in picked.items():
        launches[name] = launches.get(name, 0) + n
    return launches


def plan_tenants(device: str, tuners: dict, population, store,
                 rng) -> list:
    """Each tenant of ``population`` planned at the service's pick of each
    tuner in ``tuners`` (k -> tuner; SpMV at k = 1 through ``store``, SpMM
    at k = 8 without one), executed ``CHARLOOP_EXECUTES`` times and held
    against the float64 oracle of the matrix its schedule serves. Returns
    each plan's record."""
    from repro_torch.core import spmm_oracle, spmv_oracle
    from repro_torch.selector import ScheduleCache, SelectorService
    from repro_torch.sparse import plan

    rows = []
    for k, tuner in sorted(tuners.items()):
        op = "spmv" if k == 1 else "spmm"
        rec_name = tuner.platform.name
        svc = SelectorService(tuner, cache=ScheduleCache(),
                              confidence_threshold=0.0, device=device)
        use = store if k == 1 else None
        for name, A in population:
            x = rng.standard_normal(
                A.shape[1] if k == 1 else (A.shape[1], k)).astype(np.float32)
            misses = use.misses if use is not None else 0
            p = plan(op, (A,), selector=svc, device=device, store=use)
            served = served_matrix(A, p.schedule)
            ref = (spmv_oracle if k == 1 else spmm_oracle)(served, x)
            for _ in range(CHARLOOP_EXECUTES):
                y = p.execute(x)
            y = y.cpu().numpy()
            e = rel_err(y, ref)
            check(y.shape == ref.shape and np.isfinite(y).all()
                  and e <= TOL, f"charloop {op} {rec_name} {name}: "
                  f"rel_err {e:.3e}")
            rows.append({"op": op, "tenant": name,
                         "layout": p.schedule.layout
                         if p.schedule.backend != "dense" else "dense",
                         "backend": p.backend,
                         "schedule": describe(p.schedule),
                         "source": p.source,
                         "modeled_ms": p.modeled_time_s * 1e3,
                         "ms": p.last_measured_s * 1e3, "rel_err": e,
                         "store_miss": (use.misses - misses)
                         if use is not None else None})
            del p
    return rows


# -------------------------------------------------------------- mutate

def copy_csr(A):
    """A CSR of its own: ``MutableMatrix`` writes into its arrays."""
    from repro_torch.core import CSR
    return CSR(A.row_ptrs.copy(), A.col_idxs.copy(), A.nnz_vals.copy(),
               A.shape)


def counts_match(st) -> bool:
    """The counts the CUDA kernels stop at (ELL ``valid_counts``, SELL
    ``cell_valid``) equal the true count of real slots or cells, recounted
    from the index tensors."""
    import torch
    from repro_torch.kernels.bsr_spmv.ops import sell_cell_valid
    a, zero = st.arrays, st._zero_idx
    if st.layout == "ell":
        true = (a["block_indices"] != zero).sum(dim=1).to(torch.int32)
        return bool(torch.equal(true, a["valid_counts"]))
    true = sell_cell_valid(a["cell_block"].cpu().numpy(),
                           a["cell_ptr"].cpu().numpy(), zero)
    return bool(np.array_equal(true, a["cell_valid"].cpu().numpy()))


def new_block_positions(st, A, rng, n_rows: int, per_row: int):
    """(rows, cols) of 3 entries in each of ``per_row`` absent blocks of
    ``n_rows`` distinct block-rows of the mutable operand ``st``."""
    bs = st.block_size
    n_br, n_bc = -(-A.shape[0] // bs), -(-A.shape[1] // bs)
    bmap = st._mut["block_map"]
    rows, cols = [], []
    for br in rng.choice(n_br, size=n_rows, replace=False):
        taken = 0
        while taken < per_row:
            bc = int(rng.integers(n_bc))
            if (int(br), bc) in bmap or any(
                    r // bs == br and c // bs == bc
                    for r, c in zip(rows, cols)):
                continue
            for j in range(3):
                rows.append(int(br) * bs + j)
                cols.append(bc * bs + 2 * j)
            taken += 1
    return np.array(rows), np.array(cols)


def run_mutate(device: str, A0, tuner, population, seed: int,
               timer) -> tuple:
    """The mutate phase over a copy of ``A0`` (the smoke's
    ``gen_spatial``), once at bs=32 ELL and once SELL: ``MutableMatrix(
    slack=MUTATE_SLACK)`` and a ``PreparedStore``; ``MUTATE_STEPS`` value
    steps (``MUTATE_SHARE`` of the nonzeros, set and add in turn), each
    followed by ``plan("spmv", store=store).execute(x)`` against the
    float64 oracle on the mutated host CSR, with no store miss; the steps'
    median time split into host work (``apply_delta`` and ``plan``) and
    waiting on the card (the scatter's tail and the execute), the
    position lookup timed alone, and one full rebuild of the same
    generation timed; ``MUTATE_INSERT_STEPS`` insert steps (2 block-rows x
    2 new blocks each, within slack) checked against the oracle and the
    kernels' counts against the true counts; one delta past the spare
    pool (an epoch swap); on ELL the ``delta-apply`` and
    ``slack-overflow`` faults (``fired == recovered``); each layout's
    kernel row on the mutated operand. Then a ``DriftMonitor`` on a small
    matrix driven toward dense, and an engine tenant mutated between
    drains. Launch counts are zeroed just before and read just after.
    Returns the kernel rows and the launches."""
    import torch
    from repro_torch.core import (H100_SXM, CSR, ScheduleTuner, corpus,
                                  spmv_oracle)
    from repro_torch.kernels.bsr_spmv import kernel as K
    from repro_torch.selector import (DriftMonitor, ScheduleCache,
                                      SelectorService)
    from repro_torch.serving import ServingEngine
    from repro_torch.sparse import (Delta, FaultInjector, MutableMatrix,
                                    PreparedStore, SparseTensor,
                                    install_injector, plan)
    from repro_torch.sparse.mutate import block_lookup

    rng = np.random.default_rng(seed + 23)
    rows_all = np.repeat(np.arange(A0.shape[0], dtype=np.int64),
                         A0.row_lengths())
    x = rng.standard_normal(A0.shape[1]).astype(np.float32)
    k_vals = int(A0.nnz * MUTATE_SHARE)
    results = {}
    K.reset_launch_counts()
    t_phase = time.monotonic()
    for layout in ("ell", "sell"):
        label = f"{layout} spatial_{A0.shape[0]}_bs32"
        A = copy_csr(A0)
        s = sched(layout, 32)
        store = PreparedStore(byte_budget=16 << 30)
        mm = MutableMatrix(A, store=store, slack=MUTATE_SLACK)

        def serve(what: str, p=None):
            p = p or plan("spmv", (A,), schedule=s, store=store,
                          device=device)
            y = p.execute(x).cpu().numpy()
            e = rel_err(y, spmv_oracle(A, x))
            check(y.shape == (A.shape[0],) and np.isfinite(y).all()
                  and e <= TOL, f"mutate {label} {what}: rel_err {e:.3e}")
            return p, e

        t0 = time.monotonic()
        p, e = serve("first build")
        sync(device)
        first_s = time.monotonic() - t0
        st = p.operands[0]
        misses = store.misses
        steps, worst = [], e
        for i in range(MUTATE_STEPS):
            mode = "set" if i % 2 == 0 else "add"
            pick = rng.choice(A0.nnz, size=k_vals, replace=False)
            r, c = rows_all[pick], A0.col_idxs[pick].astype(np.int64)
            v = (rng.standard_normal(k_vals) * (1.0 if mode == "set"
                                                 else 0.1)).astype(np.float32)
            delta = Delta(r, c, v, mode)
            t0 = time.perf_counter()
            mm.apply_delta(delta)
            t1 = time.perf_counter()
            p = plan("spmv", (A,), schedule=s, store=store, device=device)
            t2 = time.perf_counter()
            sync(device)
            t3 = time.perf_counter()
            y = p.execute(x)
            t4 = time.perf_counter()
            t5 = time.perf_counter()
            block_lookup(st._mut["block_map"], r // 32, c // 32)
            lookup_ms = (time.perf_counter() - t5) * 1e3
            steps.append({"apply_ms": (t1 - t0) * 1e3,
                          "plan_ms": (t2 - t1) * 1e3,
                          "host_ms": (t2 - t0) * 1e3,
                          "device_ms": (t3 - t2) * 1e3
                          + p.last_measured_s * 1e3,
                          "step_ms": (t4 - t0) * 1e3,
                          "lookup_ms": lookup_ms})
            e = rel_err(y.cpu().numpy(), spmv_oracle(A, x))
            worst = max(worst, e)
            check(p.operands[0] is st and e <= TOL,
                  f"mutate {label} value step {i}: same operand, rel_err "
                  f"{e:.3e}")
        check(store.misses == misses, f"mutate {label}: no host prep in the "
              f"value steps ({store.misses - misses} misses)")
        med = {k: statistics.median(st_[k] for st_ in steps)
               for k in steps[0]}
        t0 = time.monotonic()
        fresh = SparseTensor.from_csr(A, schedule=s, shape_bucket=True,
                                      slack=MUTATE_SLACK, device=device)
        sync(device)
        rebuild_s = time.monotonic() - t0
        del fresh
        emit({"mutate": {"layout": layout, "input": label,
                         "nnz": A0.nnz, "positions_per_step": k_vals,
                         "steps": MUTATE_STEPS, "first_build_s": first_s,
                         "median": med, "rebuild_ms": rebuild_s * 1e3,
                         "rebuild_over_step": rebuild_s * 1e3
                         / med["step_ms"],
                         "store_misses": store.misses - misses,
                         "max_rel_err": worst,
                         "blocks_bytes": st.arrays["blocks"].numel() * 4}})

        count = "valid_counts" if layout == "ell" else "cell_valid"
        for i in range(MUTATE_INSERT_STEPS):
            r, c = new_block_positions(st, A, rng, 2, 2)
            before = st.arrays[count].clone()
            swaps = mm.epoch_swaps
            mm.apply_delta(Delta(r, c, rng.standard_normal(r.size).astype(
                np.float32)))
            _, e = serve(f"insert step {i}")
            grown = int((st.arrays[count] - before).sum())
            ok = counts_match(st)
            emit({"mutate": {"layout": layout, "insert_step": i,
                             "new_blocks": 4, "count_growth": grown,
                             "counts_match": ok, "rel_err": e,
                             "spare_left": len(st.spare_blocks)}})
            check(mm.epoch_swaps == swaps and grown == 4 and ok
                  and store.misses == misses,
                  f"mutate {label} insert step {i}: in place, {count} "
                  f"+{grown} (4 new blocks), counts match {ok}")
        # the kernel against its plain version on the mutated operand;
        # these launches are the row's, not the main path's
        counted = dict(K.LAUNCHES)
        rec = matvec_row(st, False, f"mutate {label}", x, spmv_oracle(A, x),
                         torch_csr(A, device), timer, device)
        K.LAUNCHES.update(counted)
        rows = {rec["kernel"]: [rec]}

        n_over = len(st.spare_blocks) + 1
        r, c = new_block_positions(st, A, rng, n_over, 1)
        swaps, rebuilds = mm.epoch_swaps, mm.rebuilds
        t0 = time.monotonic()
        mm.apply_delta(Delta(r, c, np.ones(r.size, np.float32)))
        swap_s = time.monotonic() - t0
        p, e = serve("after the epoch swap")
        check(mm.epoch_swaps == swaps + 1 and mm.rebuilds == rebuilds + 1
              and p.operands[0] is not st and counts_match(p.operands[0]),
              f"mutate {label}: {n_over} new blocks past the pool swap "
              "the epoch")
        st = p.operands[0]
        faults = {}
        if layout == "ell":
            for site in ("delta-apply", "slack-overflow"):
                pick = rng.choice(A.nnz, size=k_vals, replace=False)
                rows_now = np.repeat(np.arange(A.shape[0], dtype=np.int64),
                                     A.row_lengths())
                inj = install_injector(FaultInjector(1.0, sites=(site,),
                                                     seed=seed))
                try:
                    mm.apply_delta(Delta(rows_now[pick],
                                         A.col_idxs[pick].astype(np.int64),
                                         np.ones(k_vals, np.float32)))
                finally:
                    install_injector(None)
                _, e = serve(f"after an injected {site}")
                faults[site] = inj.telemetry()
                check(faults[site]["fault_fired"]
                      == faults[site]["fault_recovered"] > 0,
                      f"mutate {label}: {site} fired == recovered "
                      f"({faults[site]})")
        emit({"mutate": {"layout": layout, "overflow_new_blocks": n_over,
                         "epoch_swap_s": swap_s, "faults": faults,
                         "telemetry": mm.telemetry(),
                         "store": store.telemetry()}})
        for name, recs in rows.items():
            results.setdefault(name, []).extend(recs)
        del p, st, mm, store, A
        if device == "cuda":
            torch.cuda.empty_cache()

    # drift: a small matrix driven toward dense under a DriftMonitor
    dtuner = ScheduleTuner("spmv", H100_SXM).fit(
        corpus(n_matrices=6, n_min=128, n_max=192, seed=3), max_mats=3)
    svc = SelectorService(dtuner, cache=ScheduleCache(), device=device)
    mon = DriftMonitor(svc, drift_threshold=0.05, accuracy_floor=0.9,
                       window=6, min_checks=2)
    d = (rng.random((128, 128)) < 0.02) * rng.standard_normal((128, 128))
    D = CSR.from_dense(d.astype(np.float32))
    dstore = PreparedStore()
    dmm = MutableMatrix(D, store=dstore, monitor=mon, slack=8)
    xd = rng.standard_normal(128).astype(np.float32)
    for i in range(DRIFT_STEPS):
        p = plan("spmv", (D,), selector=svc, store=dstore, device=device)
        e = rel_err(p.execute(xd).cpu().numpy(), spmv_oracle(D, xd))
        check(e <= TOL, f"mutate drift step {i}: rel_err {e:.3e}")
        empt = np.argwhere(D.to_dense() == 0)
        k = min(1200, empt.shape[0])
        pos = empt[rng.choice(empt.shape[0], k, replace=False)]
        dmm.apply_delta(Delta(pos[:, 0], pos[:, 1],
                              rng.standard_normal(k).astype(np.float32)))
    emit({"mutate": {"drift": mon.telemetry(),
                     "drift_evictions": svc.cache.drift_evictions,
                     "density": D.nnz / (128 * 128),
                     "mutation": dmm.telemetry()}})

    # an engine tenant mutated between drains
    t = min(range(len(population)), key=lambda i: population[i][1].nnz)
    name, A = population[t][0], copy_csr(population[t][1])
    estore = PreparedStore(byte_budget=16 << 30)
    esvc = SelectorService(tuner, cache=ScheduleCache(),
                           confidence_threshold=0.0, prepared_store=estore,
                           device=device)
    engine = ServingEngine(esvc, **ENGINE_KW)
    outs = []
    engine_watch(engine, outs)
    mm = MutableMatrix(A, store=estore, slack=MUTATE_SLACK)
    xe = rng.standard_normal(A.shape[1]).astype(np.float32)
    ref_old = spmv_oracle(A, xe)
    for rnd in range(2):
        for j in range(4):
            engine.submit(f"before{rnd}.{j}", A, xe, tenant=t)
        engine.drain_all()
    n_old = len(outs)
    rows_t = np.repeat(np.arange(A.shape[0], dtype=np.int64),
                       A.row_lengths())
    pick = rng.choice(A.nnz, size=max(A.nnz // 100, 1), replace=False)
    mm.apply_delta(Delta(rows_t[pick], A.col_idxs[pick].astype(np.int64),
                         rng.standard_normal(pick.size).astype(np.float32)))
    ref_new = spmv_oracle(A, xe)
    for rnd in range(2):
        for j in range(4):
            engine.submit(f"after{rnd}.{j}", A, xe, tenant=t)
        engine.drain_all()
    err_old = max(rel_err(dec.y, ref_old) for _, dec in outs[:n_old])
    err_new = max(rel_err(dec.y, ref_new) for _, dec in outs[n_old:])
    moved = rel_err(ref_new, ref_old)
    tel = engine.telemetry()
    emit({"mutate": {"engine_tenant": name, "rows": A.shape[0],
                     "before": n_old, "after": len(outs) - n_old,
                     "max_rel_err_before": err_old,
                     "max_rel_err_after": err_new,
                     "delta_moves_output_by": moved,
                     "mutation": mm.telemetry(),
                     "completed": tel["completed"]}})
    check(n_old == 8 and len(outs) == 16 and err_old <= TOL
          and err_new <= TOL and moved > 100 * TOL
          and tel["admitted"] == tel["completed"] + tel["shed"],
          f"mutate engine {name}: no result after the delta from the old "
          f"values (before {err_old:.3e}, after {err_new:.3e}, the delta "
          f"moves y by {moved:.3e})")
    launches = {n: v for n, v in K.LAUNCHES.items() if v}
    emit({"mutate": {"phase_s": time.monotonic() - t_phase,
                     "launches": launches}})
    for name in ("bsr_spmv_ell", "bsr_spmv_sell"):
        check(launches.get(name, 0) > 0, f"mutate: {name} launched")
    return results, launches


# ------------------------------------------------------------- sharded

def add_counts(total: dict, counts: dict) -> None:
    for name, n in counts.items():
        total[name] = total.get(name, 0) + n


def run_sharded(device: str, spatial, zipf, tuner, population, seed: int,
                timer) -> dict:
    """The sharded phase (``{"sharded": ...}`` lines): (a) uniform
    schedules, (b) per-shard selection, (c) explicit heterogeneous
    schedules, as the module docstring says. Returns the kernels' launches
    on the phase's main path (the timing runs excluded)."""
    import torch
    from repro_torch.core import Schedule, spmm_oracle, spmv_oracle
    from repro_torch.kernels.bsr_spmv import kernel as K
    from repro_torch.selector import ScheduleCache, SelectorService
    from repro_torch.sparse import (PreparedStore, launch_count,
                                    partition_rows, plan, plan_sharded,
                                    reset_counters)
    from repro_torch.sparse.prepared import entry_nbytes

    n = SHARD_COUNT
    rng = np.random.default_rng(seed + 11)
    name = f"spatial_{spatial.shape[0]}_bs32"
    rhs = {"spmv": rng.standard_normal(spatial.shape[1]).astype(np.float32),
           "spmm": rng.standard_normal((spatial.shape[1], K_RHS)).astype(
               np.float32)}
    refs = {"spmv": spmv_oracle(spatial, rhs["spmv"]),
            "spmm": spmm_oracle(spatial, rhs["spmm"])}
    # timed runs take x on the card, so no time is the host copy's
    on_card = {op: torch.as_tensor(x, device=device) for op, x in rhs.items()}
    launches: dict = {}

    def one_launch(p, op, runtime, kernels: dict):
        """Execute ``p`` once; check it is one plan launch and exactly
        ``kernels`` ({kernel: launches}) of the SpMV/SpMM kernels."""
        before = (launch_count(op), dict(K.LAUNCHES))
        y = p.execute(runtime)
        sync(device)
        got = {k: K.LAUNCHES[k] - before[1][k] for k in K.LAUNCHES}
        got = {k: v for k, v in got.items() if v}
        check(launch_count(op) - before[0] == 1 and got == kernels,
              f"sharded {op}: one execute is one plan launch and kernel "
              f"launches {kernels}, got {got}")
        return y.cpu().numpy()

    # (a) uniform schedules: one stacked launch per execute
    for layout in ("ell", "sell"):
        s = sched(layout, 32)
        store = PreparedStore(byte_budget=STORE_BYTES)
        K.reset_launch_counts()
        reset_counters()
        single = {op: plan(op, (spatial,), schedule=s, store=store,
                           device=device) for op in rhs}
        single_bytes = entry_nbytes(single["spmv"].operands[0])
        rows, plans = [], []
        for strategy in ("nnz", "rows"):
            part = partition_rows(spatial, n, strategy)
            for op in rhs:
                t0 = time.monotonic()
                p = plan_sharded(op, (spatial,), n_shards=n, schedule=s,
                                 strategy=strategy, store=store,
                                 device=device)
                plan_s = time.monotonic() - t0
                y = one_launch(p, op, rhs[op], {f"bsr_{op}_{layout}": 1})
                y1 = single[op].execute(rhs[op]).cpu().numpy()
                e_o, e_s = rel_err(y, refs[op]), rel_err(y, y1)
                check(y.shape == refs[op].shape and np.isfinite(y).all()
                      and e_o <= TOL and e_s <= TOL,
                      f"sharded {op} {layout} {strategy}: {e_o:.3e} from "
                      f"the oracle, {e_s:.3e} from the unsharded plan")
                stacked = [nb for key, (_, nb) in store._entries.items()
                           if key[0] == "matvec_shards_stacked"
                           and key[2] == strategy]
                rows.append({"input": name, "op": op, "layout": layout,
                             "strategy": strategy, "n_shards": n,
                             "bounds": list(part.bounds),
                             "shard_nnz": list(part.shard_nnz),
                             "imbalance": part.imbalance(),
                             "plan_s": plan_s,
                             "stacked_bytes": stacked[0] if stacked
                             else None,
                             "unsharded_bytes": single_bytes,
                             "rel_err_vs_oracle": e_o,
                             "rel_err_vs_unsharded": e_s})
                plans.append((p, op))
        add_counts(launches, K.LAUNCHES)
        for rec, (p, op) in zip(rows, plans):
            rec["ms"] = timer(lambda: p.execute(on_card[op]), iters=10,
                              warmup=2)
            rec["unsharded_ms"] = timer(
                lambda: single[op].execute(on_card[op]), iters=10, warmup=2)
            rec["card"] = CARD
            emit({"sharded": rec})
        del single, plans, store
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()

    # (b) per-shard selection through a SelectorService
    store = PreparedStore(byte_budget=STORE_BYTES)
    svc = SelectorService(tuner, cache=ScheduleCache(),
                          confidence_threshold=0.0, prepared_store=store,
                          device=device)
    big_name, big = max(population, key=lambda t: t[1].nnz)
    K.reset_launch_counts()
    for inp_name, A in ((f"zipf_{zipf.shape[0]}", zipf),
                        (f"engine {big_name}", big)):
        part = partition_rows(A, n, "nnz")
        shards = part.slice(A)
        # what the service's picks would hold, reckoned by a twin service
        # before anything is built (selection builds nothing; the stacked
        # launch pads every shard to the largest)
        twin = SelectorService(tuner, cache=ScheduleCache(),
                               confidence_threshold=0.0, device=device)
        picks = [d.schedule for d in twin.select_shards(shards)]
        held = [block_bytes(c, s.block_size) if s.backend == "bsr" else
                {"dense_bytes": c.shape[0] * c.shape[1] * 4}
                for c, s in zip(shards, picks)]
        sizes = [h.get("bucketed_block_bytes", h.get("dense_bytes", 0))
                 for h in held]
        emit({"sharded": {"selection": inp_name,
                          "picks": [describe(s) for s in picks],
                          "reckoned": held, "reckoned_bytes": sum(sizes),
                          "stack_bound_bytes": n * max(sizes)}})
        check(n * max(sizes) <= STORE_BYTES,
              f"sharded selection {inp_name}: a stack of {n} x "
              f"{max(sizes)} reckoned bytes fits the store")
        x = np.random.default_rng(seed + 12).standard_normal(
            A.shape[1]).astype(np.float32)
        t0 = time.monotonic()
        p = plan_sharded("spmv", (A,), n_shards=n, selector=svc,
                         device=device)
        cold_s = time.monotonic() - t0
        got = [pr["schedule"] for pr in p.shard_provenance]
        check(got == picks, f"sharded selection {inp_name}: the service "
              "picks what its twin was reckoned with")
        # a q < 1 ELL pick serves its shard without the blocks past its
        # row cap: the oracle is the matrix each shard's schedule serves
        ref = np.concatenate([spmv_oracle(served_matrix(c, s), x)
                              for c, s in zip(shards, got)])
        y = p.execute(x).cpu().numpy()
        e = rel_err(y, ref)
        check(np.isfinite(y).all() and e <= TOL,
              f"sharded selection {inp_name}: rel_err {e:.3e}")
        hits, misses = store.hits, store.misses
        t0 = time.monotonic()
        warm = plan_sharded("spmv", (A,), n_shards=n, selector=svc,
                            device=device)
        warm_s = time.monotonic() - t0
        y2 = warm.execute(x).cpu().numpy()
        check(store.hits - hits >= 2 and store.misses == misses
              and np.array_equal(y, y2)
              and {pr["source"] for pr in warm.shard_provenance}
              == {"selector-cache"},
              f"sharded selection {inp_name}: the warm re-plan rebuilds "
              f"nothing (hits +{store.hits - hits}, misses "
              f"+{store.misses - misses})")
        emit({"sharded": {
            "selection": inp_name, "rows": A.shape[0], "nnz": A.nnz,
            "imbalance": part.imbalance(), "shard_nnz": list(part.shard_nnz),
            "picks": [{"schedule": describe(pr["schedule"]),
                       "source": pr["source"],
                       "confidence": pr["confidence"],
                       "fingerprint": pr["fingerprint_key"][:12]}
                      for pr in p.shard_provenance],
            "plan": p.describe(), "cold_plan_s": cold_s,
            "warm_plan_s": warm_s, "warm_store_hits": store.hits - hits,
            "warm_store_misses": store.misses - misses,
            "execute_ms": warm.last_measured_s * 1e3,
            "rel_err_vs_oracle": e, "card": CARD}})
        del p, warm
    add_counts(launches, K.LAUNCHES)
    tel = svc.telemetry()
    guard = svc.executor.telemetry()
    emit({"sharded": {"selector_telemetry": {
        k: tel[k] for k in ("shard_requests", "sharded_plans", "requests")},
        "service_guard": {**guard,
                          "quarantined": len(svc.executor.quarantine)}}})
    check(tel["sharded_plans"] == 4 and tel["shard_requests"] == 4 * n,
          "select_shards: one decision per shard per sharded plan")
    check(sum(guard.values()) == 0 and not len(svc.executor.quarantine),
          "sharded selection: the service's guard counts no fall")
    del svc, store
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    # (c) explicit heterogeneous schedules: one stream per shard
    scheds = [Schedule("bsr", 32, 1.0),
              Schedule("bsr", 16, 1.0, layout="sell", slice_height=4),
              Schedule("bsr", 64, 1.0),
              Schedule("bsr", 32, 1.0, layout="sell", slice_height=8)]
    store = PreparedStore(byte_budget=STORE_BYTES)
    K.reset_launch_counts()
    t0 = time.monotonic()
    p = plan_sharded("spmv", (spatial,), n_shards=n, schedules=scheds,
                     store=store, device=device)
    plan_s = time.monotonic() - t0
    check(p.schedule is None, "heterogeneous shards: no single schedule")
    y = one_launch(p, "spmv", rhs["spmv"],
                   {"bsr_spmv_ell": 2, "bsr_spmv_sell": 2})
    add_counts(launches, K.LAUNCHES)
    e = rel_err(y, refs["spmv"])
    check(np.isfinite(y).all() and e <= TOL,
          f"sharded heterogeneous: rel_err {e:.3e}")
    wall = timer(lambda: p.execute(on_card["spmv"]), iters=10, warmup=2)
    xt = on_card["spmv"]
    per_shard = []
    for st in p.operands[0].shards:
        kname, cuda_fn, _, idx, count = kernel_args(st, False)
        bs = st.block_size
        n_bc = -(-st.meta.shape[1] // bs)
        xb = torch.zeros(n_bc * bs, dtype=torch.float32, device=device)
        xb[: xt.shape[0]] = xt
        xb = xb.reshape(n_bc, bs)
        blocks = st.arrays["blocks"]
        per_shard.append({"kernel": kname, "bs": bs,
                          "rows": st.true_shape[0],
                          "bytes": entry_nbytes(st),
                          "ms": timer(lambda: cuda_fn(*idx, blocks, xb,
                                                      **count))})
    emit({"sharded": {
        "heterogeneous": name, "schedules": [describe(s) for s in scheds],
        "plan_s": plan_s, "execute_wall_ms": wall,
        "shards": per_shard,
        "sum_of_shard_kernel_ms": sum(r["ms"] for r in per_shard),
        "rel_err_vs_oracle": e, "max_abs_err_vs_oracle": float(
            np.abs(y - refs["spmv"]).max()), "card": CARD}})
    del p, store
    emit({"sharded": {"launches": launches}})
    for kname in ("bsr_spmv_ell", "bsr_spmm_ell", "bsr_spmv_sell",
                  "bsr_spmm_sell"):
        check(launches.get(kname, 0) > 0, f"sharded: {kname} launched")
    return launches


# ------------------------------------------------------------------ lm

def device_profile(fn, device: str, top: int = 8):
    """``fn`` once unprofiled (its host wall ms, warm) and once under
    ``torch.profiler`` (CPU and CUDA activities). The device time counts
    the CUDA kernel and memcpy events alone (the CPU operators carry the
    time of the kernels they launch, so summing both counts each kernel
    twice): their summed time, their busy time (the union of their
    intervals) over the unprofiled wall time as the device's busy share,
    and the ``top`` kernels by device time. None when the profiler saw no
    device event (then the busy share is not measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if device != "cuda":
        return None
    sync(device)
    t0 = time.monotonic()
    fn()
    sync(device)
    wall_ms = (time.monotonic() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        fn()
        sync(device)
        prof_wall_ms = (time.monotonic() - t0) * 1e3
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or e.is_user_annotation:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    if not spans:
        return None
    busy_us, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy_us += b - a
            end = b
        elif b > end:
            busy_us += b - end
            end = b
    ops = sorted(by_name.items(), key=lambda t: -t[1][0])
    return {"wall_ms": wall_ms, "profiled_wall_ms": prof_wall_ms,
            "kernels": len(spans),
            "device_ms": sum(ms for ms, _ in by_name.values()),
            "busy_ms": busy_us / 1e3,
            "busy_share": busy_us / 1e3 / wall_ms,
            "top": [{"op": k[:60], "device_ms": ms, "calls": n}
                    for k, (ms, n) in ops[:top]]}


def lm_cfg(arch: str, cut: dict):
    """``arch``'s config with the depth ``cut`` (``dataclasses.replace``
    fields) of its smoke path."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), **cut)


def roofline_jobs() -> dict:
    """{"<arch>/<kind>": the step of each timed LM line whose roofline the
    smoke prints: (arch, depth cut, kind, batch, seq, step keywords)}."""
    jobs = {}
    for d, cut in ((LM_SERVE, {}), (LM_MOE, {"n_layers": LM_MOE["layers"]})):
        gen = d.get("gen", d.get("decode"))
        jobs[f"{d['arch']}/prefill"] = (d["arch"], cut, "prefill", d["batch"],
                                        d["prompt"], {"chunk": d["chunk"],
                                        "cache_len": d["prompt"] + gen})
        jobs[f"{d['arch']}/decode"] = (d["arch"], cut, "decode", d["batch"],
                                       d["prompt"] + gen,
                                       {"chunk": d["chunk"]})
    d = TRAIN_FULL
    jobs[f"{d['arch']}/train"] = (d["arch"], {}, "train", d["batch"],
                                  d["seq"], {"chunk": d["chunk"],
                                             "remat": d["remat"],
                                             "microbatches":
                                                 d["microbatches"]})
    for arch, f in FAMILIES.items():
        s, cut = f["serve"], f.get("cut", {})
        jobs[f"{arch}/prefill"] = (arch, cut, "prefill", s["batch"],
                                   s["prompt"], {"chunk": s["chunk"],
                                   "cache_len": s["prompt"] + s["gen"]})
        jobs[f"{arch}/decode"] = (arch, cut, "decode", s["batch"],
                                  s["prompt"] + s["gen"],
                                  {"chunk": s["chunk"]})
        t = f.get("train")
        if t:
            jobs[f"{arch}/train"] = (arch, cut, "train", t["batch"],
                                     t["seq"], {"chunk": t["chunk"],
                                                "remat": t["remat"]})
    return jobs


def count_roofline(arch: str, cut: dict, kind: str, batch: int, seq: int,
                   *, chunk: int, remat: str = "none",
                   microbatches: int = 1, cache_len=None) -> dict:
    """The three-term roofline of one ``kind`` step of ``arch`` (train and
    prefill: ``batch`` x ``seq`` tokens; decode: one token per sequence
    against a cache of ``seq``), its operators counted by ``OpCounter`` on
    a ``meta`` model of the same config (no card time), on ``H100_SXM``'s
    rates. One card: collective_s is 0."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import specs
    from repro_torch.models import Model
    from repro_torch.optim import AdamW
    from repro_torch.roofline import (measure_step, model_bytes,
                                      model_flops, roofline_terms)
    from repro_torch.train import make_train_step
    from repro_torch.train.serve_step import (make_decode_step,
                                              make_prefill_step)
    t0 = time.monotonic()
    cfg = lm_cfg(arch, cut)
    model = Model(cfg, device="meta")
    shape = ShapeConfig(kind, seq, batch, kind)
    if kind == "train":
        step = make_train_step(model, AdamW(model.parameters()), remat=remat,
                               attn_chunk=chunk, microbatches=microbatches)
        args = specs.train_abstract(model, shape)[2:]
    elif kind == "prefill":
        step = make_prefill_step(model, attn_chunk=chunk,
                                 cache_len=cache_len)
        args = specs.prefill_abstract(model, shape)[1:]
    else:
        step = make_decode_step(model)
        args = specs.decode_abstract(model, shape)[1:]
    stats = measure_step(step, *args)
    r = roofline_terms(arch=cfg.name, shape=kind, mesh_name="1", n_chips=1,
                       stats=stats, memory_per_device=0.0,
                       model_flops_global=model_flops(cfg, shape, model),
                       model_bytes_global=model_bytes(cfg, shape, model))
    return {"kind": kind, "batch": batch, "seq": seq, "flops": r.hlo_flops,
            "bytes": r.hlo_bytes, "compute_s": r.t_compute,
            "memory_s": r.t_memory, "collective_s": r.t_collective,
            "bottleneck": r.bottleneck, "useful_ratio": r.useful_ratio,
            "roofline_fraction": r.roofline_fraction,
            "count_s": time.monotonic() - t0}


def write_roofline_counts(path: str) -> None:
    """Every ``roofline_jobs`` step counted, as JSON at ``path`` (the
    background process the smoke starts: ``python -c``)."""
    out = {key: count_roofline(arch, cut, kind, batch, seq, **kw)
           for key, (arch, cut, kind, batch, seq, kw)
           in roofline_jobs().items()}
    Path(path).write_text(json.dumps(out))


def roofline_record(counts: dict, key: str, measured_ms) -> dict:
    """The counted roofline of ``key`` beside the measured step time:
    ``measured_over_bound`` is the measured time over the largest term."""
    r = dict(counts[key])
    bound_s = max(r["compute_s"], r["memory_s"], r["collective_s"])
    r.update(measured_ms=measured_ms,
             measured_over_bound=measured_ms / 1e3 / bound_s)
    return r


def start_background(root: Path) -> dict:
    """The smoke's host-only work, started in subprocesses that see no
    card, while the kernel phases (timed by CUDA events) run: the
    roofline counts of the LM steps (``write_roofline_counts``) and the
    dry-run cells (``python -m repro_torch.launch.dryrun``), one process
    each, one thread each."""
    import os
    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    DRYRUN_DIR.mkdir(parents=True)
    env = {**os.environ, "PYTHONPATH": f"{root}:{root / 'src'}",
           "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"}
    counts = DRYRUN_DIR / "roofline_counts.json"
    procs = {"counts": subprocess.Popen(
        [sys.executable, "-c", "import chip_smoke; chip_smoke."
         f"write_roofline_counts({str(counts)!r})"], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)}
    for arch, shape, multi_pod in DRYRUN_CELLS:
        argv = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                arch, "--shape", shape, "--out", str(DRYRUN_DIR)]
        procs[(arch, shape, multi_pod)] = subprocess.Popen(
            argv + (["--multi-pod"] if multi_pod else []), env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return {"procs": procs, "counts": counts, "t0": time.monotonic()}


def wait_background(bg: dict, key) -> str:
    """Wait for one background process; its output. It must exit 0."""
    proc = bg["procs"][key]
    out, _ = proc.communicate(timeout=BACKGROUND_TIMEOUT_S)
    check(proc.returncode == 0,
          f"background {key}: exit {proc.returncode}:\n{out[-3000:]}")
    return out


def roofline_counts(bg: dict) -> dict:
    wait_background(bg, "counts")
    log(f"roofline counts ready ({time.monotonic() - bg['t0']:.1f}s after "
        f"their start)")
    return json.loads(bg["counts"].read_text())


def run_lm(device: str, seed: int, counts: dict) -> dict:
    """The lm phase (``{"lm": ...}`` lines): llama3.2-3b at full width and
    depth served through ``launch.serve.main`` with the decode-versus-
    forward check, mixtral-8x22b at full width and 2 layers (prefill and
    decode, its MoE metrics), then ``examples.serve_lm``'s main path on
    the card. Returns the kernels' launches of the example."""
    import contextlib
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.examples import serve_lm
    from repro_torch.kernels.bsr_spmv import kernel as K
    from repro_torch.kernels.moe_gmm import kernel as MK
    from repro_torch.launch import serve
    from repro_torch.models import Model, count_params
    from repro_torch.models import transformer as tfm

    # llama3.2-3b at full width and depth through the serve CLI
    d = LM_SERVE
    cfg = get_config(d["arch"])
    t0 = time.monotonic()
    model = Model(cfg, device=device).init(seed=seed)
    sync(device)
    init_s = time.monotonic() - t0
    peak_reset(device)
    with contextlib.redirect_stdout(sys.stderr):
        res = serve.main(["--arch", d["arch"], "--requests",
                          str(d["requests"]), "--batch", str(d["batch"]),
                          "--prompt-len", str(d["prompt"]), "--gen-len",
                          str(d["gen"]), "--attn-chunk", str(d["chunk"]),
                          "--device", device], model=model)
    serve_peak = peak(device)
    outs = np.concatenate(res["outputs"])
    check(outs.shape == (d["requests"], d["gen"]) and (outs >= 0).all()
          and (outs < cfg.vocab_padded).all(), "lm serve: token shapes")
    # the reference's decode-versus-forward property on the last batch:
    # the last decode step against a prefill over prompt + generated
    toks = np.concatenate([res["prompts"][-1], res["outputs"][-1][:, :-1]],
                          axis=1)
    fwd, _ = model.prefill({"tokens": torch.as_tensor(toks)},
                           attn_chunk=toks.shape[1])
    last = res["last_logits"].float().cpu().numpy()
    fwd = fwd.float().cpu().numpy()
    e = rel_err(last, fwd)
    check(np.isfinite(last).all() and e < BF16_TOL,
          f"lm decode vs forward: {e:.3e} >= {BF16_TOL}")
    roofline = {
        "prefill": roofline_record(counts, f"{d['arch']}/prefill",
                                   res["batch_prefill_ms"][-1]),
        "decode": roofline_record(counts, f"{d['arch']}/decode",
                                  res["batch_decode_ms_per_token"][-1])}
    emit({"lm": {"arch": d["arch"], "params": count_params(model),
                 "roofline": roofline,
                 "layers": cfg.n_layers, "d_model": cfg.d_model,
                 "vocab_padded": cfg.vocab_padded,
                 "requests": d["requests"], "batch": d["batch"],
                 "prompt": d["prompt"], "gen": d["gen"],
                 "attn_chunk": d["chunk"], "init_s": init_s,
                 "tok_s": res["throughput_tok_s"],
                 "prefill_ms": res["prefill_ms"],
                 "decode_ms_per_token": res["decode_ms_per_token"],
                 "batch_prefill_ms": res["batch_prefill_ms"],
                 "batch_decode_ms_per_token":
                     res["batch_decode_ms_per_token"],
                 "max_memory_allocated": serve_peak,
                 "decode_vs_forward_rel_err": e, "card": CARD}})
    # where a warm prefill and a warm decode step spend their time
    prompt = torch.as_tensor(res["prompts"][-1], device=device)
    _, cache = model.prefill({"tokens": prompt}, attn_chunk=d["chunk"],
                             cache_len=d["prompt"] + d["gen"])
    tok = torch.as_tensor(res["outputs"][-1][:, 0], device=device)
    prof = {"prefill": device_profile(lambda: model.prefill(
                {"tokens": prompt}, attn_chunk=d["chunk"],
                cache_len=d["prompt"] + d["gen"]), device),
            "decode": device_profile(lambda: model.decode(
                cache, tok, d["prompt"]), device)}
    emit({"lm": {"arch": d["arch"], "profile": prof, "card": CARD}})
    del model, res, fwd, cache
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    # mixtral-8x22b at full width, depth cut
    d = LM_MOE
    cfg = dataclasses.replace(get_config(d["arch"]), n_layers=d["layers"])
    model = Model(cfg, device=device).init(seed=seed + 1)
    toks = torch.as_tensor(np.random.default_rng(seed + 1).integers(
        1, cfg.vocab_size, (d["batch"], d["prompt"])), device=device)
    max_len = d["prompt"] + d["decode"]
    peak_reset(device)
    t0 = time.monotonic()
    with torch.no_grad():
        x = tfm.embed_tokens(cfg, model, toks)
        h, cache, aux = tfm.apply_stack(cfg, model.blocks, x,
                                        mode="prefill",
                                        attn_chunk=d["chunk"],
                                        cache_len=max_len)
        h = tfm.apply_norm(cfg, model.final_norm, h)
        logits = tfm.logits_at(cfg, model, h[:, -1:])[:, 0]
    sync(device)
    prefill_ms = (time.monotonic() - t0) * 1e3
    want = (d["batch"], min(cfg.window, max_len), cfg.n_kv_heads,
            cfg.d_head)
    check(all(tuple(c["self"]["k"].shape) == want for c in cache)
          and bool(torch.isfinite(logits).all()),
          f"lm {d['arch']} prefill: cache {want}, finite logits")
    tok = torch.argmax(logits, -1)
    t0 = time.monotonic()
    for i in range(d["decode"]):
        logits, cache = model.decode(cache, tok, d["prompt"] + i)
        tok = torch.argmax(logits, -1)
    sync(device)
    decode_ms = (time.monotonic() - t0) * 1e3 / d["decode"]
    check(bool(torch.isfinite(logits).all()),
          f"lm {d['arch']} decode: finite logits")
    roofline = {
        "prefill": roofline_record(counts, f"{d['arch']}/prefill",
                                   prefill_ms),
        "decode": roofline_record(counts, f"{d['arch']}/decode",
                                  decode_ms)}
    emit({"lm": {"arch": d["arch"], "layers": cfg.n_layers,
                 "roofline": roofline,
                 "cut": f"depth {get_config(d['arch']).n_layers} -> "
                        f"{cfg.n_layers}",
                 "params": count_params(model), "d_model": cfg.d_model,
                 "d_ff": cfg.d_ff, "experts": cfg.n_experts,
                 "window": cfg.window, "cache_len": want[1],
                 "batch": d["batch"], "prompt": d["prompt"],
                 "decode_steps": d["decode"], "prefill_ms": prefill_ms,
                 "decode_ms_per_token": decode_ms,
                 **{k: float(v) / cfg.n_layers for k, v in aux.items()},
                 "max_memory_allocated": peak(device), "card": CARD}})
    del model, cache, logits, x, h
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    # the serving example's main path on the card
    K.reset_launch_counts()
    MK.reset_launch_counts()
    with contextlib.redirect_stdout(sys.stderr):
        ex = serve_lm.main(["--device", device])
    launches = {**{k: v for k, v in K.LAUNCHES.items() if v},
                "moe_gmm": MK.LAUNCHES["moe_gmm"]}
    mr, moe = ex["multirhs"], ex["moe"]
    emit({"lm": {"example": "serve_lm", "serve_tok_s":
                 ex["serve"]["throughput_tok_s"],
                 "moe_ticks": len(moe["ticks"]),
                 "moe_tiles": sorted({bs for bs, _ in moe["ticks"]}),
                 "moe_cache_hit_rate": moe["cache_hit_rate"],
                 "multirhs": mr, "launches": launches, "card": CARD}})
    check(mr["spmv_launches"] == mr["ticks"] * mr["batch"]
          and mr["spmm_launches"] == mr["ticks"]
          and launches.get("bsr_spmv_sell") == mr["spmv_launches"]
          and launches.get("bsr_spmm_sell") == mr["spmm_launches"]
          and launches["moe_gmm"] == len(moe["ticks"]),
          f"serve_lm: spmv launches {mr['spmv_launches']} -> spmm "
          f"{mr['spmm_launches']}, kernels {launches}")
    return launches


# ------------------------------------------------------- train, families

def train_batch(cfg, batch: int, seq: int, step: int, device: str) -> dict:
    """``launch.train``'s batch of ``step`` on ``device``."""
    import torch
    from repro_torch.data import SyntheticLMDataset
    b = SyntheticLMDataset(cfg.vocab_size, seq, batch).global_batch_at(step)
    out = {"tokens": torch.as_tensor(b["tokens"].astype(np.int64),
                                     device=device),
           "loss_mask": torch.as_tensor(b["loss_mask"], device=device)}
    if cfg.is_encdec:
        out["audio_embed"] = torch.as_tensor(
            np.random.default_rng(step).standard_normal(
                (batch, cfg.encoder_len, cfg.d_model)).astype(np.float32),
            device=device).to(torch.bfloat16)
    return out


def loss_and_grad_norm(model, batch: dict, remat: str, microbatches: int,
                       chunk: int):
    """(loss, global grad norm) of ``batch`` from the model's current
    weights, as ``make_train_step`` computes them before the optimizer:
    per microbatch a forward and a backward, the grads summed and scaled
    by 1/microbatches. Leaves no grads behind."""
    import torch
    model.zero_grad(set_to_none=True)
    mb = batch["tokens"].shape[0] // microbatches
    loss = 0.0
    for i in range(microbatches):
        sub = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
        l, _ = model.loss(sub, remat=remat, attn_chunk=chunk)
        l.backward()
        loss += float(l.detach()) / microbatches
    sq = sum(torch.linalg.vector_norm(p.grad, dtype=torch.float32) ** 2
             for p in model.parameters() if p.grad is not None)
    gnorm = float(torch.sqrt(sq)) / microbatches
    model.zero_grad(set_to_none=True)
    return loss, gnorm


def step_split(step, model, optimizer, batch: dict, device: str) -> dict:
    """One call of ``step`` (``make_train_step`` of ``model`` and
    ``optimizer``) timed by phase through wrappers of ``model.loss`` and
    ``optimizer.step``, each mark taken after a synchronize: the forwards
    (inside ``loss``), the backwards (from a ``loss`` returning to the next
    ``loss`` or ``step`` call, the 1/microbatches grad scaling included)
    and the optimizer (inside ``step``), in ms."""
    marks = []

    def timed(fn, kind):
        def wrapper(*args, **kwargs):
            sync(device)
            marks.append((kind, time.monotonic()))
            out = fn(*args, **kwargs)
            sync(device)
            marks.append(("end", time.monotonic()))
            return out
        return wrapper

    model.loss = timed(model.loss, "forward")
    optimizer.step = timed(optimizer.step, "optimizer")
    try:
        step(batch)
    finally:
        del model.loss, optimizer.step
    out = {"forward_ms": 0.0, "backward_ms": 0.0, "optimizer_ms": 0.0}
    for (kind, t0), (_, t1) in zip(marks[::2], marks[1::2]):
        out[kind + "_ms"] += (t1 - t0) * 1e3
    for (_, t0), (_, t1) in zip(marks[1:-1:2], marks[2::2]):
        out["backward_ms"] += (t1 - t0) * 1e3
    return out


def train_argv(arch: str, d: dict, ckpt: Path, device: str,
               reduced: bool = False) -> list:
    argv = ["--arch", arch, "--steps", str(d["steps"]), "--batch",
            str(d["batch"]), "--seq", str(d["seq"]), "--lr", str(d["lr"]),
            "--warmup", str(d["warmup"]), "--attn-chunk", str(d["chunk"]),
            "--remat", d["remat"], "--microbatches",
            str(d.get("microbatches", 1)), "--save-every",
            str(d.get("save_every", d["steps"] + 100)), "--ckpt-dir",
            str(ckpt), "--device", device]
    return argv + (["--reduced"] if reduced else [])


def check_uninterrupted(res: dict, steps: int, what: str) -> None:
    """A ``launch.train.main`` run without ``--simulate-failures`` took
    every step once, with no restart (its supervisor restores after a
    ``RuntimeError``, as a fault on the card is raised), and its losses
    and grad norms are finite."""
    check(res["restarts"] == 0 and res["final_step"] == steps
          and res["loss_steps"] == list(range(steps))
          and np.isfinite(res["losses"]).all()
          and np.isfinite(res["grad_norms"]).all(),
          f"{what}: {steps} finite steps, each once, no restart "
          f"({res['restarts']} restarts, steps {res['loss_steps']})")


def mfu(cfg, model, batch: int, seq: int, step_ms: float) -> float:
    from repro_torch.configs import ShapeConfig
    from repro_torch.roofline import model_flops
    flops = model_flops(cfg, ShapeConfig("train", seq, batch, "train"),
                        model)
    return flops / (step_ms / 1e3) / BF16_FLOP_PER_S


def run_train(device: str, seed: int, counts: dict) -> dict:
    """The train phase (``{"train": ...}`` lines): llama3.2-3b at full
    width and depth (its loss and grad norm three ways before the
    optimizer exists, then ``launch.train.main`` for TRAIN_FULL's steps
    with the step's roofline, a step split into forward / backward /
    optimizer and its device profile), the reference's loss property (a
    reduced llama loses 0.5 in 40 steps) and its restart path (a reduced
    mamba2 ends at step 12 after 2 restarts, every loss equal to an
    uninterrupted run's). Returns the full-size run's losses and
    step_ms."""
    import contextlib
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import Model, count_params
    from repro_torch.train import make_train_step

    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    d = TRAIN_FULL
    cfg = get_config(d["arch"])
    model = Model(cfg, device=device).init(seed=seed)
    batch = train_batch(cfg, d["batch"], d["seq"], 0, device)
    ways = {"full": loss_and_grad_norm(model, batch, d["remat"], 1,
                                       d["chunk"]),
            "microbatches_2": loss_and_grad_norm(model, batch, d["remat"], 2,
                                                d["chunk"]),
            "remat_none": loss_and_grad_norm(model, batch, "none", 1,
                                             d["chunk"])}
    full = ways["full"]
    agree = {k: (abs(v[0] - full[0]) / abs(full[0]),
                 abs(v[1] - full[1]) / abs(full[1]))
             for k, v in ways.items() if k != "full"}
    emit({"train": {"arch": d["arch"], "before_optimizer": {
        k: {"loss": v[0], "grad_norm": v[1]} for k, v in ways.items()},
        "rel_diff_to_full": agree, "card": CARD}})
    check(all(np.isfinite(v).all() for v in ways.values())
          and all(max(a) < TRAIN_AGREE for a in agree.values()),
          f"train: full batch, 2 microbatches and remat none agree within "
          f"{TRAIN_AGREE}: {agree}")
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    peak_reset(device)
    with contextlib.redirect_stdout(sys.stderr):
        res = train.main(train_argv(d["arch"], d, TRAIN_DIR / "full",
                                    device), model=model)
    train_peak = peak(device)
    check_uninterrupted(res, d["steps"], f"train {d['arch']}")
    opt = res["optimizer"]
    step = make_train_step(model, opt, remat=d["remat"],
                           attn_chunk=d["chunk"],
                           microbatches=d["microbatches"])
    split = step_split(step, model, opt,
                       train_batch(cfg, d["batch"], d["seq"], d["steps"],
                                   device), device)
    prof_batch = train_batch(cfg, d["batch"], d["seq"], d["steps"] + 1,
                             device)
    prof = device_profile(lambda: step(prof_batch), device)
    roofline = roofline_record(counts, f"{d['arch']}/train", res["step_ms"])
    emit({"train": {"arch": d["arch"], "params": count_params(model),
                    "roofline": roofline,
                    "layers": cfg.n_layers, "d_model": cfg.d_model,
                    **{k: d[k] for k in ("batch", "seq", "microbatches",
                                         "remat", "chunk", "steps", "lr",
                                         "warmup")},
                    "losses": res["losses"], "grad_norms": res["grad_norms"],
                    "step_ms": res["step_ms"], "tok_s": res["tok_s"],
                    "mfu": mfu(cfg, model, d["batch"], d["seq"],
                               res["step_ms"]),
                    "split": split, "max_memory_allocated": train_peak,
                    "card": CARD}})
    emit({"train": {"arch": d["arch"], "profile": prof, "card": CARD}})
    full_run = {"losses": res["losses"], "step_ms": res["step_ms"]}
    del model, opt, res, step, batch, prof_batch
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    # the reference's loss property (test_training_loss_decreases)
    d = TRAIN_LOSS
    with contextlib.redirect_stdout(sys.stderr):
        res = train.main(train_argv(d["arch"], d, TRAIN_DIR / "loss",
                                    device, reduced=True))
    check_uninterrupted(res, d["steps"], f"train reduced {d['arch']}")
    losses = res["losses"]
    emit({"train": {"arch": d["arch"], "reduced": True, "steps": d["steps"],
                    "loss_first": losses[0], "loss_last": losses[-1],
                    "step_ms": res["step_ms"], "card": CARD}})
    check(losses[-1] < losses[0] - 0.5,
          f"train reduced {d['arch']}: loss {losses[0]:.3f} -> "
          f"{losses[-1]:.3f} drops by more than 0.5")

    # the restart path: test_training_restart_path's argv (checkpoints
    # every 4 steps, so each restore lands on the step that failed), then
    # checkpoints every 3 steps, so the restores re-run steps 3 and 6-7;
    # every loss against an uninterrupted run's
    d = TRAIN_RESTART
    with contextlib.redirect_stdout(sys.stderr):
        clean = train.main(train_argv(d["arch"], d, TRAIN_DIR / "clean",
                                      device, reduced=True))
        runs = {every: train.main(
            train_argv(d["arch"], {**d, "save_every": every},
                       TRAIN_DIR / f"restart_{every}", device, reduced=True)
            + ["--simulate-failures"]) for every in (d["save_every"], 3)}
    check_uninterrupted(clean, d["steps"], f"train restart {d['arch']}")
    for every, res in runs.items():
        replay = max(abs(loss - clean["losses"][s]) / abs(clean["losses"][s])
                     for s, loss in zip(res["loss_steps"], res["losses"]))
        emit({"train": {"arch": d["arch"], "reduced": True,
                        "save_every": every,
                        "final_step": res["final_step"],
                        "restarts": res["restarts"],
                        "loss_steps": res["loss_steps"],
                        "rel_diff_to_uninterrupted": replay, "card": CARD}})
        check(res["final_step"] == d["steps"] and res["restarts"] == 2
              and res["loss_steps"] == TRAIN_RESTART_STEPS[every]
              and replay < TRAIN_REPLAY,
              f"train restart path, checkpoints every {every}: step "
              f"{res['final_step']}, {res['restarts']} restarts, steps run "
              f"{res['loss_steps']}, losses within {TRAIN_REPLAY} of an "
              f"uninterrupted run's ({replay:.3e})")
    return full_run


def run_dp(device: str, full_run: dict) -> None:
    """The dp phase (a ``{"dp": ...}`` line): ``launch.train
    --data-parallel 1`` on the card (an NCCL group of one, the debug mesh
    and the logical rules installed, the gradients reduce-scattered onto
    the FSDP shards, AdamW on the shards) at TRAIN_FULL's argv for
    DP_STEPS steps; its losses against the train phase's uninterrupted
    run at the same steps (the learning rate of the steps before them is
    the same warmup in both), its step ms beside that run's and the
    counted bytes of one step's gradient reduction."""
    import contextlib
    import torch
    d = {**TRAIN_FULL, "steps": DP_STEPS}
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import Model
    peak_reset(device)
    with contextlib.redirect_stdout(sys.stderr):
        res = train.main(train_argv(d["arch"], d, TRAIN_DIR / "dp", device)
                         + ["--data-parallel", "1"])
    check_uninterrupted(res, d["steps"], f"dp {d['arch']}")
    ref = full_run["losses"][:d["steps"]]
    diff = max(abs(a - b) / abs(b) for a, b in zip(res["losses"], ref))
    red = res["grad_reduction"]
    meta = Model(get_config(d["arch"]), device="meta")
    param_bytes = 4 * sum(p.numel() for p in meta.parameters())
    emit({"dp": {"arch": d["arch"], "data_parallel": 1,
                 "backend": "nccl" if device == "cuda" else "gloo",
                 "steps": d["steps"], "losses": res["losses"],
                 "train_losses": ref, "rel_diff_to_train": diff,
                 "step_ms": res["step_ms"],
                 "train_step_ms": full_run["step_ms"],
                 "grad_reduce_scatter_bytes":
                     red["collective_bytes"]["reduce-scatter"],
                 "grad_all_reduce_bytes":
                     red["collective_bytes"]["all-reduce"],
                 "grad_collective_count": red["collective_count"],
                 "param_bytes_fp32": param_bytes,
                 "max_memory_allocated": peak(device), "card": CARD}})
    check(diff < DP_AGREE,
          f"dp: losses within {DP_AGREE} of the train phase's ({diff:.3e})")
    rs = red["collective_bytes"]
    check(rs["reduce-scatter"] > 0.9 * param_bytes
          and rs["reduce-scatter"] + rs["all-reduce"] == param_bytes
          and rs["all-gather"] == 0,
          f"dp: each fp32 gradient reduced once, the matrices by "
          f"reduce-scatter ({rs}, {param_bytes} bytes of parameters)")
    del res
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()


def finish_dryrun(bg: dict) -> None:
    """The dryrun phase (``{"dryrun": ...}`` lines): the dry-run CLI's
    DRYRUN_CELLS, run by ``start_background`` in subprocesses that see no
    card (their fake process groups never meet this process's NCCL one):
    one line per cell with its terms, memory per device and build
    seconds; every cell ``ok`` with a useful ratio in (0, 1]."""
    for cell in DRYRUN_CELLS:
        arch, shape, multi_pod = cell
        wait_background(bg, cell)
        mesh = "2x16x16" if multi_pod else "16x16"
        rep = json.loads((DRYRUN_DIR / f"{arch}__{shape}__{mesh}.json")
                         .read_text())
        emit({"dryrun": {k: rep.get(k) for k in (
            "arch", "shape", "mesh", "status", "n_chips", "compile_seconds",
            "param_count", "active_param_count", "model_flops_global",
            "hlo_flops_per_chip", "hlo_bytes_per_chip",
            "collective_bytes_per_chip", "collective_breakdown", "terms",
            "bottleneck", "useful_ratio", "roofline_fraction", "memory",
            "collective_count")}})
        check(rep["status"] == "ok" and 0 < rep["useful_ratio"] <= 1,
              f"dryrun {arch} {shape} {mesh}: status {rep['status'][:200]}, "
              f"useful ratio {rep.get('useful_ratio')} in (0, 1]\n"
              f"{rep.get('traceback', '')[-2000:]}")
    log(f"dryrun cells done ({time.monotonic() - bg['t0']:.1f}s after "
        f"their start)")


def logits_at_index(model, tokens, index: int, chunk: int, audio=None):
    """float32 logits at ``index`` of a full forward (train mode, no
    cache) over ``tokens``, padded at the end to a multiple of ``chunk``
    (and of the SSD chunk): positions up to ``index`` see only what comes
    before them."""
    import torch
    from repro_torch.models import transformer as tfm
    cfg = model.cfg
    m = chunk
    if "ssd" in cfg.layer_pattern:
        m = m * cfg.ssm_chunk // np.gcd(m, cfg.ssm_chunk)
    s = tokens.shape[1]
    pad = -(-s // m) * m - s
    if pad:
        tokens = torch.cat([tokens, tokens[:, :pad]], dim=1)
    batch = {"tokens": tokens}
    if audio is not None:
        batch["audio_embed"] = audio
    with torch.no_grad():
        x = tfm.embed_tokens(cfg, model, tokens)
        enc, valid = tfm._cross(cfg, model, batch, chunk)
        h, _, _ = tfm.apply_stack(cfg, model.blocks, x, mode="train",
                                  cross_enc=enc, enc_valid=valid,
                                  attn_chunk=chunk)
        h = tfm.apply_norm(cfg, model.final_norm, h)
        return tfm.logits_at(cfg, model, h[:, index:index + 1])[:, 0]


def ssd_reference_form(device: str, seed: int) -> dict:
    """One SSD chunk of mamba2-780m's full size (256 steps, 48 heads of 64,
    state 128) at its initial decay (A = -1, dt = softplus(N(0, 1) - 1)):
    gradients through the reference's ``where(tri, exp(li), 0)`` and
    through the port's masked form, and their forward values."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import ssm
    cfg = get_config("mamba2-780m")
    g = torch.Generator(device=device).manual_seed(seed)
    q, h, p, n = cfg.ssm_chunk, cfg.ssm_heads, cfg.ssm_head_dim, \
        cfg.ssm_state

    def draw(*shape):
        return torch.randn(shape, generator=g, device=device)

    x, bm, cm = draw(1, q, h, p), draw(1, q, n), draw(1, q, n)
    da = -torch.nn.functional.softplus(draw(1, q, h) - 1.0)
    h0 = torch.zeros(1, h, n, p, device=device)

    def reference(h_prev, x_k, dt_k, b_k, c_k):
        cum = torch.cumsum(dt_k, dim=1)
        li = cum[:, :, None, :] - cum[:, None, :, :]
        tri = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                    device=device))
        l_mat = torch.where(tri[None, :, :, None], torch.exp(li), 0.0)
        scores = torch.einsum("bin,bjn->bij", c_k, b_k)
        u = x_k * (-dt_k)[..., None]
        y = torch.einsum("bijh,bjhp->bihp", scores[..., None] * l_mat, u)
        return y + torch.einsum("bin,bhnp,bih->bihp", c_k, h_prev,
                                torch.exp(cum))

    out = {"max_decay_sum": float(-da.sum(1).max())}
    for name, fn in (("reference", reference),
                     ("port", lambda *a: ssm._chunk_step(*a)[1])):
        xr = x.clone().requires_grad_()
        dr = da.clone().requires_grad_()
        y = fn(h0, xr, dr, bm, cm)
        y.sum().backward()
        out[name] = {"finite_values": bool(torch.isfinite(y).all()),
                     "finite_grads": bool(torch.isfinite(xr.grad).all()
                                          and torch.isfinite(dr.grad).all())}
        out[name + "_y"] = y.detach()
    out["values_rel_diff"] = rel_err(out.pop("port_y").cpu().numpy(),
                                     out.pop("reference_y").cpu().numpy())
    return out


def decode_vs_forward(model, s: dict, seed: int, device: str):
    """Serve ``s`` with ``model`` (through ``launch.serve`` when ``s``
    names requests, else one prefill of ``s["batch"] x s["prompt"]`` and
    ``s["gen"] - 1`` greedy decode steps), then a full forward over the
    last batch's prompt and generated tokens: (the last decode step's
    logits' error relative to ``max|logits|`` of the forward's at that
    position, the serving times)."""
    import contextlib
    import torch
    from repro_torch.launch import serve
    cfg = model.cfg
    if s.get("requests"):
        with contextlib.redirect_stdout(sys.stderr):
            res = serve.main(["--arch", cfg.name, "--requests",
                              str(s["requests"]), "--batch", str(s["batch"]),
                              "--prompt-len", str(s["prompt"]), "--gen-len",
                              str(s["gen"]), "--attn-chunk", str(s["chunk"]),
                              "--device", device], model=model)
        prompt = torch.as_tensor(res["prompts"][-1], device=device)
        gen = torch.as_tensor(res["outputs"][-1], device=device)
        audio = res["audio_embed"][-1] if cfg.is_encdec else None
        last = res["last_logits"][:prompt.shape[0]]
        times = {"requests": s["requests"], "tok_s": res["throughput_tok_s"],
                 "prefill_ms": res["prefill_ms"],
                 "decode_ms_per_token": res["decode_ms_per_token"],
                 "warm_prefill_ms": res["batch_prefill_ms"][-1],
                 "warm_decode_ms_per_token":
                     res["batch_decode_ms_per_token"][-1]}
    else:
        prompt = torch.as_tensor(np.random.default_rng(seed).integers(
            1, cfg.vocab_size, (s["batch"], s["prompt"])), device=device)
        sync(device)
        t0 = time.monotonic()
        logits, cache = model.prefill({"tokens": prompt},
                                      attn_chunk=s["chunk"],
                                      cache_len=s["prompt"] + s["gen"])
        tok = torch.argmax(logits, -1)
        sync(device)
        t1 = time.monotonic()
        toks = [tok]
        for j in range(s["gen"] - 1):
            logits, cache = model.decode(cache, tok, s["prompt"] + j)
            tok = torch.argmax(logits, -1)
            toks.append(tok)
        sync(device)
        gen, audio, last = torch.stack(toks, 1), None, logits
        times = {"prefill_ms": (t1 - t0) * 1e3,
                 "decode_ms_per_token": (time.monotonic() - t1) * 1e3
                 / max(s["gen"] - 1, 1)}
    toks = torch.cat([prompt, gen[:, :-1]], dim=1)
    fwd = logits_at_index(model, toks, toks.shape[1] - 1, s["chunk"], audio)
    check(bool(torch.isfinite(last).all()),
          f"{cfg.name}: finite decode logits")
    return rel_err(last.float().cpu().numpy(),
                   fwd.float().cpu().numpy()), times


def run_families(device: str, seed: int, counts: dict) -> None:
    """The families phase (``{"families": ...}`` lines): mamba2-780m and
    whisper-large-v3 at full size served through ``launch.serve``,
    recurrentgemma-9b (depth cut to one group) and qwen2-vl-72b (depth cut
    to one layer) at full width prefilled and decoded; each with the
    decode-versus-forward check on its last batch at the config's bf16
    compute and again at float32 compute on the same weights; then train
    steps through ``launch.train`` for all but qwen2-vl."""
    import contextlib
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import Model, count_params

    for i, (arch, d) in enumerate(FAMILIES.items()):
        full_cfg = get_config(arch)
        cfg = lm_cfg(arch, d.get("cut", {}))
        model = Model(cfg, device=device).init(seed=seed + i)
        s = d["serve"]
        peak_reset(device)
        e, times = decode_vs_forward(model, s, seed + i, device)
        rec = {"arch": arch, "family": cfg.family,
               "params": count_params(model), "layers": cfg.n_layers,
               "d_model": cfg.d_model,
               "cut": ({k: [getattr(full_cfg, k), v] for k, v in
                        d["cut"].items()} if d.get("cut") else None),
               **times, "batch": s["batch"], "prompt": s["prompt"],
               "gen": s["gen"], "attn_chunk": s["chunk"],
               "decode_vs_forward_rel_err": e,
               "serve_max_memory_allocated": peak(device)}
        # the same check at float32 compute on the same weights
        m32 = Model(dataclasses.replace(cfg, compute_dtype="float32"),
                    device=device)
        m32.load_state_dict(model.state_dict())
        rec["decode_vs_forward_rel_err_fp32"], _ = decode_vs_forward(
            m32, s, seed + i, device)
        del m32
        rec["roofline"] = {
            "prefill": roofline_record(
                counts, f"{arch}/prefill",
                times.get("warm_prefill_ms", times["prefill_ms"])),
            "decode": roofline_record(
                counts, f"{arch}/decode",
                times.get("warm_decode_ms_per_token",
                          times["decode_ms_per_token"]))}
        check(rec["decode_vs_forward_rel_err_fp32"] < TOL
              and e < d.get("bf16_tol", BF16_TOL),
              f"families {arch}: decode vs forward {e:.3e} (bf16), "
              f"{rec['decode_vs_forward_rel_err_fp32']:.3e} (fp32)")
        t = d.get("train")
        if t:
            gc.collect()
            peak_reset(device)
            with contextlib.redirect_stdout(sys.stderr):
                tr = train.main(train_argv(arch, t, TRAIN_DIR / arch,
                                           device), model=model)
            check_uninterrupted(tr, t["steps"], f"families {arch}")
            rec["train"] = {**{k: t[k] for k in ("batch", "seq", "steps",
                                                 "remat", "chunk")},
                            "losses": tr["losses"],
                            "grad_norms": tr["grad_norms"],
                            "step_ms": tr["step_ms"], "tok_s": tr["tok_s"],
                            "mfu": mfu(cfg, model, t["batch"], t["seq"],
                                       tr["step_ms"]),
                            "max_memory_allocated": peak(device)}
            rec["roofline"]["train"] = roofline_record(
                counts, f"{arch}/train", tr["step_ms"])
            del tr
        if arch == "mamba2-780m":
            sd = rec["ssd_decay"] = ssd_reference_form(device, seed)
            check(sd["port"]["finite_values"] and sd["port"]["finite_grads"]
                  and sd["values_rel_diff"] < TOL,
                  f"families {arch}: SSD's masked decay gives finite "
                  f"values and grads, values within {TOL} of the "
                  f"reference form's ({sd})")
        emit({"families": {**rec, "card": CARD}})
        del model
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()

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
        timer, charloop_corpus: dict = CHARLOOP_CORPUS) -> dict:
    """All phases on ``device``, each followed by its guard line; returns
    the ``kernels`` record."""
    from repro_torch.core import gen_spatial, gen_zipf
    from repro_torch.sparse import content_key
    clock = [time.monotonic()]

    def done(phase: str) -> None:
        """A phase's memory and guard lines, and its seconds."""
        memory_line(phase, device)
        guard_line(phase)
        now = time.monotonic()
        emit({"phase_s": {"phase": phase, "seconds": now - clock[0]}})
        clock[0] = now

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
    done("matvec")

    r, tuners = run_selector(device, serve_n,
                             [(n, spatial if n == spatial_n else None)
                              for n in unserved_ns], members, seed, timer)
    for name, recs in r.items():
        results[name] += recs
    done("selector")

    r, l, served = run_engine(device, engine_pop, timer)
    for name, recs in r.items():
        results[name] += recs
    for name, n in l.items():
        launches[name] += n
    done("engine")

    population = served["population"]
    l = run_charloop(device, tuners, population, served.pop("store"),
                     charloop_corpus)
    for name, n in l.items():
        launches[name] += n
    done("charloop")

    r, l = run_mutate(device, spatial, tuners[1], population, seed, timer)
    for name, recs in r.items():
        results[name] += recs
    for name, n in l.items():
        launches[name] += n
    done("mutate")

    for name, n in run_sharded(device, spatial, zipf, tuners[1], population,
                               seed, timer).items():
        launches[name] += n
    done("sharded")

    # host-only work (roofline counts, dry-run cells) beside the kernel
    # phases, whose times are CUDA events
    bg = start_background(Path(__file__).resolve().parent)

    # each with the library call that computes A @ A on it
    gemm_inputs = [{"name": f"spatial_{gemm_n}_bs32",
                    "A": gen_spatial(gemm_n, seed=seed), "bs": 32,
                    "library": "csr"},
                   {"name": f"zipf_{zipf_n}_bs128", "A": zipf, "bs": 128,
                    "library": "dense"}]
    r, l = run_spgemm(device, gemm_inputs, members, member_keys, seed, timer)
    results.update(r)
    launches.update(l)
    done("spgemm")

    add_inputs = [{"name": f"spatial_{spatial_n}_bs32+seed1", "A": spatial,
                   "B": gen_spatial(spatial_n, seed=seed + 1), "bs": 32},
                  {"name": f"zipf_{zipf_n}_bs128+seed1", "A": zipf,
                   "B": gen_zipf(zipf_n, seed=seed + 1), "bs": 128}]
    add_pairs = [(m, gen_zipf(n, seed=100 + i))
                 for i, (m, n) in enumerate(zip(members, bucket_ns))]
    r, l = run_spadd(device, add_inputs, add_pairs, seed, timer)
    results.update(r)
    launches.update(l)
    done("spadd")

    for phase, fn, dims in (("moe", run_moe, MOE_DIMS),
                            ("flash", run_flash, FLASH_DIMS)):
        r, l = fn(device, dims, seed, timer)
        results.update(r)
        launches.update(l)
        done(phase)

    counts = roofline_counts(bg)
    for name, n in run_lm(device, seed, counts).items():
        launches[name] += n
    done("lm")

    full_run = run_train(device, seed, counts)
    done("train")

    run_dp(device, full_run)
    done("dp")

    run_families(device, seed, counts)
    done("families")

    finish_dryrun(bg)

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
    global CARD
    card = CARD = card_line()
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
