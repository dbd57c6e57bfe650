"""The SpChar characterization loop (§3.5, Fig. 9/12/15), the port's copy
of ``repro.core.charloop`` (numpy only, over the port's own ``metrics``,
``perfmodel``, ``decision_tree``, ``dataset`` and ``platforms``).

Pipeline:
  1. For every (matrix, kernel, platform): compute static input metrics
     (metrics.py, the 'tail'), schedule counters (counters.py, the PMC
     analogue / 'head'), and modeled targets (perfmodel.py: GFLOPS /
     bandwidth / throughput).
  2. Train a DecisionTreeRegressor per (kernel x platform x target) slice.
  3. Validate with 10-fold CV (MAPE / R^2, Fig. 5-6).
  4. Extract Gini importances and *compare across platforms*: features
     important on every platform are algorithm-intrinsic; features whose
     importance varies are architecture-induced (§3.5's escape from the
     correlation-implies-causation dilemma).
  5. (autotune.py) use the trained trees as fast performance estimators to
     select kernel schedules — the loop "facilitating optimization". The
     serving form of this step is the plan/execute facade: a fitted tuner
     plugs straight into ``repro_torch.sparse.plan(op, operands,
     selector=tuner)``, which preps the chosen container on the card and
     returns the launch.

``platforms=None`` means the port's ``PLATFORMS``: ``A100_SXM``,
``H100_SXM`` and ``L40S``, three generations that differ in memory
technology, L2 size and memory-level parallelism, as the reference's three
TPU records do. ``compare_platforms`` splits each kernel's top features
over them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .csr import CSR
from . import metrics as metrics_mod
from .decision_tree import DecisionTreeRegressor, kfold_cv, importance_report
from .dataset import Matrix
from .perfmodel import run_spmv_model, run_spgemm_model, run_spadd_model
from .platforms import Platform, PLATFORMS

TARGETS = ("gflops", "bandwidth_gbps", "throughput_miters")
# Counter features exposed to the trees (PMC analogue; DESIGN.md §2 table).
COUNTER_FEATURES = ("padding_fraction", "vmem_miss_rate", "grid_imbalance")


def _run_kernel_model(kernel: str, A: CSR, platform: Platform, block_size: int):
    if kernel == "spmv":
        return run_spmv_model(A, platform, block_size)
    if kernel == "spgemm":
        return run_spgemm_model(A, A, platform, block_size)
    if kernel == "spadd":
        B = A.transpose() if A.shape[0] == A.shape[1] else A
        return run_spadd_model(A, B, platform, block_size)
    raise ValueError(f"unknown kernel {kernel!r}")


@dataclasses.dataclass
class SliceData:
    kernel: str
    platform: str
    feature_names: List[str]
    X: np.ndarray
    y: Dict[str, np.ndarray]          # target name -> vector
    names: List[str]
    domains: List[str]
    times: List[Dict[str, float]]     # perfmodel time breakdowns
    counters: List[Dict[str, float]]


def build_slice(kernel: str, mats: Sequence[Matrix], platform: Platform,
                block_size: int = 128) -> SliceData:
    feats: List[List[float]] = []
    ys: Dict[str, List[float]] = {t: [] for t in TARGETS}
    names, domains, times, counters = [], [], [], []
    feature_names: Optional[List[str]] = None
    for name, domain, A in mats:
        static = metrics_mod.characterize(A)
        c, t, tg = _run_kernel_model(kernel, A, platform, block_size)
        row_feats = dict(static)
        for k in COUNTER_FEATURES:
            if k in c:
                row_feats[f"pmc_{k}"] = float(c[k])
        # Traffic/volume counters enter in log-space, like the paper's raw
        # PMC magnitudes (bytes moved, instructions retired).
        row_feats["pmc_log_hbm_bytes"] = float(np.log10(max(c["hbm_bytes"], 1.0)))
        row_feats["pmc_log_executed_flops"] = float(
            np.log10(max(c["executed_flops"], 1.0)))
        row_feats["pmc_gather_share"] = float(
            c["gather_bytes"] / max(c["hbm_bytes"], 1.0))
        if feature_names is None:
            feature_names = list(row_feats)
        feats.append([row_feats[k] for k in feature_names])
        for tgt in TARGETS:
            ys[tgt].append(tg[tgt])
        names.append(name)
        domains.append(domain)
        times.append(t)
        counters.append(c)
    return SliceData(kernel, platform.name, feature_names or [],
                     np.asarray(feats), {k: np.asarray(v) for k, v in ys.items()},
                     names, domains, times, counters)


@dataclasses.dataclass
class CharacterizationResult:
    kernel: str
    platform: str
    target: str
    cv: Dict[str, float]
    importances: List[Tuple[str, float]]
    tree: DecisionTreeRegressor
    feature_names: List[str]


def characterize_slice(data: SliceData, target: str = "gflops", k: int = 10,
                       **tree_kwargs) -> CharacterizationResult:
    y = data.y[target]
    cv = kfold_cv(data.X, y, k=k, **tree_kwargs)
    # Paper: for feature extraction, train on the entire dataset (§4.3).
    tree = DecisionTreeRegressor(**tree_kwargs).fit(data.X, y)
    imps = importance_report(tree, data.feature_names, top=len(data.feature_names))
    return CharacterizationResult(data.kernel, data.platform, target, cv, imps,
                                  tree, data.feature_names)


def characterize_all(mats: Sequence[Matrix],
                     kernels: Sequence[str] = ("spmv", "spgemm", "spadd"),
                     platforms: Optional[Mapping[str, Platform]] = None,
                     target: str = "gflops", k: int = 10,
                     **tree_kwargs) -> List[CharacterizationResult]:
    platforms = platforms or PLATFORMS
    out = []
    for kern in kernels:
        for plat in platforms.values():
            data = build_slice(kern, mats, plat)
            out.append(characterize_slice(data, target, k=k, **tree_kwargs))
    return out


# ---------------------------------------------------------------------------
# Cross-platform comparison (§3.5: presence/absence across models)
# ---------------------------------------------------------------------------

def compare_platforms(results: Sequence[CharacterizationResult], top: int = 5,
                      ) -> Dict[str, Dict[str, List[str]]]:
    """Per kernel: features in every platform's top-N (algorithm-intrinsic)
    vs features specific to some platforms (architecture-induced).

    The split needs a slice per platform for each kernel: over one record
    every top feature would be algorithm-intrinsic."""
    by_kernel: Dict[str, Dict[str, List[str]]] = {}
    kernels = sorted({r.kernel for r in results})
    for kern in kernels:
        slices = [r for r in results if r.kernel == kern]
        tops = [set(n for n, _ in r.importances[:top]) for r in slices]
        common = set.intersection(*tops) if tops else set()
        union = set.union(*tops) if tops else set()
        by_kernel[kern] = {
            "algorithm_intrinsic": sorted(common),
            "architecture_induced": sorted(union - common),
        }
    return by_kernel


def top_feature(result: CharacterizationResult) -> str:
    return result.importances[0][0] if result.importances else ""


def grouped_importance(result: CharacterizationResult) -> Dict[str, float]:
    """Aggregate importances into the paper's reporting buckets."""
    groups = {
        "locality": ("reuse_affinity", "index_affinity", "pmc_vmem_miss_rate"),
        "branch/irregularity": ("branch_entropy", "cv_row_length",
                                "pmc_padding_fraction", "pmc_grid_imbalance"),
        "imbalance": tuple(f"thread_imbalance_t{t}" for t in metrics_mod.THREAD_SWEEP),
        "size": ("log_nnz", "log_rows", "density", "mean_row_length"),
    }
    out = {g: 0.0 for g in groups}
    for name, imp in result.importances:
        for g, members in groups.items():
            if name in members:
                out[g] += imp
                break
    return out
