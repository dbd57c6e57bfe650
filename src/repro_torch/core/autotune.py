"""Characterization-loop-driven kernel autotuning (the port's own copy of
``repro.core.autotune``, numpy only).

The paper's motivation for tree models over simulators: "estimate the
performance and impact of an architectural change *quickly*" (§1). We close
the loop: a tree trained on (static metrics + candidate schedule params) ->
modeled time becomes a microsecond-scale cost model; at run time we sweep
the candidate schedules through the tree and pick the argmin — optionally
verifying the winner with the full schedule simulation.

The ``SelectorService`` serves SpMV/SpMM schedules from a fitted
``ScheduleTuner``; ``select_moe_block_size`` is the MoE decode tile rule.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .csr import CSR
from . import metrics as metrics_mod
from .decision_tree import DecisionTreeRegressor
from .dataset import Matrix
from .perfmodel import (run_spadd_model, run_spgemm_model, run_spmv_model,
                        run_spmv_sell_model)
from .platforms import Platform

BLOCK_SIZES = (32, 64, 128, 256)
ELL_QUANTILES = (0.8, 0.95, 1.0)
SLICE_HEIGHTS = (4, 8, 16)      # SELL slice heights swept as a schedule axis
SELL_SIGMA = 64                 # sorting window (block-rows); fixed, not swept
DENSE_DENSITY_THRESHOLD = 0.25  # above this, a dense matmul wins trivially
TUNER_TREE_DEPTH = 14           # cost-tree depth shared by fit() and refit()
# fit(prune_top_k="auto"): grids past this size prune themselves with the
# provisional tree (ROADMAP item — fit cost must not scale with the full
# layout x block_size x quantile x slice_height product as axes grow).
PRUNE_GRID_THRESHOLD = 50
AUTO_PRUNE_TOP_K = 8
# Names of the schedule-parameter features appended to the static metrics.
CFG_FEATURES = ("cfg_block_size", "cfg_ell_quantile", "cfg_slice_height",
                "cfg_n_rhs")


@dataclasses.dataclass(frozen=True)
class Schedule:
    backend: str          # "dense" | "bsr"
    block_size: int
    ell_quantile: float
    layout: str = "ell"   # "ell" (global padding) | "sell" (sliced)
    slice_height: int = 0  # SELL C; 0 = n/a for the global-ELL layout
    n_rhs: int = 1        # RHS tile width (1 = SpMV, >1 = the SpMM path)

    def as_features(self) -> List[float]:
        return [float(self.block_size), float(self.ell_quantile),
                float(self.slice_height), float(self.n_rhs)]


def candidate_schedules(n_rhs: int = 1) -> List[Schedule]:
    ell = [Schedule("bsr", bs, q, n_rhs=n_rhs)
           for bs, q in itertools.product(BLOCK_SIZES, ELL_QUANTILES)]
    sell = [Schedule("bsr", bs, 1.0, layout="sell", slice_height=c, n_rhs=n_rhs)
            for bs, c in itertools.product(BLOCK_SIZES, SLICE_HEIGHTS)]
    return ell + sell


def _modeled_time(kernel: str, A: CSR, platform: Platform, sched: Schedule) -> float:
    if kernel == "spmv":
        if sched.layout == "sell":
            _, t, _ = run_spmv_sell_model(A, platform, sched.block_size,
                                          sched.slice_height, SELL_SIGMA,
                                          sched.n_rhs)
        else:
            _, t, _ = run_spmv_model(A, platform, sched.block_size,
                                     sched.ell_quantile, sched.n_rhs)
    elif kernel == "spgemm":
        _, t, _ = run_spgemm_model(A, A, platform, sched.block_size)
    else:
        B = A.transpose() if A.shape[0] == A.shape[1] else A
        _, t, _ = run_spadd_model(A, B, platform, sched.block_size)
    return t["t_total"]


class ScheduleTuner:
    """Tree-backed cost model over (matrix metrics, schedule params)."""

    def __init__(self, kernel: str, platform: Platform, n_rhs: int = 1) -> None:
        self.kernel = kernel
        self.platform = platform
        self.n_rhs = max(int(n_rhs), 1)  # workload RHS width (SpMM path)
        self.tree: Optional[DecisionTreeRegressor] = None
        self.feature_names: List[str] = []
        self.fit_simulations_ = 0
        # Training rows kept so refit() can fold in online feedback
        # (SelectorService.retraining_examples) without re-simulating.
        self._train_rows: Optional[np.ndarray] = None
        self._train_ys: Optional[np.ndarray] = None

    def fit(self, mats: Sequence[Matrix], max_mats: int = 64, seed: int = 0,
            prune_top_k="auto", bootstrap_mats: int = 8,
            candidates: Optional[Sequence[Schedule]] = None
            ) -> "ScheduleTuner":
        """Train the cost tree on (static metrics, schedule params) rows.

        With ``prune_top_k`` set, the candidate sweep is itself pruned by the
        tree (ROADMAP item): the first ``bootstrap_mats`` matrices sweep every
        candidate and train a provisional tree; each later matrix only
        simulates the provisional tree's top-``k`` candidates, so fit() cost
        stops scaling with the full layout x block_size x quantile x
        slice_height product. ``fit_simulations_`` records the number of
        schedule simulations actually run.

        The default ``prune_top_k="auto"`` turns pruning on
        (``AUTO_PRUNE_TOP_K``) once the candidate grid exceeds
        ``PRUNE_GRID_THRESHOLD`` schedules and sweeps fully below it; pass
        an int to force a k or ``None`` to force the full sweep.
        ``candidates`` overrides the swept grid (defaults to
        ``candidate_schedules(n_rhs)``).
        """
        rng = np.random.default_rng(seed)
        idx = rng.permutation(len(mats))[:max_mats]
        candidates = (candidate_schedules(self.n_rhs) if candidates is None
                      else list(candidates))
        if isinstance(prune_top_k, str):
            if prune_top_k != "auto":
                raise ValueError(f"prune_top_k must be an int, None, or "
                                 f"'auto', got {prune_top_k!r}")
            prune_top_k = (AUTO_PRUNE_TOP_K
                           if len(candidates) > PRUNE_GRID_THRESHOLD else None)
        rows, ys = [], []
        feature_names: Optional[List[str]] = None
        provisional: Optional[DecisionTreeRegressor] = None
        self.fit_simulations_ = 0
        for count, i in enumerate(idx):
            _, _, A = mats[int(i)]
            static = metrics_mod.characterize(A)
            if feature_names is None:
                feature_names = list(static) + list(CFG_FEATURES)
            base = [static[k] for k in feature_names[: -len(CFG_FEATURES)]]
            scheds = candidates
            if provisional is not None:
                k = max(int(prune_top_k), 1)
                scored = provisional.predict(np.asarray(
                    [base + s.as_features() for s in candidates]))
                scheds = [candidates[j] for j in np.argsort(scored)[:k]]
            for sched in scheds:
                rows.append(base + sched.as_features())
                ys.append(np.log10(max(_modeled_time(self.kernel, A, self.platform,
                                                     sched), 1e-12)))
                self.fit_simulations_ += 1
            if (prune_top_k is not None and provisional is None
                    and count + 1 >= min(bootstrap_mats, len(idx))):
                provisional = DecisionTreeRegressor(max_depth=TUNER_TREE_DEPTH).fit(
                    np.asarray(rows), np.asarray(ys))
        self.feature_names = feature_names or []
        self._train_rows = np.asarray(rows)
        self._train_ys = np.asarray(ys)
        self.tree = DecisionTreeRegressor(max_depth=TUNER_TREE_DEPTH).fit(
            self._train_rows, self._train_ys)
        return self

    def refit(self, extra_rows: Sequence[Sequence[float]],
              extra_ys: Sequence[float]) -> "ScheduleTuner":
        """Fold online feedback rows (same static+cfg feature space as
        ``fit``) into the training set and retrain the tree — the explicit
        retraining path ``SelectorService.refit`` drives; no simulation
        re-runs."""
        assert self.tree is not None, "call fit() before refit()"
        rows = np.concatenate([self._train_rows,
                               np.asarray(extra_rows, dtype=float)], axis=0)
        ys = np.concatenate([self._train_ys,
                             np.asarray(extra_ys, dtype=float)], axis=0)
        self._train_rows, self._train_ys = rows, ys
        self.tree = DecisionTreeRegressor(max_depth=TUNER_TREE_DEPTH).fit(rows, ys)
        return self

    def predict_time(self, static: Dict[str, float], sched: Schedule) -> float:
        assert self.tree is not None, "call fit() first"
        n_static = len(self.feature_names) - len(CFG_FEATURES)
        x = [static[k] for k in self.feature_names[:n_static]] + sched.as_features()
        return float(10 ** self.tree.predict(np.asarray([x]))[0])

    def select(self, A: CSR, verify_top: int = 2) -> Tuple[Schedule, Dict[str, float]]:
        """Pick the best schedule for ``A``; verify top candidates by simulation."""
        if A.density() > DENSE_DENSITY_THRESHOLD:
            return Schedule("dense", 128, 1.0, n_rhs=self.n_rhs), {"reason": 1.0}
        static = metrics_mod.characterize(A)
        scored = sorted(
            ((self.predict_time(static, s), s)
             for s in candidate_schedules(self.n_rhs)),
            key=lambda p: p[0])
        best_t, best_s = scored[0]
        # verification pass on the top candidates (tree is approximate)
        verified = [(_modeled_time(self.kernel, A, self.platform, s), s)
                    for _, s in scored[:verify_top]]
        verified.sort(key=lambda p: p[0])
        vt, vs = verified[0]
        return vs, {"tree_time_s": best_t, "verified_time_s": vt}


def select_moe_block_size(tokens_per_expert: np.ndarray, d_model: int,
                          platform: Platform) -> int:
    """MoE grouped-GEMM tile choice from the imbalance metric (Eq. 5 reuse).

    High expert imbalance -> smaller tiles waste less on ragged group tails;
    balanced routing -> full tiles. This mirrors the paper's finding that
    imbalance is the limiting factor for partitioned sparse work.
    """
    imb = metrics_mod.partition_imbalance(tokens_per_expert.astype(np.float64),
                                          max(len(tokens_per_expert), 1))
    if imb > 1.0:
        return 64
    if imb > 0.5:
        return 128
    return 256
