"""CART decision-tree regressor with Gini (variance-reduction) importances.

The port's own copy of ``repro.core.decision_tree`` (numpy only).

This is the paper's analysis engine (§3.5): regressors trained per
(kernel x platform) slice, target = GFLOPS/bandwidth/throughput, validated
with K-fold cross-validation (MAPE, Fig. 5; residual bias + R^2, Fig. 6),
and mined for splitting-attribute importances (Fig. 9/12/15).

No sklearn in this container -> implemented from first principles on numpy.
Importance here is the standard impurity-decrease ("Gini") importance: the
sum over nodes of  n_node/n_total * (var_node - weighted child var),
attributed to the split feature and normalized to sum to 1.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class _Node:
    feature: int = -1          # -1 => leaf
    threshold: float = 0.0
    left: int = -1
    right: int = -1
    value: float = 0.0         # mean target at node
    n: int = 0
    impurity_decrease: float = 0.0


class DecisionTreeRegressor:
    def __init__(
        self,
        max_depth: int = 12,
        min_samples_split: int = 8,
        min_samples_leaf: int = 3,
        max_thresholds: int = 64,
        seed: int = 0,
    ) -> None:
        self.max_depth = max_depth
        self.min_samples_split = min_samples_split
        self.min_samples_leaf = min_samples_leaf
        self.max_thresholds = max_thresholds
        self.seed = seed
        self.nodes: List[_Node] = []
        self.n_features_: int = 0
        self.feature_importances_: Optional[np.ndarray] = None

    # ------------------------------------------------------------------ fit
    def fit(self, X: np.ndarray, y: np.ndarray) -> "DecisionTreeRegressor":
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        if X.ndim != 2 or y.ndim != 1 or X.shape[0] != y.shape[0]:
            raise ValueError("X must be (n, d); y must be (n,)")
        self.n_features_ = X.shape[1]
        self.nodes = []
        n_total = X.shape[0]
        self._grow(X, y, depth=0, n_total=n_total)
        imp = np.zeros(self.n_features_)
        for node in self.nodes:
            if node.feature >= 0:
                imp[node.feature] += node.impurity_decrease
        total = imp.sum()
        self.feature_importances_ = imp / total if total > 0 else imp
        return self

    def _grow(self, X: np.ndarray, y: np.ndarray, depth: int, n_total: int) -> int:
        idx = len(self.nodes)
        node = _Node(value=float(y.mean()), n=y.shape[0])
        self.nodes.append(node)
        if (
            depth >= self.max_depth
            or y.shape[0] < self.min_samples_split
            or np.allclose(y, y[0])
        ):
            return idx
        best = self._best_split(X, y)
        if best is None:
            return idx
        feat, thr, gain = best
        mask = X[:, feat] <= thr
        if not mask.any() or mask.all():  # NaN features or degenerate split
            return idx
        node.feature = feat
        node.threshold = thr
        node.impurity_decrease = gain * (y.shape[0] / n_total)
        node.left = self._grow(X[mask], y[mask], depth + 1, n_total)
        node.right = self._grow(X[~mask], y[~mask], depth + 1, n_total)
        return idx

    def _best_split(
        self, X: np.ndarray, y: np.ndarray
    ) -> Optional[Tuple[int, float, float]]:
        n = y.shape[0]
        parent_var = y.var()
        if parent_var <= 0:
            return None
        best_gain, best_feat, best_thr = 0.0, -1, 0.0
        for f in range(X.shape[1]):
            xf = X[:, f]
            order = np.argsort(xf, kind="stable")
            xs, ys = xf[order], y[order]
            # candidate thresholds between distinct consecutive values
            distinct = np.nonzero(np.diff(xs))[0]
            if distinct.size == 0:
                continue
            if distinct.size > self.max_thresholds:
                sel = np.linspace(0, distinct.size - 1, self.max_thresholds).astype(int)
                distinct = distinct[sel]
            csum = np.cumsum(ys)
            csum2 = np.cumsum(ys * ys)
            total, total2 = csum[-1], csum2[-1]
            for i in distinct:
                nl = i + 1
                nr = n - nl
                if nl < self.min_samples_leaf or nr < self.min_samples_leaf:
                    continue
                sl, sl2 = csum[i], csum2[i]
                sr, sr2 = total - sl, total2 - sl2
                var_l = sl2 / nl - (sl / nl) ** 2
                var_r = sr2 / nr - (sr / nr) ** 2
                gain = parent_var - (nl * var_l + nr * var_r) / n
                if gain > best_gain:
                    best_gain = gain
                    best_feat = f
                    best_thr = float((xs[i] + xs[i + 1]) / 2)
        if best_feat < 0:
            return None
        return best_feat, best_thr, best_gain

    # -------------------------------------------------------------- predict
    def predict(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, dtype=np.float64)
        out = np.empty(X.shape[0])
        for i in range(X.shape[0]):
            n = 0
            while self.nodes[n].feature >= 0:
                node = self.nodes[n]
                n = node.left if X[i, node.feature] <= node.threshold else node.right
            out[i] = self.nodes[n].value
        return out

    def depth(self) -> int:
        def _d(i: int) -> int:
            node = self.nodes[i]
            if node.feature < 0:
                return 1
            return 1 + max(_d(node.left), _d(node.right))

        return _d(0) if self.nodes else 0


# ---------------------------------------------------------------------------
# Evaluation protocol (paper §4.1)
# ---------------------------------------------------------------------------

def mape(y_true: np.ndarray, y_pred: np.ndarray, eps: float = 1e-12) -> float:
    """Mean Absolute Percentage Error (Fig. 5)."""
    y_true = np.asarray(y_true, dtype=np.float64)
    y_pred = np.asarray(y_pred, dtype=np.float64)
    return float(np.mean(np.abs(y_pred - y_true) / np.maximum(np.abs(y_true), eps)))


def r2_score(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """Coefficient of determination (Fig. 6: paper reports >= 0.8)."""
    y_true = np.asarray(y_true, dtype=np.float64)
    y_pred = np.asarray(y_pred, dtype=np.float64)
    ss_res = np.sum((y_true - y_pred) ** 2)
    ss_tot = np.sum((y_true - y_true.mean()) ** 2)
    return float(1.0 - ss_res / ss_tot) if ss_tot > 0 else 1.0


def kfold_cv(
    X: np.ndarray,
    y: np.ndarray,
    k: int = 10,
    seed: int = 0,
    **tree_kwargs,
) -> Dict[str, float]:
    """10-fold CV exactly as §4.1: returns mean MAPE / R^2 / median residual."""
    X = np.asarray(X, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    n = X.shape[0]
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    folds = np.array_split(perm, k)
    mapes, r2s, residuals = [], [], []
    for i in range(k):
        test_idx = folds[i]
        train_idx = np.concatenate([folds[j] for j in range(k) if j != i])
        tree = DecisionTreeRegressor(**tree_kwargs).fit(X[train_idx], y[train_idx])
        pred = tree.predict(X[test_idx])
        mapes.append(mape(y[test_idx], pred))
        r2s.append(r2_score(y[test_idx], pred))
        scale = max(float(np.abs(y).max()), 1e-12)
        residuals.extend(((pred - y[test_idx]) / scale).tolist())
    return {
        "mape": float(np.mean(mapes)),
        "r2": float(np.mean(r2s)),
        "median_abs_norm_residual": float(np.median(np.abs(residuals))),
    }


def importance_report(
    tree: DecisionTreeRegressor, feature_names: Sequence[str], top: int = 10
) -> List[Tuple[str, float]]:
    imp = tree.feature_importances_
    order = np.argsort(imp)[::-1][:top]
    return [(feature_names[i], float(imp[i])) for i in order if imp[i] > 0]
