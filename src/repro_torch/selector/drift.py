"""Drift watchdog: re-fingerprint mutated matrices, quarantine stale
schedule-cache entries, auto-refit the selector (the port of
``repro.selector.drift``).

A cached schedule is a bet on the fingerprint it was selected under. Under
churn that bet decays two ways, and the ``DriftMonitor`` watches both:

* **Per-matrix drift** — every ``MutableMatrix.apply_delta`` calls
  ``observe``; the monitor re-characterizes the matrix and scores the mean
  absolute feature shift against the baseline fingerprint the cached
  schedule was chosen under (features are O(1)-magnitude — affinities and
  entropies in [0, 1], log sizes — so the mean shift is a uniform scale).
  Past ``drift_threshold`` the old ``ScheduleCache`` entry is quarantined
  (``cache.quarantine`` — the rounded fingerprint hash can survive drift
  that moved the real features, so the entry must not keep serving) and
  the baseline re-anchors on the current fingerprint.

* **Selector accuracy decay** — drift that crosses the threshold also
  re-scores the tree: the monitor compares ``predictor.predict`` against
  the modeled-time argmin (``service._verify``, the selector's own ground
  truth) on the drifted fingerprint, feeds the verified row into the
  retraining buffer, and tracks agreement over a rolling window. When the
  window's accuracy falls below ``accuracy_floor``, it triggers
  ``service.refit()`` — the shifted distribution has outrun the fitted
  tree, and the buffered examples are exactly the drifted corpus.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, Optional

from ..obs import default_registry, ordered, scoped_int
from ..obs import trace as obs_trace
from .fingerprint import Fingerprint, fingerprint
from .predictor import retraining_row


def drift_score(baseline: Fingerprint, current: Fingerprint) -> float:
    """Mean absolute per-feature shift between two fingerprints (shared
    features only; a feature present on one side counts as shift 1.0)."""
    keys = set(baseline.features) | set(current.features)
    if not keys:
        return 0.0
    total = 0.0
    for k in keys:
        a = baseline.features.get(k)
        b = current.features.get(k)
        total += 1.0 if a is None or b is None else abs(float(a) - float(b))
    return total / len(keys)


class DriftMonitor:
    """Watches ``MutableMatrix`` instances for fingerprint drift and keeps
    the selector honest about it (quarantine + auto-refit)."""

    checks = scoped_int("checks")
    drift_detections = scoped_int("drift_detections")
    quarantined_schedules = scoped_int("quarantined_schedules")
    accuracy_checks = scoped_int("accuracy_checks")
    accuracy_hits = scoped_int("accuracy_hits")
    auto_refits = scoped_int("auto_refits")

    def __init__(self, service, drift_threshold: float = 0.15,
                 accuracy_floor: float = 0.7, window: int = 16,
                 min_checks: int = 4,
                 refit_min_examples: Optional[int] = None) -> None:
        self._metrics = default_registry().scope("drift")
        self.service = service
        self.drift_threshold = float(drift_threshold)
        self.accuracy_floor = float(accuracy_floor)
        self.min_checks = max(int(min_checks), 1)
        self.refit_min_examples = refit_min_examples
        self._baselines: Dict[str, Fingerprint] = {}
        self._accuracy: "deque[bool]" = deque(maxlen=max(int(window), 1))

    # ------------------------------------------------------------ lifecycle
    def watch(self, mm) -> Fingerprint:
        """Anchor the baseline fingerprint for a (newly wrapped) mutable
        matrix — the fingerprint any cached schedule was selected under."""
        fp = fingerprint(mm.csr)
        self._baselines[mm.base_key] = fp
        return fp

    def observe(self, mm) -> float:
        """Post-mutation hook (called by ``MutableMatrix.apply_delta``):
        re-fingerprint, score drift, quarantine + re-anchor + re-score the
        tree past the threshold. Returns the drift score."""
        baseline = self._baselines.get(mm.base_key)
        if baseline is None:
            self.watch(mm)
            return 0.0
        current = fingerprint(mm.csr)
        score = drift_score(baseline, current)
        self.checks += 1
        obs_trace.emit("drift", mm.base_key[:12], base=mm.base_key,
                       score=score, generation=mm.generation,
                       threshold=self.drift_threshold)
        if score <= self.drift_threshold:
            return score
        self.drift_detections += 1
        if self.service.cache.quarantine(baseline.key):
            self.quarantined_schedules += 1
        self._baselines[mm.base_key] = current
        self._check_selection(current, mm.csr)
        return score

    # ------------------------------------------------------- accuracy decay
    def _check_selection(self, fp: Fingerprint, csr) -> None:
        """Score the tree's pick against the modeled-time argmin on the
        drifted fingerprint; feed the verified sweep to the retraining
        buffer and refit once the rolling accuracy falls through the
        floor."""
        from ..core.autotune import _modeled_time
        # predict_from_features, not predict: the dense-density
        # short-circuit is a rule, not the tree — only the tree's accuracy
        # is refittable.
        pred = self.service.predictor.predict_from_features(fp.features)
        tuner = self.service.tuner
        timed = sorted(
            ((_modeled_time(tuner.kernel, csr, tuner.platform, s), s)
             for _, s in self.service.predictor.rank(fp.features)),
            key=lambda p: p[0])
        t_best = timed[0][0]
        t_pred = _modeled_time(tuner.kernel, csr, tuner.platform,
                               pred.schedule)
        # Near-optimality, not schedule identity: modeled times tie across
        # many schedules, and any pick within 5% of the argmin is a good
        # selection.
        hit = t_pred <= t_best * 1.05
        self._accuracy.append(hit)
        self.accuracy_checks += 1
        if hit:
            self.accuracy_hits += 1
        # The whole timed sweep, not just the winner: fit() trains on one
        # row per (matrix, schedule) pair, so a corrective refit over the
        # drifted corpus needs the losers' times too.
        self.service.retraining_examples.extend(
            retraining_row(fp, s, t) for t, s in timed)
        if len(self._accuracy) < self.min_checks:
            return
        acc = sum(self._accuracy) / len(self._accuracy)
        if acc >= self.accuracy_floor:
            return
        min_ex = (self.refit_min_examples if self.refit_min_examples
                  is not None else min(self.service.refit_min_examples,
                                       len(self.service.retraining_examples)))
        result = self.service.refit(min_examples=max(int(min_ex), 1))
        if result.get("refit"):
            self.auto_refits += 1
            self._accuracy.clear()

    # ------------------------------------------------------ durability (§15)
    def export_state(self) -> Dict:
        """Checkpoint view: baseline fingerprints (the anchor every cached
        schedule's drift is scored against) and the rolling accuracy
        window — losing either across a restart would blind the watchdog
        to drift that happened before the crash."""
        return {
            "baselines": {
                bk: {"key": fp.key,
                     "canonical": [list(p) for p in fp.canonical],
                     "features": dict(fp.features),
                     "shape": list(fp.shape), "nnz": fp.nnz}
                for bk, fp in self._baselines.items()},
            "accuracy": [bool(b) for b in self._accuracy],
        }

    def restore_state(self, state: Dict) -> int:
        """Rebuild baselines + window from :meth:`export_state` output;
        malformed baselines are skipped, never raised. Returns baselines
        restored."""
        if not isinstance(state, dict):
            return 0
        n = 0
        for bk, d in (state.get("baselines") or {}).items():
            try:
                fp = Fingerprint(
                    key=str(d["key"]),
                    canonical=tuple((str(a), str(b))
                                    for a, b in d["canonical"]),
                    features={str(k): float(v)
                              for k, v in d["features"].items()},
                    shape=(int(d["shape"][0]), int(d["shape"][1])),
                    nnz=int(d["nnz"]))
            except (KeyError, TypeError, ValueError, IndexError):
                continue
            self._baselines[str(bk)] = fp
            n += 1
        for b in (state.get("accuracy") or []):
            self._accuracy.append(bool(b))
        return n

    # ------------------------------------------------------------ telemetry
    @property
    def rolling_accuracy(self) -> float:
        if not self._accuracy:
            return 1.0
        return sum(self._accuracy) / len(self._accuracy)

    def telemetry(self) -> Dict[str, float]:
        return ordered({
            "checks": float(self.checks),
            "drift_detections": float(self.drift_detections),
            "quarantined_schedules": float(self.quarantined_schedules),
            "accuracy_checks": float(self.accuracy_checks),
            "accuracy_hits": float(self.accuracy_hits),
            "auto_refits": float(self.auto_refits),
            "rolling_accuracy": self.rolling_accuracy,
            "watched": float(len(self._baselines)),
        })
