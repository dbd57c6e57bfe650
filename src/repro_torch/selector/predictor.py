"""Tree-backed online schedule prediction (the serving form of autotune;
port of ``repro.selector.predictor``).

``ScheduleTuner.fit`` already distills the schedule sweep into a decision
tree; here that tree is the *only* thing consulted on the hot path. One
prediction = |candidates| tree traversals over the fingerprint's static
features — microseconds, no counter simulation. The confidence score is the
relative margin between the best and the next-distinct predicted time: a
tree that routes the top candidates into one leaf cannot rank them (margin
0 -> confidence 0), which is exactly when the service should fall back to
the simulation verify pass.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

from ..core.autotune import (DENSE_DENSITY_THRESHOLD, Schedule, ScheduleTuner,
                             candidate_schedules)
from .fingerprint import Fingerprint


@dataclasses.dataclass(frozen=True)
class Prediction:
    schedule: Schedule
    confidence: float        # in [0, 1]; 0 = tree cannot rank the top picks
    tree_time_s: float       # predicted modeled time of the chosen schedule
    runner_up_time_s: float  # next-distinct predicted time (inf if none)


class SchedulePredictor:
    """Serve full ``Schedule`` objects from a trained tuner tree."""

    def __init__(self, tuner: ScheduleTuner) -> None:
        if tuner.tree is None:
            raise ValueError("tuner must be fit() before serving predictions")
        self.tuner = tuner
        self.candidates: List[Schedule] = candidate_schedules(tuner.n_rhs)

    def _scores(self, features: Mapping[str, float]) -> np.ndarray:
        names = self.tuner.feature_names
        n_static = len(names) - len(self.candidates[0].as_features())
        base = [features[k] for k in names[:n_static]]
        X = np.asarray([base + s.as_features() for s in self.candidates])
        return 10.0 ** self.tuner.tree.predict(X)

    def predict(self, fp: Fingerprint) -> Prediction:
        """Pick the argmin-predicted schedule for a fingerprinted matrix."""
        if fp.features.get("density", 0.0) > DENSE_DENSITY_THRESHOLD:
            dense = Schedule("dense", 128, 1.0, n_rhs=self.tuner.n_rhs)
            return Prediction(dense, 1.0, 0.0, float("inf"))
        return self.predict_from_features(fp.features)

    def predict_from_features(self, features: Mapping[str, float]) -> Prediction:
        times = self._scores(features)
        order = np.argsort(times)
        best = int(order[0])
        t_best = float(times[best])
        distinct = times[order][times[order] > t_best * (1 + 1e-12)]
        t_second = float(distinct[0]) if distinct.size else float("inf")
        if not np.isfinite(t_second):
            confidence = 0.0 if distinct.size == 0 else 1.0
        else:
            confidence = max(0.0, 1.0 - t_best / t_second)
        return Prediction(self.candidates[best], confidence, t_best, t_second)

    def rank(self, features: Mapping[str, float]) -> List[Tuple[float, Schedule]]:
        """All candidates sorted by predicted time (for pruned verify passes)."""
        times = self._scores(features)
        order = np.argsort(times)
        return [(float(times[i]), self.candidates[int(i)]) for i in order]


def retraining_row(fp: Fingerprint, sched: Schedule,
                   measured_time_s: float,
                   measured_ms: Optional[float] = None,
                   residual: Optional[float] = None) -> Dict:
    """One feedback example in the same (static + cfg) feature space
    ``ScheduleTuner.fit`` trains on, ready to append to its dataset.

    Every row carries ``measured_ms`` / ``residual`` fields (DESIGN.md
    §12): None until a guarded launch serves the schedule, then the
    launch's wall-clock and its log10 residual against the modeled label —
    the measured-latency signal the calibration report summarizes and
    future refits can reweight by."""
    return {
        "features": dict(fp.features),
        "cfg": sched.as_features(),
        "log10_time_s": float(np.log10(max(measured_time_s, 1e-12))),
        "measured_ms": measured_ms,
        "residual": residual,
    }
