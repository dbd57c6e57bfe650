"""Online kernel-selection service of the port (of ``repro.selector``):
  fingerprint        cheap static features + stable hash per CSR, and the
                     MoE routing fingerprint (fingerprint.py)
  SchedulePredictor  trained tree -> full Schedule + confidence (predictor.py)
  ScheduleCache      persistent JSON LRU keyed by fingerprint (cache.py)
  SelectorService    batched requests, schedule-bucketed stacked launches on
                     the card, low-confidence fallback to the autotune
                     verify pass (service.py); CLI entry:
                     ``python -m repro_torch.selector.serve``
  DriftMonitor       re-fingerprints mutated matrices, quarantines stale
                     cache entries, refits the tree (drift.py)
"""
from .cache import (CACHE_FORMAT_VERSION, ScheduleCache, schedule_from_dict,
                    schedule_to_dict)
from .drift import DriftMonitor, drift_score
from .fingerprint import (FP_PRECISION, Fingerprint, fingerprint,
                          routing_fingerprint)
from .predictor import Prediction, SchedulePredictor, retraining_row
from .service import Decision, Request, SelectorService

__all__ = [
    "CACHE_FORMAT_VERSION", "Decision", "DriftMonitor", "FP_PRECISION",
    "Fingerprint", "drift_score",
    "Prediction", "Request", "ScheduleCache", "SchedulePredictor",
    "SelectorService", "fingerprint", "retraining_row", "routing_fingerprint",
    "schedule_from_dict", "schedule_to_dict",
]
