"""Schedule-selection pieces of the port (of ``repro.selector``): the
routing fingerprint and the in-memory ``ScheduleCache`` that the MoE decode
loop keys its tile choice by. The CSR fingerprint, predictor and
``SelectorService`` come with the selector slice."""
from .cache import ScheduleCache, schedule_from_dict, schedule_to_dict
from .fingerprint import (FP_PRECISION, Fingerprint, routing_fingerprint)

__all__ = ["FP_PRECISION", "Fingerprint", "ScheduleCache",
           "routing_fingerprint", "schedule_from_dict", "schedule_to_dict"]
