"""Roofline of a step (port of ``repro.roofline``): analytic model FLOPs
and bytes, per-chip operator counts (``op_analysis``, the analog of the
reference's HLO parse) and the three-term roofline."""
from .analysis import RooflineReport, roofline_terms  # noqa: F401
from .model_flops import model_bytes, model_flops  # noqa: F401
from .op_analysis import OpCounter, OpStats, measure_step  # noqa: F401
