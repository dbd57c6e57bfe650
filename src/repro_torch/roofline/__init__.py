"""Analytic model FLOPs and bytes per step (port of the part of
``repro.roofline`` that needs no HLO: ``model_flops``)."""
from .model_flops import model_bytes, model_flops  # noqa: F401
