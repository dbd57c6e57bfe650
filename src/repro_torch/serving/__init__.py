"""Serving loops of the port. ``decode_moe_ticks`` drives the MoE decode
path through the plan/execute facade; the continuous-batching engine of
``repro.serving`` joins in a later slice."""
from .decode import decode_moe_ticks

__all__ = ["decode_moe_ticks"]
