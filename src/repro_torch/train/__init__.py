"""Serving steps of the LM substrate (port of ``repro.train``; the training
step comes with ROADMAP Queue A item 7b)."""
from .serve_step import make_decode_step, make_prefill_step  # noqa: F401
