"""Optimizer, schedules and gradient compression (port of
``repro.optim``)."""
from .adamw import AdamW, OptState, apply_updates  # noqa: F401
from .compression import (compress_tree, decompress_tree,  # noqa: F401
                          init_error)
from .schedules import cosine_schedule, linear_warmup_cosine  # noqa: F401
