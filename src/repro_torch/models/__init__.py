"""The LM substrate's models (port of ``repro.models``, the attention
families): layers, attention, MoE, the transformer stack and ``Model``."""
from .model import Model, count_active_params, count_params  # noqa: F401
