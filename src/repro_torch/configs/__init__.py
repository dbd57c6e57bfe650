"""Assigned architecture configs (the port's copy of ``repro.configs``: plain
Python data). Import side effect: registry population."""
from .base import (ArchConfig, ShapeConfig, SHAPES, get_config, list_archs,
                   register, shape_applicable)
from . import (whisper_large_v3, mamba2_780m, qwen2_vl_72b, recurrentgemma_9b,
               phi3_medium_14b, phi4_mini_3_8b, gemma2_9b, llama3_2_3b,
               dbrx_132b, mixtral_8x22b)  # noqa: F401

__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "get_config", "list_archs",
           "register", "shape_applicable"]
