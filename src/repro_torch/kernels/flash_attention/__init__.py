"""Online-softmax attention: the CUDA kernel (``kernel``), its plain
PyTorch version (``ref``) and the facade shim (``ops``)."""
from . import kernel, ops, ref
from .kernel import LAUNCHES, flash_attention_cuda, reset_launch_counts
from .ops import flash_attention
from .ref import ref_attention

__all__ = ["LAUNCHES", "flash_attention", "flash_attention_cuda", "kernel",
           "ops", "ref", "ref_attention", "reset_launch_counts"]
