"""Block-union SpADD: the CUDA kernel (``kernel``), its plain PyTorch version
(``ref``) and the host symbolic phase (``ops``)."""
from . import kernel, ops, ref
from .kernel import LAUNCHES, bsr_spadd_cuda, reset_launch_counts
from .ops import spadd_symbolic
from .ref import ref_block_union_add

__all__ = ["LAUNCHES", "bsr_spadd_cuda", "kernel", "ops", "ref",
           "ref_block_union_add", "reset_launch_counts", "spadd_symbolic"]
