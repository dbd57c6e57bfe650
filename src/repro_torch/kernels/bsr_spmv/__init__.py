"""ELL/SELL-BSR SpMV + multi-RHS SpMM: CUDA kernels (``kernel``), their
plain PyTorch versions (``ref``) and the host-to-device helpers (``ops``)."""
from . import kernel, ops, ref
from .kernel import (LAUNCHES, bsr_spmm_cuda, bsr_spmm_sell_cuda,
                     bsr_spmv_cuda, bsr_spmv_sell_cuda, reset_launch_counts)

__all__ = ["LAUNCHES", "bsr_spmm_cuda", "bsr_spmm_sell_cuda",
           "bsr_spmv_cuda", "bsr_spmv_sell_cuda", "kernel", "ops", "ref",
           "reset_launch_counts"]
