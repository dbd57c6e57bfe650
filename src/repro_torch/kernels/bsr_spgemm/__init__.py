"""Block SpGEMM (Gustavson at block granularity): the CUDA kernels
(``kernel``), their plain PyTorch versions (``ref``) and the host symbolic
phase (``ops``)."""
from . import kernel, ops, ref
from .kernel import (LAUNCHES, bsr_spgemm_cells_cuda, bsr_spgemm_pairs_cuda,
                     reset_launch_counts)
from .ops import spgemm_cell_ptr, spgemm_symbolic, spgemm_symbolic_cells
from .ref import ref_cell_gemm, ref_cell_gemm_ptr, ref_pair_gemm

__all__ = ["LAUNCHES", "bsr_spgemm_cells_cuda", "bsr_spgemm_pairs_cuda",
           "kernel", "ops", "ref", "ref_cell_gemm", "ref_cell_gemm_ptr",
           "ref_pair_gemm", "reset_launch_counts", "spgemm_cell_ptr",
           "spgemm_symbolic", "spgemm_symbolic_cells"]
