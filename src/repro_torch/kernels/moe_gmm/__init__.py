"""Ragged grouped GEMM for MoE experts: the CUDA kernel (``kernel``), its
plain PyTorch version (``ref``) and the host routing (``ops``)."""
from . import kernel, ops, ref
from .kernel import LAUNCHES, moe_gmm_cuda, reset_launch_counts
from .ops import moe_gmm, route_and_pad
from .ref import live_row_ends, ref_gmm

__all__ = ["LAUNCHES", "kernel", "live_row_ends", "moe_gmm", "moe_gmm_cuda",
           "ops", "ref", "ref_gmm", "reset_launch_counts", "route_and_pad"]
