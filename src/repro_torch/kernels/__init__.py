"""Kernels of the port: each a hand-written CUDA kernel for Hopper beside
its plain PyTorch version (``ref.py``)."""
