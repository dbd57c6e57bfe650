"""PyTorch/CUDA port of the SpChar sparse system (``repro`` is the JAX
reference). This package imports torch and numpy, never jax and nothing of
``repro``; its CUDA kernels are built from ``csrc/`` on first use.

  core      host containers, generators, Schedule (numpy)
  obs       metrics registry + span tracer
  kernels   hand-written CUDA kernels beside their plain PyTorch versions
  sparse    SparseTensor, PreparedStore, plan / plan_bucket
  convert   carry prepared containers over from the JAX package's leaves
"""
