"""Published peaks of one NVIDIA H100 SXM5 80 GB at its 700 W limit
(NVIDIA's H100 data sheet, dense rates without sparsity), as
``repro_torch.core.platforms.H100_SXM`` and the kernel table of PERF.md
use them. A card set below 700 W runs slower under load: every result
line states the card's ``power.limit``.
"""
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12          # CUDA cores, no tensor cores
TF32_FLOP_PER_S = 494.7e12       # dense, tensor cores
BF16_FLOP_PER_S = 989.4e12       # dense, tensor cores
HBM_BYTES = 80e9
