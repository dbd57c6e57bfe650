"""Host-side core of the port: sparse containers, synthetic generators and
the ``Schedule`` record — numpy copies of the parts of ``repro.core`` the
spmv/spmm plan path needs (the port imports nothing from ``repro``).

  CSR / BSR / ELLBSR / SELLBSR        sparse containers (csr.py)
  spmv_oracle / spmm_oracle           float64 CSR products, no densify
  GENERATORS / TABLE2 / gen_zipf      synthetic matrices (synthetic.py)
  Schedule / SELL_SIGMA / BLOCK_SIZES schedule record (autotune.py)
  select_moe_block_size               MoE tile rule (autotune.py)
  partition_imbalance                 Eq. 5 imbalance (metrics.py)
  Platform / H100_SXM                 platform model (platforms.py)
"""
from .autotune import (BLOCK_SIZES, SELL_SIGMA, Schedule,
                       select_moe_block_size)
from .csr import (BSR, CSR, ELLBSR, SELLBSR, ell_block_cap, sell_layout,
                  spmm_oracle, spmv_oracle)
from .metrics import partition_imbalance
from .platforms import H100_SXM, Platform
from .synthetic import GENERATORS, TABLE2, gen_spatial, gen_zipf

__all__ = [
    "BLOCK_SIZES", "BSR", "CSR", "ELLBSR", "GENERATORS", "H100_SXM",
    "Platform", "SELLBSR", "SELL_SIGMA", "Schedule", "TABLE2",
    "ell_block_cap", "gen_spatial", "gen_zipf", "partition_imbalance",
    "select_moe_block_size", "sell_layout", "spmm_oracle", "spmv_oracle",
]
