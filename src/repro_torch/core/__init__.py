"""Host-side core of the port: sparse containers, synthetic generators and
the ``Schedule`` record — numpy copies of the parts of ``repro.core`` the
spmv/spmm plan path needs (the port imports nothing from ``repro``).

  CSR / BSR / ELLBSR / SELLBSR        sparse containers (csr.py)
  spmv_oracle / spmm_oracle           float64 CSR products, no densify
  GENERATORS / TABLE2 / gen_zipf      synthetic matrices (synthetic.py)
  Schedule / SELL_SIGMA / BLOCK_SIZES schedule record (autotune.py)
"""
from .autotune import BLOCK_SIZES, SELL_SIGMA, Schedule
from .csr import (BSR, CSR, ELLBSR, SELLBSR, ell_block_cap, sell_layout,
                  spmm_oracle, spmv_oracle)
from .synthetic import GENERATORS, TABLE2, gen_spatial, gen_zipf

__all__ = [
    "BLOCK_SIZES", "BSR", "CSR", "ELLBSR", "GENERATORS", "SELLBSR",
    "SELL_SIGMA", "Schedule", "TABLE2", "ell_block_cap", "gen_spatial",
    "gen_zipf", "sell_layout", "spmm_oracle", "spmv_oracle",
]
