"""Host-side core of the port: sparse containers, synthetic generators, the
SpChar metrics, counters, cost model and decision tree, and the
``ScheduleTuner`` — numpy copies of ``repro.core`` (the port imports
nothing from ``repro``).

  CSR / BSR / ELLBSR / SELLBSR        sparse containers (csr.py)
  spmv_oracle / spmm_oracle           float64 CSR products, no densify
  characterize / partition_imbalance  static input metrics (metrics.py)
  GENERATORS / TABLE2 / gen_zipf      synthetic matrices (synthetic.py)
  corpus                              SuiteSparse-like corpus (dataset.py)
  DecisionTreeRegressor / kfold_cv    tree engine (decision_tree.py)
  spmv_counters / ...                 schedule counters (counters.py)
  run_spmv_model / ...                roofline cost model (perfmodel.py)
  build_slice / characterize_slice    the characterization loop: per-slice
  compare_platforms / ...             trees, CV, importances (charloop.py)
  Schedule / ScheduleTuner            loop-driven autotuning (autotune.py)
  select_moe_block_size               MoE tile rule (autotune.py)
  Platform / PLATFORMS                platform model: A100_SXM, H100_SXM,
  ROOFLINE_PLATFORM                   L40S; the roofline's card (platforms.py)
"""
from .autotune import (BLOCK_SIZES, SELL_SIGMA, Schedule, ScheduleTuner,
                       candidate_schedules, select_moe_block_size)
from .charloop import (COUNTER_FEATURES, TARGETS, CharacterizationResult,
                       SliceData, build_slice, characterize_all,
                       characterize_slice, compare_platforms,
                       grouped_importance, top_feature)
from .counters import (sell_spmv_counters, shard_counters, spadd_counters,
                       spgemm_counters, spmv_counters)
from .csr import (BSR, CSR, ELLBSR, SELLBSR, ell_block_cap, sell_layout,
                  spmm_oracle, spmv_oracle)
from .dataset import DOMAINS, corpus
from .decision_tree import DecisionTreeRegressor, kfold_cv, mape, r2_score
from .metrics import (FEATURE_NAMES, THREAD_SWEEP, branch_entropy,
                      characterize, index_affinity, partition_imbalance,
                      reuse_affinity, sell_padding_fraction,
                      sell_slice_widths, slice_imbalance, thread_imbalance)
from .perfmodel import (execution_time, run_spadd_model, run_spgemm_model,
                        run_spmv_model, run_spmv_sell_model, stall_breakdown,
                        targets)
from .platforms import (A100_SXM, H100_SXM, L40S, PLATFORMS,
                        ROOFLINE_PLATFORM, Platform)
from .synthetic import GENERATORS, TABLE2, gen_spatial, gen_zipf

__all__ = [
    "A100_SXM", "BLOCK_SIZES", "BSR", "COUNTER_FEATURES", "CSR",
    "CharacterizationResult", "DOMAINS", "DecisionTreeRegressor", "ELLBSR",
    "FEATURE_NAMES", "GENERATORS", "H100_SXM", "L40S", "PLATFORMS", "Platform",
    "ROOFLINE_PLATFORM", "SELLBSR", "SELL_SIGMA", "Schedule", "ScheduleTuner",
    "SliceData", "TABLE2", "TARGETS", "THREAD_SWEEP", "branch_entropy",
    "build_slice", "candidate_schedules", "characterize", "characterize_all",
    "characterize_slice", "compare_platforms", "corpus", "ell_block_cap",
    "execution_time", "gen_spatial", "gen_zipf", "grouped_importance",
    "index_affinity", "kfold_cv", "mape", "partition_imbalance", "r2_score",
    "reuse_affinity", "run_spadd_model", "run_spgemm_model", "run_spmv_model",
    "run_spmv_sell_model", "select_moe_block_size", "sell_layout",
    "sell_padding_fraction", "sell_slice_widths", "sell_spmv_counters",
    "shard_counters", "slice_imbalance", "spadd_counters", "spgemm_counters",
    "spmm_oracle", "spmv_counters", "spmv_oracle", "stall_breakdown",
    "targets", "thread_imbalance", "top_feature",
]
