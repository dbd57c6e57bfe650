"""Plan/execute sparse-op facade of the port (port of ``repro.sparse`` for
its six registered ops: spmv, spmm, spgemm, spadd, moe_gmm and
flash_attention):

    from repro_torch.sparse import SparseTensor, plan, plan_bucket

    st = SparseTensor.from_csr(csr, schedule=sched)       # on the card
    y  = plan("spmv", (csr,), schedule=sched).execute(x)
    ys = plan_bucket("spmv", csrs, sched).execute(xs)     # ONE launch
    y  = plan_sharded("spmv", (csr,), n_shards=4,
                      selector=service).execute(x)      # one pick a shard
    C  = plan("spgemm", (a, b), schedule=sched).execute() # "bsr" tensor
    Cs = plan_bucket("spadd", [(a, b), ...], sched).execute()
    s  = moe_tile_schedule(counts, d_model, H100_SXM, cache=ScheduleCache())
    x, tile_e, inv = route_and_pad(tokens, expert_of_token, E, s.block_size)
    out = plan("moe_gmm", (tile_e,), schedule=s).execute(x, w)
    o  = plan("flash_attention", (), causal=True).execute(q, k, v)

Every entry point takes ``device=`` ("cuda" by default; "cpu" runs the
plain PyTorch versions) and raises when the card is asked for and there is
none. Every build and launch runs under a ``GuardedExecutor`` (the
fallback ladder torch -> dense on the CPU, the CUDA kernel alone on the
card; the NaN guard and the quarantine;
``resilience``); ``plan(op, operands, selector=service)`` takes its
schedule from a ``SelectorService`` or a fitted ``ScheduleTuner``.
``MutableMatrix(csr, store=store).apply_delta(Delta(rows, cols, vals))``
changes a served matrix in place (``mutate``).
"""
from . import ops_builtin  # noqa: F401  (registers the built-in ops)
from .ops_builtin import moe_tile_schedule, route_and_pad
from .mutate import Delta, MutableMatrix, SlackOverflow
from .partition import (RowPartition, bounds_imbalance, partition_rows,
                        slice_rows)
from .plan import (Plan, launch_count, plan, plan_bucket, plan_sharded,
                   reset_counters)
from .prepared import (PreparedStore, array_key, bucket_edge, content_key,
                       raw_content_key, split_version_key)
from .registry import OpSpec, get_op, list_ops, register_op
from .resilience import (FALLBACK_CHAIN, Deadline, FaultInjector,
                         GuardedExecutor, InjectedFault, NonFiniteOutput,
                         Quarantine, default_executor, default_quarantine,
                         install_injector, output_finite, register_dense_ref,
                         reset_resilience, with_backoff)
from .tensor import (LAYOUT_FIELDS, ShardedMeta, ShardedSparseTensor,
                     SparseMeta, SparseTensor)

__all__ = [
    "FALLBACK_CHAIN", "Deadline", "Delta", "FaultInjector",
    "GuardedExecutor", "InjectedFault", "LAYOUT_FIELDS", "MutableMatrix",
    "NonFiniteOutput", "OpSpec", "Plan", "PreparedStore", "Quarantine",
    "RowPartition", "ShardedMeta", "ShardedSparseTensor", "SlackOverflow",
    "SparseMeta", "SparseTensor",
    "array_key", "bounds_imbalance", "bucket_edge", "content_key",
    "default_executor", "default_quarantine", "get_op", "install_injector",
    "launch_count", "list_ops", "moe_tile_schedule", "output_finite",
    "partition_rows", "plan", "plan_bucket", "plan_sharded",
    "raw_content_key", "register_dense_ref", "register_op", "reset_counters",
    "reset_resilience", "route_and_pad", "slice_rows", "split_version_key",
    "with_backoff",
]
