"""Plan/execute sparse-op facade of the port (port of ``repro.sparse`` for
the spmv/spmm path):

    from repro_torch.sparse import SparseTensor, plan, plan_bucket

    st = SparseTensor.from_csr(csr, schedule=sched)       # on the card
    y  = plan("spmv", (csr,), schedule=sched).execute(x)
    ys = plan_bucket("spmv", csrs, sched).execute(xs)     # ONE launch

Every entry point takes ``device=`` ("cuda" by default; "cpu" runs the
plain PyTorch versions) and raises when the card is asked for and there is
none.
"""
from . import ops_builtin  # noqa: F401  (registers the built-in ops)
from .plan import Plan, launch_count, plan, plan_bucket, reset_counters
from .prepared import PreparedStore, array_key, bucket_edge, content_key
from .registry import OpSpec, get_op, list_ops, register_op
from .tensor import LAYOUT_FIELDS, SparseMeta, SparseTensor

__all__ = [
    "LAYOUT_FIELDS", "OpSpec", "Plan", "PreparedStore", "SparseMeta",
    "SparseTensor", "array_key", "bucket_edge", "content_key", "get_op",
    "launch_count", "list_ops", "plan", "plan_bucket", "register_op",
    "reset_counters",
]
