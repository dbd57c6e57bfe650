"""Per-chip operation counts of an eager PyTorch step (the port's analog of
``repro.roofline.hlo_analysis``).

The reference parses the partitioned HLO text of a compiled step. PyTorch
produces no HLO, so ``OpCounter`` is a ``TorchDispatchMode`` that sees
every aten operator the step runs and counts what ``HLOStats`` counts,
into an ``OpStats`` with the same fields:

  flops            -- matmuls, convolutions and attention, with the
                      per-operator formulas of ``torch.utils.flop_counter``
                      (2 * M * N * K for a matmul)
  hbm_bytes        -- operand plus result bytes of every aten operator
                      that is not a view. Eager PyTorch materializes every
                      operator's result, so this is the eager program's
                      traffic; the reference's fusion-boundary model (XLA
                      fuses elementwise chains) has no eager counterpart
  collective_bytes -- operand bytes of all-reduce / all-gather /
                      reduce-scatter / all-to-all / collective-permute
                      (functional and c10d collectives, and DTensor's
                      all-to-all), split per primitive under the
                      reference's five names

Counts are per chip, as the reference counts the partitioned module: an
operator with a DTensor argument is handed back to DTensor
(``NotImplemented``), which runs it as operators on its local shards and
collectives, and those are what the mode counts. A matmul of a
``[Shard(0), Shard(1)]`` result on a 16 x 16 mesh counts 1/256 of its
global FLOPs; a replicated one counts them all on every chip. Tensors may
live on the ``meta`` device: only shapes and dtypes are read.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# (namespace, op) -> (primitive, index of the argument holding the operand)
_COLLECTIVE_OPS = {
    ("_c10d_functional", "all_reduce"): ("all-reduce", 0),
    ("_c10d_functional", "all_reduce_"): ("all-reduce", 0),
    ("_c10d_functional", "all_reduce_coalesced"): ("all-reduce", 0),
    ("_c10d_functional", "all_gather_into_tensor"): ("all-gather", 0),
    ("_c10d_functional", "all_gather_into_tensor_coalesced"):
        ("all-gather", 0),
    ("_c10d_functional", "reduce_scatter_tensor"): ("reduce-scatter", 0),
    ("_c10d_functional", "reduce_scatter_tensor_coalesced"):
        ("reduce-scatter", 0),
    ("_c10d_functional", "all_to_all_single"): ("all-to-all", 0),
    ("_dtensor", "shard_dim_alltoall"): ("all-to-all", 0),
    ("c10d", "allreduce_"): ("all-reduce", 0),
    ("c10d", "allgather_"): ("all-gather", 1),
    ("c10d", "_allgather_base_"): ("all-gather", 1),
    ("c10d", "allgather_into_tensor_coalesced_"): ("all-gather", 1),
    ("c10d", "reduce_scatter_"): ("reduce-scatter", 1),
    ("c10d", "_reduce_scatter_base_"): ("reduce-scatter", 1),
    ("c10d", "reduce_scatter_tensor_coalesced_"): ("reduce-scatter", 1),
    ("c10d", "alltoall_base_"): ("all-to-all", 1),
    ("c10d", "alltoall_"): ("all-to-all", 1),
    ("c10d", "send"): ("collective-permute", 0),
}

# operators that move no data (allocation, aliasing, waiting)
_NO_TRAFFIC = {
    "aten::empty", "aten::empty_strided", "aten::empty_like",
    "aten::detach", "aten::alias", "aten::lift_fresh", "aten::_unsafe_view",
    "aten::_local_scalar_dense", "aten::set_", "aten::resize_",
    "_c10d_functional::wait_tensor", "c10d::recv_", "c10d::broadcast_",
    "_c10d_functional::broadcast",
}


@dataclasses.dataclass
class OpStats:
    flops: float
    hbm_bytes: float
    collective_bytes: Dict[str, float]
    collective_count: Dict[str, int]

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


def _bytes(tree) -> float:
    return float(sum(t.numel() * t.element_size() for t in tree_leaves(tree)
                     if isinstance(t, torch.Tensor)))


class OpCounter(TorchDispatchMode):
    """Count a step's operators, per chip::

        with OpCounter() as c:
            step(...)
        c.stats()   # OpStats
    """

    def __init__(self) -> None:
        super().__init__()
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        self._dtensor = DTensor
        self._fake = FakeTensor
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.collective_bytes = {c: 0.0 for c in COLLECTIVES}
        self.collective_count = {c: 0 for c in COLLECTIVES}

    def stats(self) -> OpStats:
        return OpStats(self.flops, self.hbm_bytes,
                       dict(self.collective_bytes),
                       dict(self.collective_count))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, self._dtensor) for t in types):
            # DTensor runs it as local operators and collectives, which
            # come back through this mode: the per-chip counts
            return NotImplemented
        out = func(*args, **kwargs)
        if not any(issubclass(t, self._fake) for t in types):
            # (DTensor's sharding propagation runs each operator on fake
            # global-shape tensors for its output's metadata: not work)
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        name = func._schema.name
        ns, _, op = name.partition("::")
        coll = _COLLECTIVE_OPS.get((ns, op))
        if coll is not None:
            kind, idx = coll
            operand = _bytes(args[idx]) if len(args) > idx else 0.0
            self.collective_bytes[kind] += operand
            self.collective_count[kind] += 1
            self.hbm_bytes += operand + _bytes(out)
            return
        if func.is_view or name in _NO_TRAFFIC:
            return
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += float(flop_registry[packet](*args, **kwargs,
                                                      out_val=out))
        self.hbm_bytes += _bytes((args, kwargs)) + _bytes(out)


def measure_step(fn: Callable, *args, **kwargs) -> OpStats:
    """Run ``fn(*args, **kwargs)`` once under ``OpCounter``; its
    ``OpStats``."""
    with OpCounter() as counter:
        fn(*args, **kwargs)
    return counter.stats()
