"""Training step (port of ``repro.train.train_step``): the model's loss,
autograd, optional microbatch accumulation and gradient compression, then
the reference's AdamW.

``make_train_step(model, optimizer, ...)`` returns ``train_step(batch) ->
metrics``, which updates the model's parameters and the optimizer's state
in place (the reference's step is the pure ``(params, opt_state, batch) ->
(params, opt_state, metrics)``; here the ``nn.Module`` and the
``torch.optim.Optimizer`` hold the state). The metrics are the
cross-entropy ``loss``, the MoE aux metrics, ``grad_norm`` (the global norm
before clipping) and ``lr`` (the rate of the step just made), as device
tensors and a float.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch
from torch import nn

from ..models.model import Model
from ..optim.adamw import AdamW, OptState
from ..roofline.op_analysis import OpCounter


class TrainState(NamedTuple):
    """The reference's train state: parameters and optimizer state by
    parameter name. The port's step keeps both in the model and the
    optimizer (``optimizer.opt_state(names)``; ``train.checkpoint.
    train_state_tree`` is the checkpointed form)."""
    params: Dict[str, torch.Tensor]
    opt_state: OptState


def shard_params(model: Model, shardings: Dict) -> Dict[str, nn.Parameter]:
    """Each parameter's shard on this rank, as a DTensor parameter of its
    sharding (``launch.sharding.as_named`` of the parameter specs): the
    state a data-parallel run's optimizer updates while the model keeps
    the whole parameters for compute. A shard is a view of the rank's own
    copy of the parameter (every rank holds the same parameters), so an
    update lands in the model's parameter and costs no memory."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    out = {}
    for name, p in model.named_parameters():
        sh = shardings[name]
        shape, offset = compute_local_shape_and_global_offset(
            p.shape, sh.mesh, sh.placements)
        local = p.detach()[tuple(slice(o, o + n)
                                 for o, n in zip(offset, shape))]
        s = nn.Parameter(DTensor.from_local(
            local, sh.mesh, sh.placements, run_check=False, shape=p.shape,
            stride=p.stride()))
        if getattr(p, "stacked", False):
            s.stacked = True
        out[name] = s
    return out


def make_train_step(model: Model, optimizer: AdamW, *,
                    remat: str = "dots_no_batch", attn_chunk: int = 1024,
                    microbatches: int = 1,
                    grad_compression: str = "none",
                    grad_shardings: Optional[Dict] = None) -> Callable:
    """Build the train step.

    microbatches > 1 splits the batch on the leading axis, runs forward and
    backward per microbatch (the gradients sum in ``.grad``) and scales the
    sum by 1/microbatches; loss and metrics are the microbatches' mean, as
    the reference's ``lax.scan`` accumulates them. grad_compression
    ``"bf16"`` rounds the gradients through bfloat16 before the optimizer.

    grad_shardings ({name: ``NamedSharding``}, ``launch.sharding.as_named``
    of the parameter specs) pins every gradient to its parameter's
    sharding, so that the data-parallel reduction is a reduce-scatter onto
    each shard, not an all-reduce (the reference's §Perf H-AR1):
      * DTensor parameters (the dry run): a gradient in other placements
        is redistributed to them: from partial sums over the batch's
        mesh axes, a reduce-scatter over "data" onto the shard and, on a
        multi-pod mesh, where the parameters are replicated over "pod",
        an all-reduce of that shard over "pod" (DTensor reduces within
        the pods first; ``OpCounter`` counts both);
      * whole parameters on every rank (``launch.train --data-parallel``):
        the optimizer must be built over ``shard_params(model,
        grad_shardings)`` (its i-th parameter the shard of the model's
        i-th; another optimizer raises ValueError). Each rank's
        gradient, of its rows of the batch, is a partial sum over the
        mesh: divided by the data-parallel size, it is reduced and
        scattered onto the shard; AdamW updates the shards (the grad norm
        is the global one), and the parameters are gathered back. The
        loss and metrics are the ranks' mean (an all-reduce of scalars).
        ``train_step.grad_reduction`` holds the ``OpStats`` of the last
        step's gradient reduction (its collective bytes per primitive).
    """
    if grad_compression not in ("none", "bf16"):
        raise ValueError(f"grad_compression must be 'none' or 'bf16', got "
                         f"{grad_compression!r}")
    named = list(model.named_parameters())
    params = [p for _, p in named]
    shards = []             # whole parameters on every rank: their shards
    if grad_shardings is not None:
        from torch.distributed.tensor import DTensor
        if not isinstance(params[0], DTensor):
            shards = optimizer.param_groups[0]["params"]
            if not (len(shards) == len(params) and all(
                    isinstance(s, DTensor) and s.shape == p.shape
                    for s, p in zip(shards, params))):
                raise ValueError("grad_shardings with whole parameters "
                                 "needs an optimizer over shard_params("
                                 "model, grad_shardings)")

    def loss_and_backward(batch):
        loss, metrics = model.loss(batch, remat=remat,
                                   attn_chunk=attn_chunk)
        loss.backward()
        return {k: v.detach() for k, v in metrics.items()}

    def train_step(batch: Dict) -> Dict:
        optimizer.zero_grad(set_to_none=True)
        if microbatches <= 1:
            metrics = loss_and_backward(batch)
        else:
            b = int(batch["tokens"].shape[0])
            if b % microbatches:
                raise ValueError(f"batch {b} does not split into "
                                 f"{microbatches} microbatches")
            mb = b // microbatches
            metrics = None
            for i in range(microbatches):
                m = loss_and_backward({k: v[i * mb:(i + 1) * mb]
                                       for k, v in batch.items()})
                metrics = m if metrics is None else {
                    k: metrics[k] + m[k] for k in metrics}
            inv = 1.0 / microbatches
            metrics = {k: v * inv for k, v in metrics.items()}
            with torch.no_grad():
                for p in params:
                    if p.grad is not None:
                        p.grad.mul_(inv)
        if grad_compression == "bf16":
            with torch.no_grad():
                for p in params:
                    if p.grad is not None:
                        p.grad.copy_(p.grad.to(torch.bfloat16))
        if shards:
            metrics = data_parallel_update(metrics)
        else:
            if grad_shardings is not None:
                pin_grads()
            optimizer.step()
        metrics["grad_norm"] = optimizer.last_grad_norm
        metrics["lr"] = optimizer.last_lr
        return metrics

    def pin_grads():
        for name, p in named:
            sh = grad_shardings[name]
            g = p.grad
            if g is not None and tuple(g.placements) != tuple(sh.placements):
                p.grad = g.redistribute(sh.mesh, sh.placements)

    @torch.no_grad()
    def data_parallel_update(metrics):
        import torch.distributed._functional_collectives as funcol
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor.experimental import implicit_replication
        from ..launch.mesh import axis_sizes, dp_axes
        mesh = grad_shardings[named[0][0]].mesh
        sizes = axis_sizes(mesh)
        dp = dp_axes(mesh)
        if len(dp) != 1 or any(n > 1 for a, n in sizes.items()
                               if a not in dp):
            raise ValueError(f"data-parallel training runs on one data "
                             f"axis of a mesh without others, got {sizes}")
        reduce_scatter = getattr(funcol, "reduce_scatter_single",
                                 funcol.reduce_scatter_tensor)
        dim = mesh.mesh_dim_names.index(dp[0])
        group, n_dp = mesh.get_group(dim), sizes[dp[0]]

        def mean(t):              # an all-reduce, issued on any group size
            return funcol.all_reduce(t / n_dp, "sum", group).wait()

        with OpCounter() as counter:
            for (name, p), s in zip(named, shards):
                pl = grad_shardings[name].placements
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                local = (reduce_scatter(
                    g.float() / n_dp, "sum", pl[dim].dim, group).wait()
                    if pl[dim].is_shard() else mean(g.float()))
                s.grad = DTensor.from_local(local, mesh, pl,
                                            run_check=False, shape=p.shape,
                                            stride=p.stride())
                p.grad = None
        train_step.grad_reduction = counter.stats()
        with implicit_replication():
            optimizer.step()
        for p, s in zip(params, shards):
            p.copy_(s.full_tensor())
            s.grad = None
        return {k: mean(torch.as_tensor(v, dtype=torch.float32,
                                        device=params[0].device))
                for k, v in metrics.items()}

    train_step.grad_reduction = None
    return train_step

