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

from typing import Callable, Dict, NamedTuple

import torch

from ..models.model import Model
from ..optim.adamw import AdamW, OptState


class TrainState(NamedTuple):
    """The reference's train state: parameters and optimizer state by
    parameter name. The port's step keeps both in the model and the
    optimizer (``optimizer.opt_state(names)``; ``train.checkpoint.
    train_state_tree`` is the checkpointed form)."""
    params: Dict[str, torch.Tensor]
    opt_state: OptState


def make_train_step(model: Model, optimizer: AdamW, *,
                    remat: str = "dots_no_batch", attn_chunk: int = 1024,
                    microbatches: int = 1,
                    grad_compression: str = "none") -> Callable:
    """Build the train step.

    microbatches > 1 splits the batch on the leading axis, runs forward and
    backward per microbatch (the gradients sum in ``.grad``) and scales the
    sum by 1/microbatches; loss and metrics are the microbatches' mean, as
    the reference's ``lax.scan`` accumulates them. grad_compression
    ``"bf16"`` rounds the gradients through bfloat16 before the optimizer.
    The reference's ``grad_shardings`` (a sharding constraint that makes
    the data-parallel reduction a reduce-scatter) is the identity on one
    card and has no counterpart here (ROADMAP Queue A item 8).
    """
    if grad_compression not in ("none", "bf16"):
        raise ValueError(f"grad_compression must be 'none' or 'bf16', got "
                         f"{grad_compression!r}")
    params = [p for _, p in model.named_parameters()]

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
        optimizer.step()
        metrics["grad_norm"] = optimizer.last_grad_norm
        metrics["lr"] = optimizer.last_lr
        return metrics

    return train_step
