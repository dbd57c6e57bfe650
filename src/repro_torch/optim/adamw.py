"""AdamW as the reference writes it (port of ``repro.optim.adamw``), not
``torch.optim.AdamW``: the gradients are clipped by their global norm
before the moments, weight decay is added to the update of parameters with
two or more dimensions in the reference's tree only (a parameter marked
``stacked``, as ``Params`` marks its block and encoder parameters, has one
more dim there than here), and the learning rate and bias corrections
are taken at the step being made (the counter moves first).

    opt = AdamW(model.parameters(), learning_rate=linear_warmup_cosine(...))
    loss.backward(); opt.step()       # opt.last_grad_norm, opt.last_lr

Its state is ``step`` (the updates made) and float32 ``m`` and ``v`` per
parameter; ``state_dict`` holds all three and ``load_state_dict`` brings
them back. ``opt_state(names)`` / ``load_opt_state`` give the same state as
the reference's functional ``OptState`` keyed by parameter name. The
parameters may be DTensors (a data-parallel run's shards, a dry run's
placed parameters): the moments take their placements, and the grad norm
is the global one.
"""
from __future__ import annotations

from typing import (Callable, Dict, Iterable, NamedTuple, Optional,
                    Sequence, Union)

import torch


class OptState(NamedTuple):
    step: int
    m: Dict[str, torch.Tensor]     # float32, like the params
    v: Dict[str, torch.Tensor]


def apply_updates(params: Dict[str, torch.Tensor],
                  updates: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: p + updates[k].to(p.dtype) for k, p in params.items()}


class AdamW(torch.optim.Optimizer):
    def __init__(self, params: Iterable[torch.Tensor],
                 learning_rate: Union[float, Callable[[int], float]] = 1e-3,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1,
                 grad_clip_norm: Optional[float] = 1.0) -> None:
        super().__init__(params, {})
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.grad_clip_norm = grad_clip_norm
        self.step_count = 0
        self.last_grad_norm: Optional[torch.Tensor] = None
        self.last_lr: Optional[float] = None

    def _params(self):
        return [p for g in self.param_groups for p in g["params"]]

    def _moments(self, p: torch.Tensor):
        st = self.state[p]
        if "m" not in st:
            # zeros_like keeps a DTensor parameter's placements: the
            # moments of a shard are shards
            st["m"] = torch.zeros_like(p, dtype=torch.float32,
                                       memory_format=torch.contiguous_format)
            st["v"] = torch.zeros_like(st["m"])
        return st["m"], st["v"]

    def lr_at(self, step: int) -> float:
        if callable(self.learning_rate):
            return float(self.learning_rate(step))
        return float(self.learning_rate)

    @torch.no_grad()
    def step(self, closure=None):
        """One update from the parameters' ``.grad`` (a missing grad is a
        zero grad, as a parameter the loss does not reach has in JAX)."""
        if closure is not None:
            raise TypeError("AdamW.step takes no closure")
        params = self._params()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        dev = params[0].device
        if self.grad_clip_norm is not None:
            norms = [full_value(torch.linalg.vector_norm(g, dtype=torch.float32))
                     for g in grads]
            gnorm = torch.sqrt(sum(n * n for n in norms))
            scale = torch.clamp(self.grad_clip_norm
                                / torch.clamp_min(gnorm, 1e-12), max=1.0)
        else:
            gnorm = torch.zeros((), device=dev)
            scale = torch.ones((), device=dev)
        self.step_count += 1
        step = self.step_count
        lr = self.lr_at(step)
        b1c = 1.0 - self.b1 ** step
        b2c = 1.0 - self.b2 ** step
        for p, g in zip(params, grads):
            m, v = self._moments(p)
            g = g.float() * scale
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            upd = (m / b1c).div_((v / b2c).sqrt_().add_(self.eps))
            if self.weight_decay > 0 and (p.dim() >= 2
                                          or getattr(p, "stacked", False)):
                upd.add_(p.float(), alpha=self.weight_decay)
            p.add_((-lr * upd).to(p.dtype))
        self.last_grad_norm, self.last_lr = gnorm, lr
        return None

    # ---------------------------------------------------------------- state
    def state_dict(self):
        sd = super().state_dict()
        sd["step"] = self.step_count
        return sd

    def load_state_dict(self, state_dict) -> None:
        sd = dict(state_dict)
        self.step_count = int(sd.pop("step"))
        super().load_state_dict(sd)

    def opt_state(self, names: Sequence[str]) -> OptState:
        """The state as the reference's ``OptState``, ``names[i]`` naming
        the i-th parameter (``[n for n, _ in model.named_parameters()]``);
        the tensors are the optimizer's own."""
        params = self._params()
        if len(names) != len(params):
            raise ValueError(f"{len(names)} names for {len(params)} params")
        mv = [self._moments(p) for p in params]
        return OptState(self.step_count,
                        {n: m for n, (m, _) in zip(names, mv)},
                        {n: v for n, (_, v) in zip(names, mv)})

    @torch.no_grad()
    def load_opt_state(self, state: OptState, names: Sequence[str]) -> None:
        """Copy ``state`` (keyed by ``names``, as ``opt_state`` gives it)
        into the optimizer."""
        for n, p in zip(names, self._params()):
            m, v = self._moments(p)
            copy_full_into(m, state.m[n])
            copy_full_into(v, state.v[n])
        self.step_count = int(state.step)


def full_value(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's value as one tensor on every rank (a reduction over its
    shards or partial sums); any other tensor itself."""
    full = getattr(t, "full_tensor", None)
    return full() if full is not None else t


@torch.no_grad()
def copy_full_into(dst: torch.Tensor, src) -> None:
    """Copy the full value ``src`` into ``dst``; a DTensor ``dst`` takes
    its own shard of it."""
    src = torch.as_tensor(src)
    if hasattr(dst, "to_local"):
        from torch.distributed.tensor import distribute_tensor
        src = distribute_tensor(src.to(dst.device, dst.dtype),
                                dst.device_mesh, dst.placements,
                                src_data_rank=None).to_local()
        dst = dst.to_local()
    dst.copy_(src)
