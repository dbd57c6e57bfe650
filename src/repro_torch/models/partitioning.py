"""Logical-axis sharding hints (port of ``repro.models.partitioning``).

Model code annotates activations with *logical* axes ("batch", "heads",
"ffn", ...). A launcher installs a mapping logical axis -> mesh axis (or
None) on a ``DeviceMesh`` before it runs a step; ``shard_hint`` then
redistributes a DTensor activation to those placements, the analog of the
reference's ``with_sharding_constraint``. Without rules, or on a plain
tensor (every one-card path), a hint returns its input: the model code
stays mesh-agnostic.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Tuple, Union

import torch

MeshAxes = Union[str, Tuple[str, ...], None]

_state = threading.local()


def _current():
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def logical_axis_rules(mesh, rules: Dict[str, MeshAxes]):
    """Install logical -> mesh axis rules on this thread while the block
    runs."""
    prev = _current()
    _state.rules = (mesh, dict(rules))
    try:
        yield
    finally:
        _state.rules = prev


def current_rules() -> Optional[Dict[str, MeshAxes]]:
    """The logical rules installed on this thread, or None."""
    cur = _current()
    return None if cur is None else cur[1]


def logical_to_spec(axes: Tuple[Optional[str], ...]) -> tuple:
    cur = _current()
    if cur is None:
        raise RuntimeError("no logical axis rules are installed")
    _, rules = cur
    return tuple(rules.get(a) if a is not None else None for a in axes)


def shard_hint(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """``x`` redistributed to the placements its logical axes map to
    (``x`` itself without rules or when it is no DTensor). A dim whose
    mesh axes do not divide it stays replicated."""
    cur = _current()
    if cur is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    from ..launch.mesh import axis_sizes
    from ..launch.sharding import placements
    mesh, _ = cur
    sizes = axis_sizes(mesh)

    def divides(entry, n: int) -> bool:
        k = 1
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            k *= sizes[a]
        return n % k == 0

    # DTensor cannot reshape a dim it shards unevenly (GSPMD pads): a dim
    # its mesh axes do not divide (decode's S = 1) stays replicated
    spec = tuple(e if e is None or divides(e, n) else None
                 for e, n in zip(logical_to_spec(axes), x.shape))
    want = placements(mesh, spec)
    if tuple(want) == tuple(x.placements):
        return x
    return x.redistribute(mesh, want)


def placed_axes(x: torch.Tensor, axes: Tuple[Optional[str], ...]
                ) -> Tuple[Optional[str], ...]:
    """``axes`` with None for each dim of ``x`` that no mesh axis splits:
    the logical axes of the placement ``shard_hint`` gave ``x`` (all None
    for a plain tensor)."""
    from torch.distributed.tensor import DTensor
    split = ({p.dim for p in x.placements if p.is_shard()}
             if isinstance(x, DTensor) else set())
    return tuple(a if d in split else None for d, a in enumerate(axes))


def shard_offset(x: torch.Tensor, dim: int) -> int:
    """The global index of this rank's first element of ``x`` along
    ``dim`` (0 for a plain tensor or a dim no mesh axis splits)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return 0
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    _, offset = compute_local_shape_and_global_offset(
        x.shape, x.device_mesh, x.placements)
    return int(offset[dim])


def local_apply(fn, args, in_axes, out_axes, partial=None):
    """``fn(*args)``; on DTensors (a step on a mesh with rules installed)
    ``fn`` runs on the local shards, as ``local_map`` does: each argument
    with logical axes in ``in_axes`` (None: passed as it is) is first
    placed by ``shard_hint``, and each output gets the placements of its
    axes in ``out_axes``, with ``Partial`` on the mesh axes of its
    ``partial`` entry ({mesh axis: "sum" | "avg"}: a contraction, or a
    mean over batch shards, that ``fn`` split). DTensor then never
    propagates ``fn``'s operators, which older DTensor releases cannot
    shard (einsums over two sharded batch dims, indexing with sharded
    indices). ``fn`` must compute each shard's part alone: the caller's
    axes make it so.

    Gradients: on a mesh axis that splits the work (some output is
    sharded or partial over it), each rank's gradient of an argument
    replicated over that axis is its part of a sum, so it is marked
    ``Partial("sum")`` there; an output replicated over such an axis (the
    same value on every rank) is placed as the sum of its local value
    over the axis size, and an "avg" output as the sum of its local value
    over the axis size, so that the ranks' backward passes add up to the
    gradient once (DTensor's backward hands every rank of a partial
    output the whole gradient)."""
    cur = _current()
    from torch.distributed.tensor import DTensor
    if cur is None or not any(isinstance(a, DTensor) for a in args):
        return fn(*args)
    from torch.distributed.tensor import Partial, Replicate
    from ..launch.mesh import axis_names, axis_sizes
    from ..launch.sharding import placements
    mesh, _ = cur
    names, sizes = axis_names(mesh), axis_sizes(mesh)
    partial = partial or [{}] * len(out_axes)
    out_pl = [placements(mesh, logical_to_spec(axes)) for axes in out_axes]
    split = {n for pl, ops in zip(out_pl, partial)
             for n, p in zip(names, pl)
             if sizes[n] > 1 and (n in ops or not p.is_replicate())}
    local = []
    for a, axes in zip(args, in_axes):
        if axes is not None:
            if not isinstance(a, DTensor):      # a whole (replicated) tensor
                a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                       run_check=False)
            a = shard_hint(a, *axes)
            a = a.to_local(grad_placements=[
                Partial("sum") if n in split and p.is_replicate() else p
                for n, p in zip(names, a.placements)])
        local.append(a.to_local() if isinstance(a, DTensor) else a)
    outs = fn(*local)
    single = not isinstance(outs, tuple)
    outs = (outs,) if single else outs

    def place(o, pl, ops):
        final = []
        for n, p in zip(names, pl):
            if ops.get(n) == "sum":
                p = Partial("sum")
            elif (ops.get(n) == "avg"
                  or (n in split and p.is_replicate())):
                o, p = o / sizes[n], Partial("sum")
            final.append(p)
        return DTensor.from_local(o, mesh, final, run_check=False)

    placed = tuple(map(place, outs, out_pl, partial))
    return placed[0] if single else placed
