"""Device meshes (port of ``repro.launch.mesh``), on
``torch.distributed.device_mesh.init_device_mesh``.

Functions, never module constants: importing this module touches no
process group. A mesh spans the ranks of the default process group, which
the caller starts first (``torch.distributed.init_process_group``: NCCL on
cards, gloo on the CPU, or the ``fake`` backend over
``torch.testing._internal.distributed.fake_pg.FakeStore`` for a dry run of
256 or 512 ranks in one process). Single pod: (data=16, model=16) = 256
chips. Multi-pod: (pod=2, data=16, model=16) = 512 chips; the ``pod`` axis
carries only the cross-pod gradient reduction (DESIGN.md §6).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.distributed as dist

SHARD_AXIS = "shards"

# DTensor's sharding-propagation caches (Python and native) compare meshes
# by layout, names and thread alone, so an entry made under an earlier
# process group hands back that group's mesh, with its rank's coordinate
# and subgroups. A mesh equal to one made before but holding another
# coordinate or other subgroups (a later group, as another rank) clears
# them; the same rank's meshes keep them.
_SUBGROUPS: Dict = {}


def make_mesh(device_type: str, shape: Tuple[int, ...],
              axes: Tuple[str, ...]):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default
    group, which must have exactly its size."""
    from torch.distributed.device_mesh import init_device_mesh
    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != n:
        raise RuntimeError(
            f"a {'x'.join(map(str, shape))} mesh needs a process group of "
            f"{n} ranks; the default group has {world}")
    mesh = init_device_mesh(device_type, shape, mesh_dim_names=axes)
    held = (tuple(mesh.get_coordinate()),
            tuple(mesh.get_group(i).group_name for i in range(mesh.ndim)))
    if _SUBGROUPS.setdefault(mesh, held) != held:
        from torch.distributed.tensor.debug import _clear_sharding_prop_cache
        _clear_sharding_prop_cache()
        _SUBGROUPS[mesh] = held
    return mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(device_type, shape, axes)


def make_debug_mesh(data: int = 1, model: int = 1,
                    device_type: str = "cuda"):
    """A (data, model) mesh over the default group's ``data * model``
    ranks (tests, ``launch.train --data-parallel``)."""
    return make_mesh(device_type, (data, model), ("data", "model"))


def make_shard_mesh(n_shards: int, device_type: str = "cuda"):
    """1-D ``shards`` mesh for the sharded sparse path (DESIGN.md §10).
    None when fewer cards exist than shards, or no process group of
    ``n_shards`` ranks runs: the port's ``plan_sharded`` drives its shards
    from one process on CUDA streams and needs no mesh."""
    n_shards = int(n_shards)
    world = dist.get_world_size() if dist.is_initialized() else 0
    if (n_shards < 1 or world != n_shards or (
            device_type == "cuda" and torch.cuda.device_count() < n_shards)):
        return None
    return make_mesh(device_type, (n_shards,), (SHARD_AXIS,))


def axis_names(mesh) -> Tuple[str, ...]:
    """A ``DeviceMesh``'s dim names, or a stand-in's ``axis_names`` (an
    object with ``axis_names`` and a ``shape`` dict, as a jax ``Mesh``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or a stand-in."""
    if getattr(mesh, "mesh_dim_names", None) is not None:
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def dp_axes(mesh) -> tuple:
    """The data-parallel axes of a mesh (pod included when present)."""
    names = axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names)
