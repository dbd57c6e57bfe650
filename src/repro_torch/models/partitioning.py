"""Logical-axis sharding hints (port of ``repro.models.partitioning``).

The JAX model code annotates activations with *logical* axes ("batch",
"heads", "ffn", ...) and the launcher maps them onto a device mesh. The
port serves on one card, so there is no mesh: ``logical_axis_rules``
installs nothing and ``shard_hint`` returns its input. The names stay so
that the model code reads like the reference's.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple, Union

import torch

MeshAxes = Union[str, Tuple[str, ...], None]


@contextlib.contextmanager
def logical_axis_rules(mesh=None, rules: Optional[Dict[str, MeshAxes]] = None):
    """No rules to install on one card; kept for the reference's call
    sites."""
    yield


def shard_hint(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """Identity on one card (the reference constrains ``x``'s sharding by
    logical axis names)."""
    return x
