"""Carry prepared state over from the JAX package into the port.

The sparse system's "weights" are its prepared sparse containers; the LM
substrate's are its parameters. These functions take plain numpy arrays
and dicts — never a ``repro`` object — so a caller holding a JAX
``SparseTensor`` hands over ``{name: np.asarray(leaf)}`` and
``dataclasses.asdict(meta)`` and gets the port's container, leaf for leaf;
a sharded one hands over each shard so; a JAX LM parameter tree with numpy
leaves becomes the port ``Model``'s state (``params_from_jax``).
"""
from __future__ import annotations

from typing import Dict, Mapping, Sequence, Tuple

import numpy as np

from .core.autotune import Schedule
from .core.csr import BSR, CSR, ELLBSR, SELLBSR
from .sparse.tensor import (LAYOUT_FIELDS, ShardedMeta, ShardedSparseTensor,
                            SparseTensor)


def csr_from_arrays(row_ptrs, col_idxs, nnz_vals, shape) -> CSR:
    """The port's CSR from the paper's three arrays."""
    return CSR(np.asarray(row_ptrs), np.asarray(col_idxs),
               np.asarray(nnz_vals), (int(shape[0]), int(shape[1])))


def _schedule(meta: Mapping) -> Schedule:
    s = meta.get("schedule")
    if s is None:
        return None
    if isinstance(s, Schedule):
        return s
    return Schedule(**dict(s))


def sparse_tensor_from_arrays(layout: str, meta: Mapping,
                              arrays: Dict[str, np.ndarray],
                              device="cuda", generation: int = 0,
                              spare_blocks: Sequence[int] = ()
                              ) -> SparseTensor:
    """The port's ``SparseTensor`` from a JAX ``SparseTensor``'s leaves.

    ``meta`` holds the JAX ``SparseMeta`` fields (``layout``, ``shape``,
    ``block_size``, ``slice_height``, ``sigma``, ``schedule`` as a dict or
    None); ``arrays`` the leaves by name (``LAYOUT_FIELDS`` of the JAX
    package, i.e. without the port's extra SELL ``cell_ptr`` and
    ``cell_valid``, which are derived here). A ``true_shape`` entry in
    ``meta``, when given, is the logical shape of a shape-bucketed
    container, and a ``zero_idx`` entry the index of its all-zeros block.

    A mutable container (built with ``from_csr(..., slack=)``) also hands
    over its ``generation`` and the pool of ``spare_blocks`` its inserts
    claim, so ``apply_delta`` continues where the JAX tensor stopped."""
    if layout not in LAYOUT_FIELDS:
        raise ValueError(f"unknown layout {layout!r}; one of "
                         f"{sorted(LAYOUT_FIELDS)}")
    shape = (int(meta["shape"][0]), int(meta["shape"][1]))
    # leaves handed over by JAX are read-only; the host container must
    # take a delta's writes like one the port built
    a = {k: np.asarray(v) for k, v in arrays.items()}
    a = {k: v if v.flags.writeable else v.copy() for k, v in a.items()}
    if layout == "ell":
        host = ELLBSR(a["block_indices"], a["block_cols"], a["blocks"],
                      shape, int(meta["block_size"]), a["valid_counts"])
    elif layout == "sell":
        host = SELLBSR(a["cell_block"], a["cell_col"], a["cell_row"],
                       a["row_perm"], a["slice_widths"], a["blocks"], shape,
                       int(meta["block_size"]), int(meta["slice_height"]),
                       int(meta["sigma"]))
    elif layout == "bsr":
        host = BSR(a["block_ptrs"].astype(np.int64), a["block_cols"],
                   a["blocks"], shape, int(meta["block_size"]))
    else:
        host = a["dense"]
    zero = meta.get("zero_idx")
    st = SparseTensor.from_layout(host, schedule=_schedule(meta),
                                  device=device,
                                  zero_idx=None if zero is None else int(zero))
    ts = meta.get("true_shape")
    if ts is not None:
        st.true_shape = (int(ts[0]), int(ts[1]))
    st.generation = int(generation)
    st.spare_blocks = [int(k) for k in spare_blocks]
    return st


def sharded_tensor_from_arrays(meta: Mapping,
                               shards: Sequence[Tuple[Mapping, Dict]],
                               device="cuda") -> ShardedSparseTensor:
    """The port's ``ShardedSparseTensor`` from a JAX one's shards.

    ``meta`` holds the JAX ``ShardedMeta`` fields (``shape``, ``bounds``,
    ``strategy``); ``shards`` one ``(shard meta, arrays)`` pair per shard,
    each what ``sparse_tensor_from_arrays`` takes (the layout is the shard
    meta's ``layout``)."""
    sm = ShardedMeta((int(meta["shape"][0]), int(meta["shape"][1])),
                     tuple(int(b) for b in meta["bounds"]),
                     str(meta.get("strategy", "nnz")))
    return ShardedSparseTensor(sm, [
        sparse_tensor_from_arrays(m["layout"], m, arrays, device=device)
        for m, arrays in shards])


def _flatten(tree: Mapping, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def params_from_jax(cfg, params: Mapping) -> Dict[str, "torch.Tensor"]:
    """The port ``Model``'s state (``model.load_state_dict(...)``) from a
    JAX LM parameter tree with numpy leaves (``jax.tree.map(np.asarray,
    params)``) of the same config.

    The reference stacks each position ``pi`` of ``cfg.layer_pattern``
    over the ``cfg.n_groups`` groups (``blocks[pi]`` has a leading group
    axis, scanned); the port keeps one block per layer in depth order, so
    layer ``g * len(cfg.layer_pattern) + pi`` gets ``blocks[pi][g]``. The
    whisper encoder, stacked over ``cfg.encoder_layers``, becomes
    ``encoder.{i}``. Every mixer (attention, ``ssd``, ``rglru``) and the
    ``cross`` / ``norm_cross`` leaves keep their JAX names."""
    import torch

    state = {}
    for name, leaf in _flatten({k: v for k, v in params.items()
                                if k not in ("blocks", "encoder")}):
        state[name] = torch.as_tensor(np.array(leaf))
    n_pat = len(cfg.layer_pattern)
    stacks = [("blocks.{}", n_pat, pi, tree)
              for pi, tree in enumerate(params["blocks"])]
    if "encoder" in params:
        stacks.append(("encoder.{}", 1, 0, params["encoder"]))
    for fmt, stride, offset, tree in stacks:
        for name, leaf in _flatten(tree):
            leaf = np.asarray(leaf)
            for g in range(leaf.shape[0]):
                state[f"{fmt.format(g * stride + offset)}.{name}"] = \
                    torch.as_tensor(np.array(leaf[g]))
    return state


def opt_state_from_jax(cfg, opt_state) -> "OptState":
    """The port optimizer's state (``AdamW.load_opt_state(state, names)``,
    keyed by the port's parameter names) from the reference's ``OptState``
    with numpy leaves: ``m`` and ``v`` unstacked as ``params_from_jax``
    unstacks the parameters, ``step`` an int."""
    from .optim.adamw import OptState
    step, m, v = opt_state
    return OptState(int(np.asarray(step)), params_from_jax(cfg, m),
                    params_from_jax(cfg, v))
