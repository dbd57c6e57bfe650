"""Carry prepared state over from the JAX package into the port.

The system runs no model, so its "weights" are the prepared sparse
containers. These functions take plain numpy arrays and dicts — never a
``repro`` object — so a caller holding a JAX ``SparseTensor`` hands over
``{name: np.asarray(leaf)}`` and ``dataclasses.asdict(meta)`` and gets the
port's container, leaf for leaf.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np

from .core.autotune import Schedule
from .core.csr import CSR, ELLBSR, SELLBSR
from .sparse.tensor import LAYOUT_FIELDS, SparseTensor


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
                              device="cuda") -> SparseTensor:
    """The port's ``SparseTensor`` from a JAX ``SparseTensor``'s leaves.

    ``meta`` holds the JAX ``SparseMeta`` fields (``layout``, ``shape``,
    ``block_size``, ``slice_height``, ``sigma``, ``schedule`` as a dict or
    None); ``arrays`` the leaves by name (``LAYOUT_FIELDS`` of the JAX
    package, i.e. without the port's extra SELL ``cell_ptr``, which is
    derived here). A ``true_shape`` entry in ``meta``, when given, is the
    logical shape of a shape-bucketed container."""
    if layout not in LAYOUT_FIELDS:
        raise ValueError(f"unknown layout {layout!r}; one of "
                         f"{sorted(LAYOUT_FIELDS)}")
    shape = (int(meta["shape"][0]), int(meta["shape"][1]))
    a = {k: np.asarray(v) for k, v in arrays.items()}
    if layout == "ell":
        host = ELLBSR(a["block_indices"], a["block_cols"], a["blocks"],
                      shape, int(meta["block_size"]), a["valid_counts"])
    elif layout == "sell":
        host = SELLBSR(a["cell_block"], a["cell_col"], a["cell_row"],
                       a["row_perm"], a["slice_widths"], a["blocks"], shape,
                       int(meta["block_size"]), int(meta["slice_height"]),
                       int(meta["sigma"]))
    else:
        host = a["dense"]
    st = SparseTensor.from_layout(host, schedule=_schedule(meta),
                                  device=device)
    ts = meta.get("true_shape")
    if ts is not None:
        st.true_shape = (int(ts[0]), int(ts[1]))
    if "zero_idx" in meta and meta["zero_idx"] is not None:
        st._zero_idx = int(meta["zero_idx"])
    return st
