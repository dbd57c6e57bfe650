"""``SparseTensor``: the device container of the facade (port of
``repro.sparse.tensor``).

One class wraps every prepared layout the spmv/spmm kernels consume:

  ell    globally padded ELL-BSR (``core.csr.ELLBSR``)
  sell   sliced SELL-BSR cell schedule (``core.csr.SELLBSR``) plus its row
         pointer ``cell_ptr`` (what the SELL CUDA kernels walk)
  dense  the dense-schedule escape hatch (density above the tuner's
         threshold)

The device arrays are torch tensors on an explicit device (the card unless
the caller asks for the CPU) and the structural facts (layout, shape,
block size, the ``Schedule`` that built it) live in ``SparseMeta``. There
is no pytree: PyTorch has no tracing to carry it through. The host
container stays on the instance for characterization and ``to_host``.

``ShardedSparseTensor`` and the mutation path come with later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..core.autotune import SELL_SIGMA, Schedule
from ..core.csr import BSR, CSR, ELLBSR, SELLBSR, ell_block_cap
from ..kernels.bsr_spmv.ops import sell_cell_ptr
from ..kernels.common import resolve_device
from .prepared import bucket_edge

HostLayout = Union[ELLBSR, SELLBSR, np.ndarray]

# Device tensor names per layout. The JAX container's leaves, in its
# flatten order; SELL adds ``cell_ptr`` at the end.
LAYOUT_FIELDS: Dict[str, Tuple[str, ...]] = {
    "ell": ("block_indices", "block_cols", "blocks", "valid_counts"),
    "sell": ("cell_block", "cell_col", "cell_row", "row_perm",
             "slice_widths", "blocks", "cell_ptr"),
    "dense": ("dense",),
}


@dataclasses.dataclass(frozen=True)
class SparseMeta:
    """Static facts of a ``SparseTensor`` (the JAX pytree's aux data)."""

    layout: str
    shape: Tuple[int, int]
    block_size: int
    n_block_rows: int = 0
    slice_height: int = 0
    sigma: int = 0
    schedule: Optional[Schedule] = None


class SparseTensor:
    """Device-resident sparse operand: torch tensors on one device."""

    def __init__(self, meta: SparseMeta, arrays: Dict[str, torch.Tensor],
                 host: Optional[HostLayout] = None) -> None:
        if meta.layout not in LAYOUT_FIELDS:
            raise ValueError(f"unknown layout {meta.layout!r}; "
                             f"one of {sorted(LAYOUT_FIELDS)}")
        missing = set(LAYOUT_FIELDS[meta.layout]) - set(arrays)
        if missing:
            raise ValueError(f"{meta.layout} SparseTensor is missing "
                             f"{sorted(missing)}")
        self.meta = meta
        self.arrays = dict(arrays)
        self._host = host
        # Logical (unbucketed) shape. Shape-bucketed containers carry the
        # padded shape in ``meta`` and the true shape here, for slicing.
        self.true_shape = meta.shape
        # Index of the shared all-zeros pad block. Bucket padding appends
        # blocks AFTER it (indices keep pointing at the pre-pad position),
        # so ``from_csr`` records it pre-pad; ``blocks.shape[0] - 1`` is
        # only correct for unbucketed containers.
        self._zero_idx: Optional[int] = None

    # ------------------------------------------------------------- basics
    @property
    def layout(self) -> str:
        return self.meta.layout

    @property
    def shape(self) -> Tuple[int, int]:
        return self.meta.shape

    @property
    def block_size(self) -> int:
        return self.meta.block_size

    @property
    def schedule(self) -> Optional[Schedule]:
        return self.meta.schedule

    @property
    def device(self) -> torch.device:
        return next(iter(self.arrays.values())).device

    def __repr__(self) -> str:
        return (f"SparseTensor(layout={self.meta.layout!r}, "
                f"shape={self.meta.shape}, bs={self.meta.block_size}, "
                f"device={self.device})")

    # ------------------------------------------------------- construction
    @staticmethod
    def build_container(csr: CSR, schedule: Schedule, *,
                        sigma: int = SELL_SIGMA,
                        max_blocks: Optional[int] = None) -> HostLayout:
        """Host-side container a ``Schedule`` names."""
        if schedule.backend == "dense":
            return csr.to_dense()
        bsr = BSR.from_csr(csr, schedule.block_size)
        if schedule.layout == "sell":
            return SELLBSR.from_bsr(bsr, max(schedule.slice_height, 1), sigma)
        mb = max_blocks
        if mb is None and schedule.ell_quantile < 1.0:
            mb = ell_block_cap(bsr.blocks_per_row(), schedule.ell_quantile)
        return ELLBSR.from_bsr(bsr, mb)

    @staticmethod
    def default_schedule(block_size: int = 128, layout: Optional[str] = None,
                         slice_height: int = 8) -> Schedule:
        """The Schedule ``from_csr`` assumes when none is given (shared with
        the planners so a store key can be formed before building)."""
        if layout == "sell":
            return Schedule("bsr", block_size, 1.0, layout="sell",
                            slice_height=slice_height)
        return Schedule("bsr", block_size, 1.0)

    @classmethod
    def from_csr(cls, csr: CSR, schedule: Optional[Schedule] = None, *,
                 block_size: int = 128, layout: Optional[str] = None,
                 slice_height: int = 8, sigma: int = SELL_SIGMA,
                 max_blocks: Optional[int] = None,
                 shape_bucket: bool = False,
                 device="cuda") -> "SparseTensor":
        """Prepare ``csr`` under ``schedule`` (or the keyword defaults) on
        ``device`` — the card unless ``device="cpu"``; raises when the card
        is asked for and there is none.

        ``shape_bucket=True`` pads the container's dimensions up to
        ``bucket_edge``s; ``meta.shape`` is then the padded shape and
        ``true_shape`` the logical one."""
        dev = resolve_device(device)
        if schedule is None:
            schedule = cls.default_schedule(block_size, layout, slice_height)
        container = cls.build_container(csr, schedule, sigma=sigma,
                                        max_blocks=max_blocks)
        zero_idx = (int(container.blocks.shape[0]) - 1
                    if isinstance(container, (ELLBSR, SELLBSR)) else None)
        live_cells = (container.n_cells if isinstance(container, SELLBSR)
                      else None)
        if shape_bucket:
            container = pad_container_to_bucket(container)
        st = cls.from_layout(container, schedule=schedule, device=dev,
                             live_cells=live_cells)
        st.true_shape = (int(csr.shape[0]), int(csr.shape[1]))
        st._zero_idx = zero_idx
        return st

    @classmethod
    def from_layout(cls, container: HostLayout,
                    schedule: Optional[Schedule] = None,
                    device="cuda",
                    live_cells: Optional[int] = None) -> "SparseTensor":
        """Wrap an existing host container (ELLBSR/SELLBSR/dense).
        ``live_cells`` is how many leading SELL cells ``cell_ptr`` assigns
        to rows (default all; a shape-bucketed container passes its
        pre-pad count, see ``sell_cell_ptr``)."""
        dev = resolve_device(device)

        def put(a, dtype):
            a = np.ascontiguousarray(a)
            if not a.flags.writeable:     # e.g. leaves handed over by JAX
                a = a.copy()
            return torch.as_tensor(a, dtype=dtype, device=dev)

        i32, f32 = torch.int32, torch.float32
        if isinstance(container, ELLBSR):
            if schedule is None:
                schedule = Schedule("bsr", container.block_size, 1.0)
            meta = SparseMeta("ell", container.shape, container.block_size,
                              n_block_rows=container.block_indices.shape[0],
                              schedule=schedule)
            arrays = {
                "block_indices": put(container.block_indices, i32),
                "block_cols": put(container.block_cols, i32),
                "blocks": put(container.blocks, f32),
                "valid_counts": put(container.valid_counts, i32),
            }
            return cls(meta, arrays, host=container)
        if isinstance(container, SELLBSR):
            if schedule is None:
                schedule = Schedule("bsr", container.block_size, 1.0,
                                    layout="sell",
                                    slice_height=container.slice_height)
            meta = SparseMeta("sell", container.shape, container.block_size,
                              n_block_rows=container.n_block_rows,
                              slice_height=container.slice_height,
                              sigma=container.sigma, schedule=schedule)
            arrays = {
                "cell_block": put(container.cell_block, i32),
                "cell_col": put(container.cell_col, i32),
                "cell_row": put(container.cell_row, i32),
                "row_perm": put(container.row_perm, i32),
                "slice_widths": put(container.slice_widths, i32),
                "blocks": put(container.blocks, f32),
                "cell_ptr": put(sell_cell_ptr(container.cell_row,
                                              container.n_block_rows,
                                              live_cells), i32),
            }
            return cls(meta, arrays, host=container)
        dense = np.asarray(container, np.float32)
        if dense.ndim != 2:
            raise TypeError(f"cannot wrap {type(container).__name__} as a "
                            "SparseTensor")
        if schedule is None:
            schedule = Schedule("dense", 128, 1.0)
        meta = SparseMeta("dense", dense.shape, schedule.block_size,
                          schedule=schedule)
        return cls(meta, {"dense": put(dense, f32)}, host=dense)

    @classmethod
    def wrap(cls, obj, schedule: Optional[Schedule] = None,
             device="cuda") -> "SparseTensor":
        """Coerce any accepted operand form — CSR, host container, or an
        already-built SparseTensor — into a SparseTensor."""
        if isinstance(obj, SparseTensor):
            return obj
        if isinstance(obj, CSR):
            return cls.from_csr(obj, schedule=schedule, device=device)
        return cls.from_layout(obj, schedule=schedule, device=device)

    # ---------------------------------------------------------- host side
    def to_host(self) -> HostLayout:
        """The host container (rebuilt from the device tensors if this
        instance was built from them)."""
        if self._host is not None:
            return self._host
        m = self.meta
        a = {k: v.cpu().numpy() for k, v in self.arrays.items()}
        if m.layout == "ell":
            host: HostLayout = ELLBSR(
                a["block_indices"], a["block_cols"], a["blocks"], m.shape,
                m.block_size, a["valid_counts"])
        elif m.layout == "sell":
            host = SELLBSR(a["cell_block"], a["cell_col"], a["cell_row"],
                           a["row_perm"], a["slice_widths"], a["blocks"],
                           m.shape, m.block_size, m.slice_height, m.sigma)
        else:
            host = a["dense"]
        self._host = host
        return host


# --------------------------------------------------------- shape bucketing

def _pad_ell_to_bucket(ell: ELLBSR) -> ELLBSR:
    """Pad an ELL container's dims (block-rows, slot width, block count,
    block-columns) up to bucket edges; numerics unchanged — pad slots point
    at the existing all-zeros block and pad output rows are sliced away."""
    n_br, mb = ell.block_indices.shape
    nb = ell.blocks.shape[0]            # includes the trailing zero block
    bs = ell.block_size
    zero_idx = nb - 1
    n_bc = -(-ell.shape[1] // bs)
    n_br_p, mb_p = bucket_edge(n_br), bucket_edge(mb)
    nb_p, n_bc_p = bucket_edge(nb), bucket_edge(n_bc)
    bi = np.full((n_br_p, mb_p), zero_idx, np.int32)
    bi[:n_br, :mb] = ell.block_indices
    bc = np.zeros((n_br_p, mb_p), np.int32)
    bc[:n_br, :mb] = ell.block_cols
    blocks = np.zeros((nb_p, bs, bs), np.float32)
    blocks[:nb] = ell.blocks
    vc = np.zeros(n_br_p, np.int32)
    vc[:n_br] = ell.valid_counts
    return ELLBSR(bi, bc, blocks, (n_br_p * bs, n_bc_p * bs), bs, vc)


def _pad_sell_to_bucket(sell: SELLBSR) -> SELLBSR:
    """Pad a SELL container (cells, block-rows, block count, block-columns)
    up to bucket edges. Pad cells extend the LAST sorted row with zero-block
    contributions, keeping ``cell_row`` nondecreasing (the JAX container's
    contract; ``from_csr`` leaves them out of ``cell_ptr``); ``row_perm`` is
    identity-extended so padded sorted rows, which own no cells, write zeros
    onto padded (sliced-away) output rows."""
    n_cells, n_br = sell.n_cells, sell.n_block_rows
    nb = sell.blocks.shape[0]           # includes the trailing zero block
    bs = sell.block_size
    zero_idx = nb - 1
    n_bc = -(-sell.shape[1] // bs)
    n_cells_p, n_br_p = bucket_edge(n_cells), bucket_edge(n_br)
    nb_p, n_bc_p = bucket_edge(nb), bucket_edge(n_bc)
    cb = np.full(n_cells_p, zero_idx, np.int32)
    cb[:n_cells] = sell.cell_block
    cc = np.zeros(n_cells_p, np.int32)
    cc[:n_cells] = sell.cell_col
    last_row = int(sell.cell_row[-1]) if n_cells else 0
    cr = np.full(n_cells_p, last_row, np.int32)
    cr[:n_cells] = sell.cell_row
    perm = np.concatenate([sell.row_perm,
                           np.arange(n_br, n_br_p, dtype=np.int32)])
    n_sl = sell.n_slices
    sw = np.ones(bucket_edge(n_sl), np.int32)   # empty-slice width-1 rule
    sw[:n_sl] = sell.slice_widths
    blocks = np.zeros((nb_p, bs, bs), np.float32)
    blocks[:nb] = sell.blocks
    return SELLBSR(cb, cc, cr, perm, sw, blocks,
                   (n_br_p * bs, n_bc_p * bs), bs, sell.slice_height,
                   sell.sigma)


def pad_container_to_bucket(container: HostLayout) -> HostLayout:
    """Bucket-edge padding rule per layout."""
    if isinstance(container, ELLBSR):
        return _pad_ell_to_bucket(container)
    if isinstance(container, SELLBSR):
        return _pad_sell_to_bucket(container)
    dense = np.asarray(container, np.float32)
    r, c = dense.shape
    r_p, c_p = bucket_edge(r), bucket_edge(c)
    if (r_p, c_p) == (r, c):
        return dense
    out = np.zeros((r_p, c_p), np.float32)
    out[:r, :c] = dense
    return out
