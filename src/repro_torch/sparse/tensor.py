"""``SparseTensor``: the device container of the facade (port of
``repro.sparse.tensor``).

One class wraps every prepared layout the kernels consume:

  ell    globally padded ELL-BSR (``core.csr.ELLBSR``)
  sell   sliced SELL-BSR cell schedule (``core.csr.SELLBSR``) plus its row
         pointer ``cell_ptr`` (what the SELL CUDA kernels walk) and
         ``cell_valid``, the real cells that lead each sorted row
  bsr    raw blocked rows (``core.csr.BSR``): spgemm/spadd operands, whose
         symbolic phase is host-side, and the C they return
  dense  the dense-schedule escape hatch (density above the tuner's
         threshold)

The device arrays are torch tensors on an explicit device (the card unless
the caller asks for the CPU) and the structural facts (layout, shape,
block size, the ``Schedule`` that built it) live in ``SparseMeta``. There
is no pytree: PyTorch has no tracing to carry it through. The host
container stays on the instance for characterization and ``to_host``.

Mutation (``sparse.mutate``): ``from_csr(..., slack=)`` reserves free
slots or cells per row and a pool of spare zero blocks, and
``apply_delta`` writes a delta into the device tensors in place, bumping
``generation``.

``ShardedSparseTensor`` is a row-partitioned operand: one prepared
``SparseTensor`` per shard, each under its own ``Schedule``
(``repro_torch.sparse.plan_sharded`` plans it).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, Iterator, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.autotune import SELL_SIGMA, Schedule
from ..core.csr import BSR, CSR, ELLBSR, SELLBSR, ell_block_cap
from ..kernels.bsr_spmv.ops import sell_cell_valid, sell_row_ptr
from ..kernels.common import resolve_device
from ..obs import default_registry
from ..obs import trace as obs_trace
from .prepared import bucket_edge

HostLayout = Union[ELLBSR, SELLBSR, BSR, np.ndarray]

# Device tensor names per layout. The JAX container's leaves, in its
# flatten order; SELL adds ``cell_ptr`` and ``cell_valid`` at the end.
LAYOUT_FIELDS: Dict[str, Tuple[str, ...]] = {
    "ell": ("block_indices", "block_cols", "blocks", "valid_counts"),
    "sell": ("cell_block", "cell_col", "cell_row", "row_perm",
             "slice_widths", "blocks", "cell_ptr", "cell_valid"),
    "bsr": ("block_ptrs", "block_cols", "blocks"),
    "dense": ("dense",),
}


def _host_layout(container: HostLayout) -> str:
    """The layout name of a host container."""
    if isinstance(container, ELLBSR):
        return "ell"
    if isinstance(container, SELLBSR):
        return "sell"
    if isinstance(container, BSR):
        return "bsr"
    return "dense"


def _host_nbytes(container: HostLayout) -> int:
    """The bytes of a host container's arrays."""
    if isinstance(container, np.ndarray):
        return int(container.nbytes)
    return sum(int(v.nbytes) for v in vars(container).values()
               if isinstance(v, np.ndarray))


@contextlib.contextmanager
def _prep_phase(kind: str, name: str) -> Iterator[Dict]:
    """One phase of a container's build: a ``kind`` span (its fields are
    yielded) and, when the phase completes, its wall time in the
    ``prep_ms.<kind>`` histogram, observed whether or not a tracer is
    installed."""
    t0 = time.monotonic()
    with obs_trace.span(kind, name) as ev:
        yield ev
    default_registry().observe(f"prep_ms.{kind}",
                               (time.monotonic() - t0) * 1e3)


def _blocked_container(csr: CSR, schedule: Schedule, layout: Optional[str],
                       sigma: int, max_blocks: Optional[int],
                       full_rows: bool) -> HostLayout:
    """``SparseTensor.build_container`` for a blocked schedule."""
    bsr = BSR.from_csr(csr, schedule.block_size)
    if layout == "bsr":
        return bsr
    if schedule.layout == "sell":
        return SELLBSR.from_bsr(bsr, max(schedule.slice_height, 1), sigma)
    mb = max_blocks
    if full_rows:
        mb = None
    elif mb is None and schedule.ell_quantile < 1.0:
        mb = ell_block_cap(bsr.blocks_per_row(), schedule.ell_quantile)
    return ELLBSR.from_bsr(bsr, mb)


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
        # SELL: the leading cells that are not bucket padding (None: all).
        self._live_cells: Optional[int] = None
        # Mutation state: ``generation`` bumps on every applied delta (the
        # tensors keep their shapes and are written in place);
        # ``spare_blocks`` is the pool of all-zero blocks a structural
        # insert can claim (``from_csr(..., slack=)`` fills it); ``_mut``
        # holds the delta path's host bookkeeping (block map, free-slot
        # cursors), built on first use.
        self.generation = 0
        self.spare_blocks: list = []
        self._mut: Optional[dict] = None

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
                        layout: Optional[str] = None,
                        sigma: int = SELL_SIGMA,
                        max_blocks: Optional[int] = None,
                        full_rows: bool = False) -> HostLayout:
        """Host-side container a ``Schedule`` names (``layout="bsr"``: the
        raw blocked rows, whatever the schedule's ell/sell axis says).

        ``full_rows=True`` ignores the schedule's ``ell_quantile`` cap and
        ``max_blocks`` and keeps every block: a mutable tensor (``slack >
        0``) must not drop tail blocks, or a later delta on a dropped
        position would look like an insert and land in slack with only the
        delta's values, losing the base values."""
        dense = schedule.backend == "dense"
        with _prep_phase("container", "dense" if dense
                        else layout or schedule.layout) as ev:
            if dense:
                out: HostLayout = csr.to_dense()
                ev.update(layout="dense", block_size=0, blocks=0)
            else:
                out = _blocked_container(csr, schedule, layout, sigma,
                                         max_blocks, full_rows)
                ev.update(layout=_host_layout(out),
                          block_size=out.block_size,
                          blocks=int(out.blocks.shape[0]))
            ev["bytes"] = _host_nbytes(out)
        return out

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
                 slack: int = 0,
                 device="cuda") -> "SparseTensor":
        """Prepare ``csr`` under ``schedule`` (or the keyword defaults) on
        ``device`` — the card unless ``device="cpu"``; raises when the card
        is asked for and there is none.

        ``layout="bsr"`` forces the raw blocked container regardless of
        the schedule's ell/sell axis (spgemm/spadd operands).

        ``shape_bucket=True`` pads the container's dimensions up to
        ``bucket_edge``s; ``meta.shape`` is then the padded shape and
        ``true_shape`` the logical one. A raw BSR is never padded.

        ``slack > 0`` reserves mutation headroom in ELL/SELL containers:
        ``slack`` more slots per block-row (ELL) or cells per slice row
        (SELL) and a pool of spare all-zero blocks, so ``apply_delta`` can
        take structural inserts without a rebuild; it also keeps every
        block (``full_rows``). ``MutableMatrix`` sets
        ``csr.mutation_slack`` and the planners pass it here."""
        dev = resolve_device(device)
        if schedule is None:
            schedule = cls.default_schedule(block_size, layout, slice_height)
        container = cls.build_container(csr, schedule, layout=layout,
                                        sigma=sigma, max_blocks=max_blocks,
                                        full_rows=slack > 0)
        spare: list = []
        if slack > 0 and isinstance(container, (ELLBSR, SELLBSR)):
            from .mutate import reserve_slack
            container, spare = reserve_slack(container, int(slack))
        zero_idx = (int(container.blocks.shape[0]) - 1
                    if isinstance(container, (ELLBSR, SELLBSR)) else None)
        live_cells = (container.n_cells if isinstance(container, SELLBSR)
                      else None)
        if shape_bucket:
            with _prep_phase("bucket", _host_layout(container)) as ev:
                before = _host_nbytes(container)
                container = pad_container_to_bucket(container)
                ev.update(bytes_before=before,
                          bytes_after=_host_nbytes(container))
        st = cls.from_layout(container, schedule=schedule, device=dev,
                             live_cells=live_cells, zero_idx=zero_idx)
        st.true_shape = (int(csr.shape[0]), int(csr.shape[1]))
        st.spare_blocks = spare
        return st

    @classmethod
    def from_layout(cls, container: HostLayout,
                    schedule: Optional[Schedule] = None,
                    device="cuda",
                    live_cells: Optional[int] = None,
                    zero_idx: Optional[int] = None) -> "SparseTensor":
        """Wrap an existing host container (ELLBSR/SELLBSR/BSR/dense).
        ``live_cells`` is how many leading SELL cells are not bucket
        padding (default all; a shape-bucketed container passes its pre-pad
        count: ``cell_ptr`` gives its last row one pad cell, see
        ``sell_row_ptr``). ``zero_idx`` is the index of the all-zeros block
        the pad slots and cells point at (default the last block, right for
        unbucketed containers only). The arrays' copy onto ``device`` is
        the ``upload`` phase (``_prep_phase``)."""
        dev = resolve_device(device)
        with _prep_phase("upload", _host_layout(container)) as ev:
            st = cls._from_host(container, schedule, dev, live_cells,
                                zero_idx)
            ev.update(bytes=sum(t.numel() * t.element_size()
                                for t in st.arrays.values()))
        return st

    @classmethod
    def _from_host(cls, container: HostLayout,
                   schedule: Optional[Schedule], dev: torch.device,
                   live_cells: Optional[int],
                   zero_idx: Optional[int]) -> "SparseTensor":
        """``from_layout`` on a resolved device."""
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
            st = cls(meta, arrays, host=container)
            st._zero_idx = zero_idx
            return st
        if isinstance(container, SELLBSR):
            if schedule is None:
                schedule = Schedule("bsr", container.block_size, 1.0,
                                    layout="sell",
                                    slice_height=container.slice_height)
            meta = SparseMeta("sell", container.shape, container.block_size,
                              n_block_rows=container.n_block_rows,
                              slice_height=container.slice_height,
                              sigma=container.sigma, schedule=schedule)
            ptr = sell_row_ptr(container.cell_row, container.n_block_rows,
                               live_cells)
            zero = (zero_idx if zero_idx is not None
                    else container.blocks.shape[0] - 1)
            arrays = {
                "cell_block": put(container.cell_block, i32),
                "cell_col": put(container.cell_col, i32),
                "cell_row": put(container.cell_row, i32),
                "row_perm": put(container.row_perm, i32),
                "slice_widths": put(container.slice_widths, i32),
                "blocks": put(container.blocks, f32),
                "cell_ptr": put(ptr, i32),
                "cell_valid": put(sell_cell_valid(container.cell_block, ptr,
                                                  zero), i32),
            }
            st = cls(meta, arrays, host=container)
            st._live_cells = live_cells
            st._zero_idx = zero_idx
            return st
        if isinstance(container, BSR):
            if schedule is None:
                schedule = Schedule("bsr", container.block_size, 1.0)
            meta = SparseMeta("bsr", container.shape, container.block_size,
                              n_block_rows=container.n_block_rows,
                              schedule=schedule)
            arrays = {
                "block_ptrs": put(container.block_ptrs, i32),
                "block_cols": put(container.block_cols, i32),
                "blocks": put(container.blocks, f32),
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

    def to(self, device) -> "SparseTensor":
        """This container with its tensors on ``device`` (``self`` when
        they are there already): the same meta, host container, zero block,
        live cells, generation and spare blocks."""
        dev = resolve_device(device)
        if self.device == dev:
            return self
        st = SparseTensor(self.meta, {k: v.to(dev)
                                      for k, v in self.arrays.items()},
                          host=self._host)
        st.true_shape = self.true_shape
        st._zero_idx = self._zero_idx
        st._live_cells = self._live_cells
        st.generation = self.generation
        st.spare_blocks = list(self.spare_blocks)
        return st

    # ----------------------------------------------------------- mutation
    def apply_delta(self, delta) -> "SparseTensor":
        """Apply a ``sparse.mutate.Delta`` to this prepared container in
        place: values are written into the device tensors (same shapes, no
        host prep); structural inserts claim reserved slack
        (``from_csr(..., slack=)``) and raise ``SlackOverflow`` when it is
        used up, for ``MutableMatrix`` to rebuild instead. Bumps
        ``generation``."""
        from .mutate import apply_delta_to_tensor
        return apply_delta_to_tensor(self, delta)

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
        elif m.layout == "bsr":
            host = BSR(a["block_ptrs"].astype(np.int64), a["block_cols"],
                       a["blocks"], m.shape, m.block_size)
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
    contract; ``from_csr`` gives the last row one of them in ``cell_ptr``,
    see ``sell_row_ptr``); ``row_perm`` is identity-extended so padded
    sorted rows, which own no cells, write zeros onto padded (sliced-away)
    output rows."""
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
    """Bucket-edge padding rule per layout (none for a raw BSR, whose
    executors never take a padded shape)."""
    if isinstance(container, BSR):
        return container
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


# ------------------------------------------------------- sharded container

@dataclasses.dataclass(frozen=True)
class ShardedMeta:
    """Static facts of a ``ShardedSparseTensor``: the global shape, the
    contiguous row bounds (shard ``i`` owns rows ``[bounds[i],
    bounds[i+1])``) and the partition strategy."""

    shape: Tuple[int, int]
    bounds: Tuple[int, ...]
    strategy: str = "nnz"


class ShardedSparseTensor:
    """Row-partitioned sparse operand: one prepared ``SparseTensor`` per
    shard, each with its own schedule.

    Shards may carry different schedules: the per-shard selector path
    resolves each shard's layout and block size from its own fingerprint,
    which is the point of sharding a skewed matrix. A plain class (the JAX
    package's is a pytree): PyTorch has no tracing to carry it through.
    """

    def __init__(self, meta: ShardedMeta, shards) -> None:
        shards = tuple(shards)
        if len(shards) != len(meta.bounds) - 1:
            raise ValueError(f"{len(shards)} shards for "
                             f"{len(meta.bounds) - 1} row ranges")
        self.meta = meta
        self.shards = shards

    # ------------------------------------------------------------- basics
    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def shape(self) -> Tuple[int, int]:
        return self.meta.shape

    @property
    def bounds(self) -> Tuple[int, ...]:
        return self.meta.bounds

    def shard_rows(self) -> Tuple[int, ...]:
        b = self.meta.bounds
        return tuple(b[i + 1] - b[i] for i in range(self.n_shards))

    def schedules(self) -> Tuple[Optional[Schedule], ...]:
        return tuple(s.meta.schedule for s in self.shards)

    def __repr__(self) -> str:
        return (f"ShardedSparseTensor(shape={self.meta.shape}, "
                f"n_shards={self.n_shards}, strategy={self.meta.strategy!r})")

    def to(self, device) -> "ShardedSparseTensor":
        """Every shard on ``device`` (a shard already there is kept)."""
        return ShardedSparseTensor(self.meta,
                                   [st.to(device) for st in self.shards])

    # ------------------------------------------------------- construction
    @classmethod
    def from_csr(cls, csr: CSR, n_shards: int, schedules=None, *,
                 strategy: str = "nnz", shape_bucket: bool = True,
                 sigma: int = SELL_SIGMA,
                 device="cuda") -> "ShardedSparseTensor":
        """Partition ``csr``'s rows (nnz-balanced by default) and prepare
        each shard under its own Schedule on ``device`` (the card unless
        ``device="cpu"``).

        ``schedules`` is one Schedule for every shard, a per-shard
        sequence, or None (the matvec default per shard). Partition caching,
        selector-resolved per-shard schedules and the launch live in
        ``repro_torch.sparse.plan_sharded``; this constructor is the
        standalone container build.
        """
        from .partition import partition_rows
        dev = resolve_device(device)
        part = partition_rows(csr, n_shards, strategy)
        if schedules is None or isinstance(schedules, Schedule):
            schedules = [schedules] * part.n_parts
        schedules: Sequence = list(schedules)
        if len(schedules) != part.n_parts:
            raise ValueError(f"{len(schedules)} schedules for "
                             f"{part.n_parts} shards")
        shards = [SparseTensor.from_csr(shard, schedule=s, sigma=sigma,
                                        shape_bucket=shape_bucket,
                                        device=dev)
                  for shard, s in zip(part.slice(csr), schedules)]
        meta = ShardedMeta((int(csr.shape[0]), int(csr.shape[1])),
                           part.bounds, strategy)
        return cls(meta, shards)
