"""Past the tuner's corpus: rank schedules by the bytes the counted kernels
stream (port-only serving code; the reference has no such route).

A cost tree answers only where it was fitted. For a matrix far larger than
any in its training corpus it returns a leaf learned on the small ones, the
same time for every large-block schedule, and the argmin over equal leaves
is no ranking. There the service uses what it can count exactly instead:
the counted SpMV/SpMM kernels (``stream_slots`` in ``csrc/bsr_spmv.cu``)
read a block row's real blocks and one pad slot for each block row that
has pad, so a candidate's time is the bytes one op streams through them
over the card's HBM bandwidth.

The block pattern at each block size is counted from the CSR's coordinates
alone (unique block coordinates); no ``BSR`` is built and no tile is
filled. From it come each candidate's real blocks, its ELL cap or SELL
cells (the same rules as ``ell_block_cap`` and ``SELLBSR.from_bsr``), and
whether it keeps every block: a q < 1 ELL cap below the widest block row
drops blocks, so it is never ranked.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from ..core.autotune import SELL_SIGMA, Schedule
from ..core.csr import CSR, ell_block_cap, sell_layout
from ..kernels.bsr_spmv.kernel import RHS_TILE

# A request lies past the corpus when its log10 rows and its log10
# nonzeros each exceed the largest training matrix's by more than this:
# more than twice the largest matrix the tree was fitted on, in both.
OUT_OF_DOMAIN_LOG10 = math.log10(2.0)
F32_BYTES = 4


@dataclasses.dataclass(frozen=True)
class BlockPattern:
    """Which (block row, block column) tiles of a CSR hold a nonzero, at
    one block size, as counts per block row."""

    block_size: int
    blocks_per_row: np.ndarray   # (n_block_rows,) int64

    @property
    def n_block_rows(self) -> int:
        return int(self.blocks_per_row.shape[0])

    @property
    def n_blocks(self) -> int:
        return int(self.blocks_per_row.sum())


def block_patterns(csr: CSR, block_sizes: Iterable[int]
                   ) -> Dict[int, BlockPattern]:
    """The block pattern of ``csr`` at each block size, from the unique
    ``(row // bs) * n_bc + col // bs`` keys. A block size that is a multiple
    of the previous one coarsens that one's unique coordinates instead of
    the nonzeros: the same set, from far fewer keys."""
    rows = np.repeat(np.arange(csr.n_rows, dtype=np.int64),
                     csr.row_lengths())
    cols = csr.col_idxs.astype(np.int64)
    out: Dict[int, BlockPattern] = {}
    prev: Optional[Tuple[int, np.ndarray, np.ndarray]] = None
    for bs in sorted(set(int(b) for b in block_sizes)):
        if prev is not None and bs % prev[0] == 0:
            f = bs // prev[0]
            brows, bcols = prev[1] // f, prev[2] // f
        else:
            brows, bcols = rows // bs, cols // bs
        n_br = -(-csr.n_rows // bs)
        n_bc = max(-(-csr.n_cols // bs), 1)
        uniq = np.unique(brows * n_bc + bcols)
        u_brows, u_bcols = uniq // n_bc, uniq % n_bc
        out[bs] = BlockPattern(bs, np.bincount(u_brows, minlength=n_br)
                               .astype(np.int64))
        prev = (bs, u_brows, u_bcols)
    return out


def training_extent(tuner) -> Optional[Tuple[float, float]]:
    """The largest ``(log_rows, log_nnz)`` among a ``ScheduleTuner``'s
    training rows; None when it keeps none (a tree set by hand)."""
    rows, names = tuner._train_rows, tuner.feature_names
    if rows is None or len(rows) == 0:
        return None
    return (float(rows[:, names.index("log_rows")].max()),
            float(rows[:, names.index("log_nnz")].max()))


def past_extent(features: Mapping[str, float],
                extent: Optional[Tuple[float, float]]) -> bool:
    """True when a fingerprint's size lies past the training extent by
    more than ``OUT_OF_DOMAIN_LOG10`` in rows and in nonzeros."""
    if extent is None:
        return False
    max_rows, max_nnz = extent
    return bool(features["log_rows"] > max_rows + OUT_OF_DOMAIN_LOG10
                and features["log_nnz"] > max_nnz + OUT_OF_DOMAIN_LOG10)


@dataclasses.dataclass(frozen=True)
class LayoutCounts:
    """What one blocked schedule's container holds and its kernel reads."""

    kept: int       # real blocks the container keeps
    pad_rows: int   # block rows with pad: each costs one pad read
    slots: int      # ELL slots (block rows x cap) or SELL cells


def layout_counts(p: BlockPattern, sched: Schedule) -> LayoutCounts:
    """The container's counts as ``SparseTensor.build_container`` would
    build it for ``sched``, from the pattern alone."""
    bpr = p.blocks_per_row
    if sched.layout == "sell":
        C = max(int(sched.slice_height), 1)
        row_perm, widths = sell_layout(bpr, C, SELL_SIGMA)
        width = np.repeat(widths.astype(np.int64), C)[:p.n_block_rows]
        return LayoutCounts(p.n_blocks,
                            int(np.count_nonzero(width > bpr[row_perm])),
                            int(width.sum()))
    cap = ell_block_cap(bpr, sched.ell_quantile)
    kept = np.minimum(bpr, cap)
    return LayoutCounts(int(kept.sum()), int(np.count_nonzero(kept < cap)),
                        p.n_block_rows * cap)


def streamed_bytes(p: BlockPattern, counts: LayoutCounts,
                   n_rhs: int) -> int:
    """Bytes one op streams through the counted kernels: ``ceil(k / 8)``
    RHS tiles, each reading every kept block and one pad block per padded
    block row, a ``bs x min(k, 8)`` segment of x per block read, and
    writing ``bs x min(k, 8)`` of y per block row."""
    k = max(int(n_rhs), 1)
    tile = min(k, RHS_TILE)
    tiles = -(-k // RHS_TILE)
    bs = p.block_size
    reads = counts.kept + counts.pad_rows
    return tiles * F32_BYTES * bs * (reads * (bs + tile)
                                     + p.n_block_rows * tile)


@dataclasses.dataclass(frozen=True)
class Streamed:
    """One lossless candidate, costed."""

    schedule: Schedule
    bytes: int             # streamed by one op
    container_bytes: int   # slots or cells x bs^2 x 4, the tie-break


def rank_by_bytes(csr: CSR, candidates: Sequence[Schedule],
                  n_rhs: int) -> List[Streamed]:
    """The blocked candidates that keep every block, fewest streamed bytes
    first; ties go to the smaller container, then to grid order."""
    blocked = [s for s in candidates if s.backend == "bsr"]
    pats = block_patterns(csr, {s.block_size for s in blocked})
    out = []
    for s in blocked:
        p = pats[s.block_size]
        counts = layout_counts(p, s)
        if counts.kept < p.n_blocks:
            continue
        out.append(Streamed(s, streamed_bytes(p, counts, n_rhs),
                            counts.slots * p.block_size ** 2 * F32_BYTES))
    out.sort(key=lambda c: (c.bytes, c.container_bytes))
    return out
