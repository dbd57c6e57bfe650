"""Dynamic sparsity: versioned mutable matrices without rebuilds (the port of
``repro.sparse.mutate``).

Iterative solvers and streaming graphs serve the same matrix thousands of
times and change it between solves. This module makes mutation a path of
its own, with three rungs:

1. **Values only** — ``SparseTensor.apply_delta`` writes the new values
   into the device ``blocks`` tensor in place (``Tensor.index_put_``,
   ``accumulate=True`` for ``mode="add"``). Every tensor keeps its shape
   and object, so a warm plan keeps serving it with no host prep;
   ``generation`` bumps.
2. **Structural inserts within slack** — ``from_csr(..., slack=)`` reserves
   free slots per block-row (ELL) or cells per slice row (SELL) and a pool
   of spare all-zero blocks. An insert claims a spare block, points a free
   slot at it and writes the values, and bumps the row's count of real
   slots or cells (``valid_counts`` / ``cell_valid``), which the CUDA
   kernels stop at: still no rebuild.
3. **Epoch swap when the slack is used up** — ``MutableMatrix.apply_delta``
   rebuilds a fresh container from the (already updated) host CSR and
   publishes it under the new version key; a live plan keeps the old
   tensor. Counted, traced, never a failed request.

Versions ride on ``content_key``: ``MutableMatrix`` pins ``csr.version_key
= f"{base_sha1}@g{generation}"``, so every store key formed after a delta
names the new generation. ``PreparedStore.pop_matching`` takes out the
entries that name an old one; each is rekeyed in place (a matvec
container, rungs 1 and 2), epoch-swapped (rung 3), or dropped (a derived
product: spgemm/spadd staged operands, stacked bucket and member arrays
and the engine's slot stacks copy the values, so they rebuild on next
use). Other matrices' entries are never touched.

The ``delta-apply`` fault site fails the in-place rekey and
``slack-overflow`` simulates used-up slack; the epoch swap recovers both,
so ``fired == recovered`` holds.

A q < 1 ELL schedule drops tail blocks from an immutable container; a
mutable one must not, or a delta on a dropped position would land in
slack with only the delta's values. ``from_csr`` therefore keeps every
block whenever ``slack > 0``.

Two things differ from the JAX package. Its SELL container has no
per-row count, the port's kernels stop at ``cell_valid``: a SELL insert
here also bumps the sorted row's ``cell_valid``, or the kernel would add
only the row's first insert (as its one extra cell) and skip the rest.
And ``Delta`` raises on a repeated position, which the JAX package states
but does not check: ``index_put_`` without ``accumulate`` leaves the
winner of a repeated position undefined.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..core.csr import CSR, ELLBSR, SELLBSR
from ..obs import default_registry, ordered, scoped_int
from ..obs import trace as obs_trace
from .prepared import PreparedStore, raw_content_key
from .resilience import (GUARDED_EXCEPTIONS, InjectedFault, _note_handled,
                         check_fault, fault_fired, note_recovery)
from .tensor import SparseTensor

# Spare all-zero blocks reserved per unit of slack: ``slack`` bounds
# inserts per block-row, SPARE_FACTOR * slack bounds them matrix-wide.
SPARE_FACTOR = 4


class SlackOverflow(RuntimeError):
    """A structural insert found no free slot / spare block; the caller
    must epoch-swap (rebuild the container) instead."""


@dataclasses.dataclass(frozen=True)
class Delta:
    """A batch of point updates ``A[rows[i], cols[i]] <- / += vals[i]``.

    ``mode="set"`` overwrites, ``mode="add"`` accumulates. Positions must
    be unique within one delta (applying it raises otherwise); positions
    absent from the matrix are structural inserts.
    """

    rows: np.ndarray
    cols: np.ndarray
    vals: np.ndarray
    mode: str = "set"

    def __post_init__(self):
        if self.mode not in ("set", "add"):
            raise ValueError(f"delta mode {self.mode!r}; one of ('set', 'add')")

    @property
    def size(self) -> int:
        return int(np.asarray(self.rows).size)


DeltaLike = Union[Delta, Tuple]


def as_delta(delta: DeltaLike) -> Delta:
    """Coerce ``Delta`` or a ``(rows, cols, vals[, mode])`` tuple."""
    if isinstance(delta, Delta):
        return delta
    rows, cols, vals = delta[0], delta[1], delta[2]
    mode = delta[3] if len(delta) > 3 else "set"
    return Delta(np.asarray(rows), np.asarray(cols), np.asarray(vals), mode)


def _delta_arrays(delta: Delta, shape: Tuple[int, int]
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The delta's (rows, cols, vals), checked against ``shape``: equal
    lengths, every position inside, no position twice."""
    rows = np.asarray(delta.rows, np.int64).reshape(-1)
    cols = np.asarray(delta.cols, np.int64).reshape(-1)
    vals = np.asarray(delta.vals, np.float32).reshape(-1)
    if not (rows.size == cols.size == vals.size):
        raise ValueError(f"delta arrays disagree: {rows.size} rows, "
                         f"{cols.size} cols, {vals.size} vals")
    if rows.size == 0:
        return rows, cols, vals
    n, m = shape
    if (rows.min() < 0 or rows.max() >= n
            or cols.min() < 0 or cols.max() >= m):
        raise ValueError(f"delta position outside {tuple(shape)}")
    if np.unique(rows * m + cols).size != rows.size:
        raise ValueError("delta repeats a position; positions must be "
                         "unique within one delta")
    return rows, cols, vals


# ---------------------------------------------------------------------------
# Slack reservation (construction side, called by SparseTensor.from_csr)
# ---------------------------------------------------------------------------

def _grow_blocks(blocks: np.ndarray, spare_n: int
                 ) -> Tuple[np.ndarray, int, list]:
    """Append ``spare_n`` all-zero spare slots between the real blocks and
    the trailing zero block; returns (new_blocks, new_zero_idx, spare_pool).
    Bucket padding later appends *after* the zero block, so the pool's
    indices survive ``pad_container_to_bucket`` untouched."""
    nb = blocks.shape[0] - 1            # real blocks; zero block lives at nb
    bs = blocks.shape[1]
    out = np.zeros((nb + spare_n + 1, bs, bs), np.float32)
    out[:nb] = blocks[:nb]
    return out, nb + spare_n, list(range(nb, nb + spare_n))


def add_slack_ell(ell: ELLBSR, slack: int) -> Tuple[ELLBSR, list]:
    """Widen the slot grid by ``slack`` columns and reserve the spare-block
    pool; numerics unchanged (new slots point at the relocated zero block)."""
    old_zero = ell.blocks.shape[0] - 1
    blocks, zero, spare = _grow_blocks(ell.blocks, max(slack, 1) * SPARE_FACTOR)
    n_br, mb = ell.block_indices.shape
    bi = np.full((n_br, mb + slack), zero, np.int32)
    bi[:, :mb] = np.where(ell.block_indices == old_zero, zero,
                          ell.block_indices)
    bc = np.zeros((n_br, mb + slack), np.int32)
    bc[:, :mb] = ell.block_cols
    return (ELLBSR(bi, bc, blocks, ell.shape, ell.block_size,
                   ell.valid_counts.copy()), spare)


def add_slack_sell(sell: SELLBSR, slack: int) -> Tuple[SELLBSR, list]:
    """Widen every slice by ``slack`` cells (re-spacing the flat cell
    arrays) and reserve the spare-block pool; numerics unchanged. The SELL
    kernels' ``cell_ptr`` and ``cell_valid`` are derived from the result
    (``SparseTensor.from_layout``), so they see the new spacing."""
    old_zero = sell.blocks.shape[0] - 1
    blocks, zero, spare = _grow_blocks(sell.blocks,
                                       max(slack, 1) * SPARE_FACTOR)
    C, n_br = sell.slice_height, sell.n_block_rows
    old_sw = sell.slice_widths.astype(np.int64)
    new_sw = old_sw + slack
    old_cpr = np.repeat(old_sw, C)[:n_br]
    new_cpr = np.repeat(new_sw, C)[:n_br]
    old_starts = np.concatenate([[0], np.cumsum(old_cpr)])
    new_starts = np.concatenate([[0], np.cumsum(new_cpr)])
    n_cells = int(new_starts[-1])
    cb = np.full(n_cells, zero, np.int32)
    cc = np.zeros(n_cells, np.int32)
    cr = np.repeat(np.arange(n_br, dtype=np.int64),
                   new_cpr).astype(np.int32)
    # Old cell (row p, slot j) lands at new_starts[p] + j: valid cells stay
    # a contiguous prefix of each row's span, slack cells trail it.
    old_n = int(old_starts[-1])
    rows_old = np.repeat(np.arange(n_br, dtype=np.int64), old_cpr)
    slots_old = np.arange(old_n, dtype=np.int64) - np.repeat(old_starts[:-1],
                                                             old_cpr)
    dest = new_starts[rows_old] + slots_old
    old_cb = sell.cell_block[:old_n]
    cb[dest] = np.where(old_cb == old_zero, zero, old_cb)
    cc[dest] = sell.cell_col[:old_n]
    return (SELLBSR(cb, cc, cr, sell.row_perm.copy(),
                    new_sw.astype(np.int32), blocks, sell.shape,
                    sell.block_size, C, sell.sigma), spare)


def reserve_slack(container, slack: int):
    """Dispatch ``from_csr(..., slack=)`` per layout; (container, spare)."""
    if slack <= 0:
        return container, []
    if isinstance(container, ELLBSR):
        return add_slack_ell(container, int(slack))
    if isinstance(container, SELLBSR):
        return add_slack_sell(container, int(slack))
    return container, []


# ---------------------------------------------------------------------------
# Delta application on a prepared SparseTensor (rungs 1 and 2)
# ---------------------------------------------------------------------------

def _ensure_mut(st: SparseTensor) -> Dict:
    """Lazily built host bookkeeping of the delta path: the (block-row,
    block-col) -> block-index map, and per-row free-slot cursors. Valid
    slots are a contiguous prefix of each row's span by construction, and
    inserts keep it that way."""
    if st._mut is not None:
        return st._mut
    host = st.to_host()
    zero = st._zero_idx if st._zero_idx is not None \
        else int(host.blocks.shape[0]) - 1
    if st.layout == "ell":
        bi, bc = host.block_indices, host.block_cols
        # Valid slots are the contiguous prefix valid_counts names; slots
        # beyond (including bucket-pad slots) all point at the zero block.
        valid = (np.arange(bi.shape[1], dtype=np.int64)[None, :]
                 < host.valid_counts.astype(np.int64)[:, None])
        brs, slots = np.nonzero(valid)
        bmap = {(int(b), int(c)): int(k)
                for b, c, k in zip(brs, bc[brs, slots], bi[brs, slots])}
        st._mut = {"zero": zero, "block_map": bmap,
                   "row_next": valid.sum(axis=1).astype(np.int64)}
    elif st.layout == "sell":
        C = host.slice_height
        n_br = host.n_block_rows
        cpr = np.repeat(host.slice_widths.astype(np.int64), C)[:n_br]
        starts = np.concatenate([[0], np.cumsum(cpr)])
        n = int(starts[-1])                 # bucket-pad cells live beyond
        cb = host.cell_block[:n]
        valid = cb != zero
        rows_sorted = host.cell_row[:n].astype(np.int64)
        inv = np.empty(n_br, np.int64)
        inv[host.row_perm.astype(np.int64)] = np.arange(n_br)
        orig = host.row_perm.astype(np.int64)[rows_sorted[valid]]
        bmap = {(int(b), int(c)): int(k)
                for b, c, k in zip(orig, host.cell_col[:n][valid], cb[valid])}
        st._mut = {"zero": zero, "block_map": bmap, "inv": inv,
                   "starts": starts, "cpr": cpr,
                   "used": np.bincount(rows_sorted[valid],
                                       minlength=n_br).astype(np.int64)}
    elif st.layout == "bsr":
        bpr = np.diff(host.block_ptrs)
        brs = np.repeat(np.arange(bpr.size, dtype=np.int64), bpr)
        st._mut = {"zero": None, "block_map": {
            (int(b), int(c)): k
            for k, (b, c) in enumerate(zip(brs, host.block_cols))}}
    else:
        st._mut = {"zero": None, "block_map": {}}
    return st._mut


def _host_copy(t: torch.Tensor, a) -> bool:
    """True when host array ``a`` needs its own write after the device
    tensor ``t`` took one: on the CPU ``from_layout`` shares the host
    container's memory with the tensor, and a second ``add`` would count
    twice."""
    return a is not None and not (t.device.type == "cpu"
                                  and np.may_share_memory(t.numpy(), a))


def _index(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host index array as the int64 tensor ``index_put_`` takes."""
    return torch.as_tensor(np.asarray(a, np.int64), device=device)


def _insert_blocks(st: SparseTensor, mut: Dict, brs: np.ndarray,
                   bcs: np.ndarray, missing: np.ndarray,
                   ks: np.ndarray) -> None:
    """Claim spare blocks + free slots for the block positions in
    ``missing``; raises SlackOverflow (before mutating anything) when the
    container cannot absorb them. Bumps the rows' counts of real slots
    (ELL ``valid_counts``) or cells (SELL ``cell_valid``, by sorted row)
    on the device, where the kernels read them."""
    if st.layout not in ("ell", "sell"):
        raise SlackOverflow(
            f"{st.layout} container cannot absorb structural inserts")
    new_blocks: Dict[Tuple[int, int], list] = {}
    for i in missing:
        new_blocks.setdefault((int(brs[i]), int(bcs[i])), []).append(i)
    if len(new_blocks) > len(st.spare_blocks):
        raise SlackOverflow(f"need {len(new_blocks)} spare blocks, "
                            f"pool has {len(st.spare_blocks)}")
    dev = st.device
    i32 = torch.int32
    # Validate per-row capacity in full before claiming anything, so an
    # overflowing delta leaves the tensor untouched for the epoch swap.
    if st.layout == "ell":
        cap = st.arrays["block_indices"].shape[1]
        need: Dict[int, int] = {}
        for br, _ in new_blocks:
            need[br] = need.get(br, 0) + 1
        for br, cnt in need.items():
            if int(mut["row_next"][br]) + cnt > cap:
                raise SlackOverflow(f"block-row {br} slot slack exhausted")
        at = []
        for (br, bc), idxs in new_blocks.items():
            k = st.spare_blocks.pop()
            slot = int(mut["row_next"][br])
            mut["row_next"][br] += 1
            mut["block_map"][(br, bc)] = k
            ks[idxs] = k
            at.append((br, slot, bc, k))
        br_a = np.array([a[0] for a in at], np.int64)
        sl_a = np.array([a[1] for a in at], np.int64)
        bc_a = np.array([a[2] for a in at], np.int32)
        k_a = np.array([a[3] for a in at], np.int32)
        pos = (_index(br_a, dev), _index(sl_a, dev))
        st.arrays["block_indices"].index_put_(
            pos, torch.as_tensor(k_a, dtype=i32, device=dev))
        st.arrays["block_cols"].index_put_(
            pos, torch.as_tensor(bc_a, dtype=i32, device=dev))
        st.arrays["valid_counts"].index_put_(
            (_index(br_a, dev),), torch.ones(br_a.size, dtype=i32,
                                             device=dev), accumulate=True)
        host = st._host
        if host is not None:
            if _host_copy(st.arrays["block_indices"], host.block_indices):
                host.block_indices[br_a, sl_a] = k_a
            if _host_copy(st.arrays["block_cols"], host.block_cols):
                host.block_cols[br_a, sl_a] = bc_a
            if _host_copy(st.arrays["valid_counts"], host.valid_counts):
                np.add.at(host.valid_counts, br_a, 1)
    else:
        need = {}
        for br, _ in new_blocks:
            p = int(mut["inv"][br])
            need[p] = need.get(p, 0) + 1
        for p, cnt in need.items():
            if int(mut["used"][p]) + cnt > int(mut["cpr"][p]):
                raise SlackOverflow(f"slice row {p} cell slack exhausted")
        at = []
        for (br, bc), idxs in new_blocks.items():
            k = st.spare_blocks.pop()
            p = int(mut["inv"][br])
            t = int(mut["starts"][p]) + int(mut["used"][p])
            mut["used"][p] += 1
            mut["block_map"][(br, bc)] = k
            ks[idxs] = k
            at.append((t, bc, k, p))
        t_a = np.array([a[0] for a in at], np.int64)
        bc_a = np.array([a[1] for a in at], np.int32)
        k_a = np.array([a[2] for a in at], np.int32)
        p_a = np.array([a[3] for a in at], np.int64)
        pos = (_index(t_a, dev),)
        st.arrays["cell_block"].index_put_(
            pos, torch.as_tensor(k_a, dtype=i32, device=dev))
        st.arrays["cell_col"].index_put_(
            pos, torch.as_tensor(bc_a, dtype=i32, device=dev))
        # the new cells follow the row's real ones, inside its cell_ptr
        # range: one more real cell for the kernel to sum, per insert
        st.arrays["cell_valid"].index_put_(
            (_index(p_a, dev),), torch.ones(p_a.size, dtype=i32, device=dev),
            accumulate=True)
        host = st._host
        if host is not None:
            if _host_copy(st.arrays["cell_block"], host.cell_block):
                host.cell_block[t_a] = k_a
            if _host_copy(st.arrays["cell_col"], host.cell_col):
                host.cell_col[t_a] = bc_a


def block_lookup(block_map: Dict, brs: np.ndarray,
                 bcs: np.ndarray) -> np.ndarray:
    """The block index holding each (block-row, block-col) position, -1
    where the container has no such block: one dict lookup per position,
    the delta path's host loop."""
    return np.fromiter((block_map.get(p, -1) for p in zip(brs.tolist(),
                                                          bcs.tolist())),
                       np.int64, brs.size)


def apply_delta_to_tensor(st: SparseTensor, delta: DeltaLike) -> SparseTensor:
    """In-place delta on a prepared container (``SparseTensor.apply_delta``
    body). The device tensors are written in place and keep their shapes,
    so a plan that holds the tensor serves the new values with no host
    prep."""
    delta = as_delta(delta)
    rows, cols, vals = _delta_arrays(delta, st.true_shape)
    if rows.size == 0:
        st.generation += 1
        return st
    dev = st.device
    add = delta.mode == "add"
    if st.layout == "dense":
        st.arrays["dense"].index_put_(
            (_index(rows, dev), _index(cols, dev)),
            torch.as_tensor(vals, device=dev), accumulate=add)
        if _host_copy(st.arrays["dense"], st._host):
            if add:
                np.add.at(st._host, (rows, cols), vals)
            else:
                st._host[rows, cols] = vals
        st.generation += 1
        return st
    bs = st.meta.block_size
    mut = _ensure_mut(st)
    brs, bcs = rows // bs, cols // bs
    ks = block_lookup(mut["block_map"], brs, bcs)
    missing = np.flatnonzero(ks < 0)
    if missing.size:
        _insert_blocks(st, mut, brs, bcs, missing, ks)
    rr, cc = rows % bs, cols % bs
    st.arrays["blocks"].index_put_(
        (_index(ks, dev), _index(rr, dev), _index(cc, dev)),
        torch.as_tensor(vals, device=dev), accumulate=add)
    host = st._host
    if host is not None and _host_copy(st.arrays["blocks"], host.blocks):
        if add:
            np.add.at(host.blocks, (ks, rr, cc), vals)
        else:
            host.blocks[ks, rr, cc] = vals
    st.generation += 1
    return st


# ---------------------------------------------------------------------------
# Host CSR update (the new-generation ground truth)
# ---------------------------------------------------------------------------

def _locate(csr: CSR, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """nnz index per delta position, -1 where the position is absent.

    CSR entries are sorted by (row, col), so one vectorized searchsorted
    over flattened ``row*m + col`` keys resolves the whole delta. The key
    array is O(nnz) to build, so it is cached on the CSR and reused for
    every value-only delta (the streaming hot path); any structural change
    alters nnz and invalidates the stamp."""
    m = csr.shape[1]
    cached = getattr(csr, "_locate_keys", None)
    if cached is None or cached[0] != csr.nnz:
        keys = (np.repeat(np.arange(csr.shape[0], dtype=np.int64),
                          np.diff(csr.row_ptrs)) * m
                + csr.col_idxs.astype(np.int64))
        cached = (csr.nnz, keys)
        csr._locate_keys = cached
    keys = cached[1]
    if keys.size == 0:
        return np.full(rows.size, -1, np.int64)
    q = rows * m + cols
    pos = np.searchsorted(keys, q)
    hit = (pos < keys.size) & (keys[np.minimum(pos, keys.size - 1)] == q)
    return np.where(hit, pos, -1).astype(np.int64)


def apply_delta_csr(csr: CSR, delta: Delta) -> int:
    """Apply ``delta`` to the host CSR in place; returns the number of
    structural (previously absent) positions. Structural inserts rebuild
    the index arrays host-side — O(nnz) bookkeeping that the device
    containers sidestep via slack."""
    rows, cols, vals = _delta_arrays(delta, csr.shape)
    if rows.size == 0:
        return 0
    n = csr.shape[0]
    idx = _locate(csr, rows, cols)
    have = idx >= 0
    if delta.mode == "add":
        np.add.at(csr.nnz_vals, idx[have], vals[have])
    else:
        csr.nnz_vals[idx[have]] = vals[have]
    n_new = int((~have).sum())
    if n_new:
        lens = np.diff(csr.row_ptrs)
        merged = CSR.from_coo(
            np.concatenate([np.repeat(np.arange(n, dtype=np.int64), lens),
                            rows[~have]]),
            np.concatenate([csr.col_idxs.astype(np.int64), cols[~have]]),
            np.concatenate([csr.nnz_vals, vals[~have]]), csr.shape)
        csr.row_ptrs = merged.row_ptrs
        csr.col_idxs = merged.col_idxs
        csr.nnz_vals = merged.nnz_vals
    return n_new


# ---------------------------------------------------------------------------
# MutableMatrix: versioning + store invalidation + epoch swap (rung 3)
# ---------------------------------------------------------------------------

class MutableMatrix:
    """A CSR whose mutations flow through the PreparedStore correctly.

    Wrapping pins two attributes on the CSR that the rest of the stack
    reads with ``getattr``: ``version_key`` (so ``content_key`` returns
    ``"<base>@g<gen>"`` and every store key / fingerprint formed afterwards
    names this generation) and ``mutation_slack`` (so every planner's prep
    path builds slack-reserving containers). ``apply_delta`` then:

    1. updates the host CSR (the new-generation ground truth),
    2. bumps ``generation`` and re-pins ``version_key``,
    3. pops every store entry referencing the old generation and either
       rekeys it in place (matvec containers take the delta on the
       device), epoch-swaps it (slack exhausted or fault injected: rebuild
       from the updated CSR; live plans keep serving the old tensor
       object), or drops it (derived products re-stage on next use),
    4. notifies the DriftMonitor (if attached) to re-fingerprint.
    """

    deltas = scoped_int("deltas")
    value_updates = scoped_int("value_updates")
    structural_inserts = scoped_int("structural_inserts")
    epoch_swaps = scoped_int("epoch_swaps")
    rebuilds = scoped_int("rebuilds")
    rekeyed_entries = scoped_int("rekeyed_entries")
    dropped_entries = scoped_int("dropped_entries")

    def __init__(self, csr: CSR, store: Optional[PreparedStore] = None,
                 monitor=None, slack: int = 4) -> None:
        self._metrics = default_registry().scope("mutation")
        self.csr = csr
        self.store = store
        self.monitor = monitor
        self.slack = max(int(slack), 0)
        self.generation = 0
        self.base_key = raw_content_key(csr)
        csr.version_key = self.version_key
        csr.mutation_slack = self.slack
        if monitor is not None:
            monitor.watch(self)

    @property
    def version_key(self) -> str:
        return f"{self.base_key}@g{self.generation}"

    @property
    def shape(self) -> Tuple[int, int]:
        return self.csr.shape

    def set_values(self, rows, cols, vals) -> "MutableMatrix":
        return self.apply_delta(Delta(np.asarray(rows), np.asarray(cols),
                                      np.asarray(vals), "set"))

    def add_values(self, rows, cols, vals) -> "MutableMatrix":
        return self.apply_delta(Delta(np.asarray(rows), np.asarray(cols),
                                      np.asarray(vals), "add"))

    # ----------------------------------------------------------- mutation
    def apply_delta(self, delta: DeltaLike) -> "MutableMatrix":
        delta = as_delta(delta)
        old_keys = {self.version_key, self.base_key}
        n_struct = apply_delta_csr(self.csr, delta)
        self.generation += 1
        self.csr.version_key = self.version_key
        self.deltas += 1
        self.structural_inserts += n_struct
        self.value_updates += delta.size - n_struct
        if self.store is not None:
            for key, value in self.store.pop_matching(old_keys):
                self._migrate_entry(key, value, delta)
        obs_trace.emit("mutate", self.base_key[:12], base=self.base_key,
                       generation=self.generation, n_values=delta.size,
                       n_structural=n_struct)
        if self.monitor is not None:
            self.monitor.observe(self)
        return self

    def _migrate_entry(self, key, value, delta: Delta) -> None:
        """One popped old-generation entry: rekey, epoch-swap, or drop."""
        new_key = key
        for tok in (f"{self.base_key}@g{self.generation - 1}", self.base_key):
            new_key = PreparedStore.rewrite_key(new_key, tok,
                                                self.version_key)
        if self._rekeyable(key, value):
            try:
                check_fault("delta-apply", key[0])
                if fault_fired("slack-overflow", key[0]):
                    note_recovery("slack-overflow")
                    raise SlackOverflow("injected slack exhaustion")
                value.apply_delta(delta)
            except (SlackOverflow, InjectedFault) as e:
                _note_handled(e)
                self._epoch_swap(key, new_key, e)
                return
            self.store.put(new_key, value)
            self.store.mutation_rekeys += 1
            self.rekeyed_entries += 1
        else:
            # Derived product (spgemm/spadd staged operands, stacked bucket
            # or member arrays): its copied arrays hold old values. Drop
            # it; the next use re-stages against the new generation.
            self.store.mutation_invalidated += 1
            self.dropped_entries += 1

    @staticmethod
    def _rekeyable(key, value) -> bool:
        return (isinstance(value, SparseTensor) and isinstance(key, tuple)
                and len(key) == 8 and key[0] == "matvec")

    def _epoch_swap(self, key, new_key, cause: BaseException) -> None:
        """Slack exhausted (or fault injected) on an in-place rekey: the
        old tensor object keeps serving any live plan while the new
        generation is rebuilt from the updated CSR. Never raises."""
        self.epoch_swaps += 1
        reason = type(cause).__name__
        obs_trace.emit("epoch_swap", key[0], op=key[0], reason=reason,
                       base=self.base_key, generation=self.generation)
        try:
            with obs_trace.span("prep", f"epoch-rebuild:{key[0]}", op=key[0]):
                fresh = self._rebuild_entry(key)
        except GUARDED_EXCEPTIONS:
            fresh = None
        if fresh is None:
            self.store.mutation_invalidated += 1
            self.dropped_entries += 1
            return
        self.store.put(new_key, fresh)
        self.rebuilds += 1

    def _rebuild_entry(self, key) -> Optional[SparseTensor]:
        """Fresh container from the (already mutated) CSR, under the build
        parameters the entry key encodes: ("matvec", ck, sched, layout,
        sigma, max_blocks, shape_bucket, device)."""
        _, _, sched, lay, sigma, max_blocks, shape_bucket, device = key
        return SparseTensor.from_csr(
            self.csr, schedule=sched, layout=lay, sigma=sigma,
            max_blocks=max_blocks, shape_bucket=bool(shape_bucket),
            slack=self.slack, device=device)

    def telemetry(self) -> Dict[str, int]:
        return ordered({
            "deltas": self.deltas,
            "value_updates": self.value_updates,
            "structural_inserts": self.structural_inserts,
            "epoch_swaps": self.epoch_swaps,
            "rebuilds": self.rebuilds,
            "rekeyed_entries": self.rekeyed_entries,
            "dropped_entries": self.dropped_entries,
            "generation": self.generation,
        })

    def __repr__(self) -> str:
        return (f"MutableMatrix(shape={self.csr.shape}, "
                f"generation={self.generation}, slack={self.slack})")
