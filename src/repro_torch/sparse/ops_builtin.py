"""The six built-in ops of the plan/execute facade: spmv, spmm, spgemm,
spadd, moe_gmm and flash_attention (port of ``repro.sparse.ops_builtin``),
and the sharded spmv/spmm path.

Each planner resolves its operand into a device ``SparseTensor`` once and
hands back a ``Plan`` whose launch is one call of the layout's kernel: the
CUDA kernel on ``backend="cuda"``, its plain PyTorch version on
``backend="torch"``. The matvec layouts are ell, sell and dense; dense
stays ``torch.matmul``, as the JAX package left it to XLA. spgemm and
spadd take raw blocked (bsr) operand pairs, run the host symbolic phase
once per plan and return C as a "bsr" ``SparseTensor`` on the plan's
device (``to_host()`` is the JAX facade's ``BSR``); the schedule's ell/sell
axis picks spgemm's numeric formulation (padded pairs or flat cells).

moe_gmm plans the routed tiles' experts (``tile_expert``) and executes on
``(x, w)``; its decode-time tile comes from ``moe_tile_schedule``, keyed by
routing fingerprint in a ``ScheduleCache``. flash_attention plans nothing
and executes on ``(q, k, v)``.

Two serving-path hooks ride through every planner, as in the JAX package:
``store`` (a ``PreparedStore``: a warm hit returns the finished device
operands and skips host prep) and ``shape_bucket`` (default on: containers
padded to ``bucket_edge``s).

A bucket of members is ONE launch with the member on the kernel grid
(``blockIdx.z``), where the JAX pallas path looped over members in Python.
A content-pure bucket (every member the same matrix) is one multi-RHS
launch of the single-request container instead.

A sharded spmv/spmm plan (``plan_sharded``) whose shards share one
schedule is one stacked launch of the same member-axis kernels, the shards
as members (the JAX package ran one ``shard_map`` program over a mesh
axis); shards under different schedules launch one by one, each on its
own CUDA stream and round-robin over the cards, and join on the caller's
stream.

Each op also registers its dense reference, the guard's last rung
(``resilience.register_dense_ref``): numpy on the host, built lazily and
capped, returning what the op returns on its other rungs.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.autotune import SELL_SIGMA, Schedule, select_moe_block_size
from ..core.csr import BSR, CSR, SELLBSR
from ..kernels.bsr_spadd import kernel as AK
from ..kernels.bsr_spadd import ref as AR
from ..kernels.bsr_spadd.ops import spadd_symbolic
from ..kernels.bsr_spgemm import kernel as GK
from ..kernels.bsr_spgemm import ref as GR
from ..kernels.bsr_spgemm.ops import (spgemm_cell_ptr, spgemm_symbolic,
                                      spgemm_symbolic_cells)
from ..kernels.bsr_spmv import kernel as K
from ..kernels.bsr_spmv import ref as R
from ..kernels.bsr_spmv.ops import sell_cell_valid, sell_row_ptr
from ..kernels.flash_attention import kernel as FK
from ..kernels.flash_attention import ref as FR
from ..kernels.moe_gmm import kernel as MK
from ..kernels.moe_gmm import ref as MR
from ..kernels.moe_gmm.ops import route_and_pad  # noqa: F401  (re-export)
from ..selector.fingerprint import routing_fingerprint
from .plan import Plan
from .prepared import PreparedStore, array_key, bucket_edge, content_key
from .registry import register_op
from .resilience import check_fault, dense_ref_cap, register_dense_ref
from .tensor import ShardedMeta, ShardedSparseTensor, SparseMeta, SparseTensor

MATVEC_LAYOUTS = ("ell", "sell", "dense")
# RHS columns are padded to a multiple of this on both backends: the SpMM
# kernels compute k in tiles of 8 (one CTA per tile).
RHS_TILE = K.RHS_TILE

# (layout, multi-RHS) -> (CUDA kernel wrapper, plain PyTorch version, the
# count the wrapper alone takes as a keyword); both take the layout's index
# arrays, the blocks and the blocked RHS, and return rows in original order.
_MATVEC_FNS = {
    ("ell", False): (K.bsr_spmv_cuda, R.ref_bsr_spmv, "valid_counts"),
    ("ell", True): (K.bsr_spmm_cuda, R.ref_bsr_spmm, "valid_counts"),
    ("sell", False): (K.bsr_spmv_sell_cuda, R.ref_bsr_spmv_sell_perm,
                      "cell_valid"),
    ("sell", True): (K.bsr_spmm_sell_cuda, R.ref_bsr_spmm_sell_perm,
                     "cell_valid"),
}
_LAYOUT_ARGS = {
    "ell": ("block_indices", "block_cols", "blocks"),
    "sell": ("cell_block", "cell_col", "cell_ptr", "row_perm", "blocks"),
}


def _cached(store: Optional[PreparedStore], key, builder):
    """Route a host-prep build through the PreparedStore when one is in
    play (``key=None`` marks an uncacheable operand). The ``prep`` fault
    site fires here, before any host prep."""
    check_fault("prep", str(key) if key is not None else "uncached")
    if store is None:
        return builder()
    return store.get_or_build(key, builder)


def _as_input(x, device: torch.device) -> torch.Tensor:
    """A runtime RHS as a float32 tensor on the operand's device."""
    return torch.as_tensor(x, dtype=torch.float32).to(device)


def _run_layout(arrays: Dict[str, torch.Tensor], layout: str,
                xb: torch.Tensor, backend: str) -> torch.Tensor:
    """One launch of the layout's kernel (or its plain version) on blocked
    x; arrays and xb may carry a leading member axis."""
    # multi-RHS x has as many dims as blocks: (n_bc, bs, k) vs (nb, bs, bs)
    cuda_fn, plain_fn, count = _MATVEC_FNS[(
        layout, xb.dim() == arrays["blocks"].dim())]
    args = [arrays[k] for k in _LAYOUT_ARGS[layout]] + [xb]
    if backend != "cuda":
        return plain_fn(*args)
    return cuda_fn(*args, **{count: arrays[count]})


# ---------------------------------------------------------------------------
# spmv / spmm — single-operand executor
# ---------------------------------------------------------------------------

def _block_x(x: torch.Tensor, n_cols: int, n_bc: int, bs: int,
             rhs_tile: int) -> torch.Tensor:
    """Pad the dense RHS to the block grid: (n_bc, bs) or (n_bc, bs, k_pad)."""
    if x.dim() == 2:
        k = x.shape[1]
        k_pad = -(-k // rhs_tile) * rhs_tile
        xb = x.new_zeros((n_bc * bs, k_pad))
        xb[:n_cols, :k] = x[:n_cols]
        return xb.reshape(n_bc, bs, k_pad)
    xb = x.new_zeros((n_bc * bs,))
    xb[:n_cols] = x[:n_cols]
    return xb.reshape(n_bc, bs)


def _exec_matvec(st: SparseTensor, x: torch.Tensor, backend: str,
                 rhs_tile: int) -> torch.Tensor:
    """y = A @ x (or Y = A @ X for 2-D x) for an ell/sell/dense operand."""
    meta = st.meta
    if meta.layout == "dense":
        return st.arrays["dense"] @ x
    if meta.layout not in _LAYOUT_ARGS:
        raise ValueError(f"spmv/spmm cannot execute layout {meta.layout!r}")
    bs = meta.block_size
    n_bc = -(-meta.shape[1] // bs)
    xb = _block_x(x, meta.shape[1], n_bc, bs, rhs_tile)
    y = _run_layout(st.arrays, meta.layout, xb, backend)
    if x.dim() == 2:
        return y.reshape(y.shape[0] * y.shape[1], -1)[: meta.shape[0],
                                                      : x.shape[1]]
    return y.reshape(-1)[: meta.shape[0]]


def _plan_matvec(operands, schedule: Optional[Schedule], backend: str, *,
                 op: str, device: torch.device,
                 rhs_tile: Optional[int] = None,
                 block_size: int = 128, layout: str = "ell",
                 slice_height: int = 8, sigma: int = SELL_SIGMA,
                 max_blocks: Optional[int] = None,
                 store: Optional[PreparedStore] = None,
                 shape_bucket: bool = True,
                 operand_key: Optional[str] = None) -> Plan:
    (a,) = operands
    if isinstance(a, CSR):
        lay = None if layout == "ell" else layout
        sched = (schedule if schedule is not None
                 else SparseTensor.default_schedule(block_size, lay,
                                                   slice_height))
        key = None if store is None else (
            "matvec", operand_key or content_key(a), sched, lay, sigma,
            max_blocks, bool(shape_bucket), str(device))
        st = _cached(store, key, lambda: SparseTensor.from_csr(
            a, schedule=sched, layout=lay, slice_height=slice_height,
            sigma=sigma, max_blocks=max_blocks, shape_bucket=shape_bucket,
            slack=getattr(a, "mutation_slack", 0), device=device))
    else:
        st = SparseTensor.wrap(a, schedule, device=device)
    if st.layout not in MATVEC_LAYOUTS:
        raise ValueError(f"{op} needs an ell/sell/dense operand, got a "
                         f"{st.layout!r} SparseTensor")
    if st.device != device:
        raise ValueError(f"{op}: operand lives on {st.device}, the plan "
                         f"is for {device}")
    sched = schedule if schedule is not None else st.meta.schedule
    tile = rhs_tile if rhs_tile is not None else RHS_TILE
    true_rows, true_cols = st.true_shape
    pad_cols = st.meta.shape[1]

    def run(x):
        x = _as_input(x, device)
        if x.shape[0] != pad_cols:
            if x.shape[0] != true_cols:
                raise ValueError(f"{op}: runtime input leading dim "
                                 f"{x.shape[0]} != operand cols {true_cols}")
            xp = x.new_zeros((pad_cols,) + tuple(x.shape[1:]))
            xp[:true_cols] = x
            x = xp
        return _exec_matvec(st, x, backend, tile)[:true_rows]

    return Plan(op=op, schedule=sched, backend=backend, _run=run,
                device=device, operands=(st,))


# ---------------------------------------------------------------------------
# spmv / spmm — stacked bucket launch
# ---------------------------------------------------------------------------

def _exec_matvec_stacked(arrays: Dict[str, torch.Tensor], xs: torch.Tensor,
                         layout: str, backend: str) -> torch.Tensor:
    """One launch for a whole same-schedule bucket: member axis leading.

    ``xs`` is (B, n_bc*bs) or (B, n_bc*bs, k); returns (B, n_br*bs[, k]).
    """
    multi = xs.dim() == 3
    if layout == "dense":
        dense = arrays["dense"]
        return dense @ xs if multi else (dense @ xs.unsqueeze(-1)).squeeze(-1)
    bs = arrays["blocks"].shape[-1]
    n_bc = xs.shape[1] // bs
    xb = (xs.reshape(xs.shape[0], n_bc, bs, xs.shape[-1]) if multi
          else xs.reshape(xs.shape[0], n_bc, bs))
    y = _run_layout(arrays, layout, xb, backend)
    if multi:
        return y.reshape(y.shape[0], y.shape[1] * y.shape[2], y.shape[3])
    return y.reshape(y.shape[0], -1)


def _stack_pad(mats: Sequence[np.ndarray], fill,
               edge_dims: Tuple[int, ...] = ()) -> np.ndarray:
    """Stack host arrays along a new axis 0, padding each to the common max
    shape with ``fill`` (scalar or per-member list). Dims listed in
    ``edge_dims`` are additionally rounded up to bucket edges."""
    shape = [max(m.shape[d] for m in mats) for d in range(mats[0].ndim)]
    for d in edge_dims:
        shape[d] = bucket_edge(shape[d])
    fills = fill if isinstance(fill, (list, tuple)) else [fill] * len(mats)
    out = np.stack([np.full(tuple(shape), f, dtype=mats[0].dtype)
                    for f in fills])
    for i, m in enumerate(mats):
        out[(i,) + tuple(slice(0, s) for s in m.shape)] = m
    return out


def _bucket_hosts(members: List, schedule: Schedule, sigma: int) -> List:
    """Per-member host containers WITHOUT device staging — the stacked
    launch uploads only the padded stacks."""
    hosts = []
    for m in members:
        if isinstance(m, SparseTensor):
            hosts.append(m.to_host())
        elif isinstance(m, CSR):
            hosts.append(SparseTensor.build_container(m, schedule,
                                                      sigma=sigma))
        else:
            hosts.append(m)   # already an ELLBSR/SELLBSR/dense container
    return hosts


def _member_tensors(members: List, schedule: Schedule, sigma: int,
                    shape_bucket: bool, store, member_keys,
                    device: torch.device):
    """Device-resident prepared ``SparseTensor`` per member, through the
    SAME store key the single-request planner uses — or None when the
    bucket cannot take the resident-stacking path (no store, unkeyed or
    non-CSR members). A tenant warmed by either path is warm for both."""
    if store is None or member_keys is None:
        return None
    keys = list(member_keys)
    if len(keys) != len(members) or not all(keys):
        return None
    if not all(isinstance(m, CSR) for m in members):
        return None
    sts = []
    for m, ck in zip(members, keys):
        skey = ("matvec", ck, schedule, None, sigma, None,
                bool(shape_bucket), str(device))
        sts.append(_cached(store, skey, lambda m=m: SparseTensor.from_csr(
            m, schedule=schedule, sigma=sigma,
            shape_bucket=bool(shape_bucket),
            slack=getattr(m, "mutation_slack", 0), device=device)))
    if len({st.layout for st in sts}) != 1:
        return None
    return sts


def _pad_to(t: torch.Tensor, shape: Sequence[int], fill=0) -> torch.Tensor:
    """``t`` in the top-left corner of a ``shape`` tensor filled with
    ``fill``."""
    out = torch.full(tuple(shape), fill, dtype=t.dtype, device=t.device)
    out[tuple(slice(0, s) for s in t.shape)] = t
    return out


def _stack_resident(sts: List, shape_bucket: bool):
    """Stacked bucket arrays built ON DEVICE from per-member prepared
    containers (pad to common edge dims + ``torch.stack``). Pad fills
    mirror ``_build_matvec_bucket``: extra ell/sell cells point at the
    member's own all-zeros block, ``cell_row`` extends the last sorted row,
    ``row_perm`` extends with identity, ``cell_ptr`` gives the member's last
    row one pad cell past its live cells (extra rows own none) and
    ``cell_valid`` is the member's own (extra rows 0)."""
    layout = sts[0].layout
    shapes = [st.true_shape for st in sts]
    if layout == "dense":
        ds = [st.arrays["dense"] for st in sts]
        tgt = [max(d.shape[i] for d in ds) for i in (0, 1)]
        if shape_bucket:
            tgt = [bucket_edge(t) for t in tgt]
        arrays = {"dense": torch.stack([_pad_to(d, tgt) for d in ds])}
        return {"arrays": arrays, "shapes": shapes, "layout": layout,
                "bs": sts[0].block_size, "width": int(tgt[1])}
    bs = sts[0].block_size
    A = [st.arrays for st in sts]
    nb = max(a["blocks"].shape[0] for a in A)
    n_bc = -(-max(s[1] for s in shapes) // bs)
    if shape_bucket:
        nb, n_bc = bucket_edge(nb), bucket_edge(n_bc)
    blocks = torch.stack([_pad_to(a["blocks"], (nb, bs, bs)) for a in A])
    if layout == "ell":
        n_br = max(a["block_indices"].shape[0] for a in A)
        width = max(a["block_indices"].shape[1] for a in A)
        if shape_bucket:
            n_br, width = bucket_edge(n_br), bucket_edge(width)
        arrays = {
            # pad slots point at this member's own all-zeros block
            "block_indices": torch.stack([
                _pad_to(a["block_indices"], (n_br, width),
                        st._zero_idx if st._zero_idx is not None
                        else a["blocks"].shape[0] - 1)
                for a, st in zip(A, sts)]),
            "block_cols": torch.stack([_pad_to(a["block_cols"],
                                               (n_br, width)) for a in A]),
            # pad rows own no real slot
            "valid_counts": torch.stack([_pad_to(a["valid_counts"], (n_br,))
                                         for a in A]),
            "blocks": blocks}
    else:  # sell
        n_cells = max(a["cell_block"].shape[0] for a in A)
        n_br = max(a["row_perm"].shape[0] for a in A)
        if shape_bucket:
            n_cells, n_br = bucket_edge(n_cells), bucket_edge(n_br)
        cb, cr, rp, ptr = [], [], [], []
        for a, st in zip(A, sts):
            zero = (st._zero_idx if st._zero_idx is not None
                    else a["blocks"].shape[0] - 1)
            cb.append(_pad_to(a["cell_block"], (n_cells,), zero))
            # pad cells extend the member's LAST sorted row
            last = int(a["cell_row"][-1]) if a["cell_row"].shape[0] else 0
            row = _pad_to(a["cell_row"], (n_cells,), last)
            cr.append(row)
            perm = a["row_perm"]
            rp.append(torch.cat([perm, torch.arange(
                perm.shape[0], n_br, dtype=perm.dtype, device=perm.device)]))
            # the member's own pointer, extra rows empty; when the stack
            # first pads this member past its cells, its last row takes one
            # of the pad cells (as ``sell_row_ptr`` gives it)
            p = a["cell_ptr"]
            p = torch.cat([p, p[-1:].expand(n_br + 1 - p.shape[0])])
            own = a["cell_block"].shape[0]
            if n_cells > own and (st._live_cells is None
                                  or st._live_cells >= own):
                p[last + 1:] += 1
            ptr.append(p)
        arrays = {
            "cell_block": torch.stack(cb),
            "cell_col": torch.stack([_pad_to(a["cell_col"], (n_cells,))
                                     for a in A]),
            "cell_row": torch.stack(cr),
            "row_perm": torch.stack(rp),
            "cell_ptr": torch.stack(ptr),
            "cell_valid": torch.stack([_pad_to(a["cell_valid"], (n_br,))
                                       for a in A]),
            "blocks": blocks}
    return {"arrays": arrays, "shapes": shapes, "layout": layout,
            "bs": bs, "width": int(n_bc * bs)}


def _members_key(kind: str, members: List, schedule: Schedule,
                 extra: Tuple = (),
                 member_keys: Optional[Sequence[str]] = None
                 ) -> Optional[Tuple]:
    """Store key for a bucket of CSR members (None = uncacheable member).
    ``member_keys`` lets a caller that already hashed its matrices skip the
    second O(nnz) hashing pass; one key per member operand (two per
    spgemm/spadd pair), in member order."""
    keys = []
    ki = iter(member_keys) if member_keys is not None else None
    for m in members:
        for p in (m if isinstance(m, (tuple, list)) else (m,)):
            if ki is not None:
                k = next(ki, None)
                if k is None:
                    return None
                keys.append(k)
            elif isinstance(p, CSR):
                keys.append(content_key(p))
            else:
                return None
    return (kind, schedule) + extra + (tuple(keys),)


def _build_matvec_bucket(members: List, schedule: Schedule, sigma: int,
                         shape_bucket: bool, device: torch.device,
                         store=None, member_keys=None):
    sts = _member_tensors(members, schedule, sigma, shape_bucket, store,
                          member_keys, device)
    if sts is not None:
        return _stack_resident(sts, shape_bucket)
    hosts = _bucket_hosts(members, schedule, sigma)
    kinds = {("dense" if isinstance(h, np.ndarray) else
              "sell" if isinstance(h, SELLBSR) else "ell") for h in hosts}
    if len(kinds) != 1:
        raise ValueError(f"bucket mixes layouts {sorted(kinds)}; a bucket "
                         "shares one Schedule by construction")
    layout = kinds.pop()
    # True (unbucketed) output shapes: a SparseTensor member may itself be
    # shape-bucketed, its host container then carrying the padded shape.
    shapes = [m.true_shape if isinstance(m, SparseTensor) else h.shape
              for m, h in zip(members, hosts)]
    ed = (0,) if shape_bucket else ()
    ed2 = (0, 1) if shape_bucket else ()

    def put(a):
        return torch.as_tensor(a, device=device)

    if layout == "dense":
        arrays = {"dense": put(_stack_pad(
            [np.asarray(h, np.float32) for h in hosts], 0.0,
            edge_dims=ed2))}
        bs = schedule.block_size
        width = int(arrays["dense"].shape[2])
    else:
        bs = hosts[0].block_size
        # Per-member pad slots must keep pointing at that member's own
        # all-zeros block (its index differs member to member).
        zero_idx = [m._zero_idx if isinstance(m, SparseTensor)
                    and m._zero_idx is not None else h.blocks.shape[0] - 1
                    for m, h in zip(members, hosts)]
        blocks = put(_stack_pad([h.blocks.astype(np.float32) for h in hosts],
                                0.0, edge_dims=ed))
        if layout == "ell":
            arrays = {
                "block_indices": put(_stack_pad(
                    [h.block_indices for h in hosts], zero_idx,
                    edge_dims=ed2)),
                "block_cols": put(_stack_pad(
                    [h.block_cols for h in hosts], 0, edge_dims=ed2)),
                # pad rows own no real slot
                "valid_counts": put(_stack_pad(
                    [h.valid_counts for h in hosts], 0, edge_dims=ed)),
                "blocks": blocks,
            }
        else:
            n_br = max(h.n_block_rows for h in hosts)
            if shape_bucket:
                n_br = bucket_edge(n_br)
            # pad cells extend the member's LAST sorted row (the zero block
            # times x_blocks[0]), keeping cell_row nondecreasing as in the
            # JAX container
            cell_row = _stack_pad(
                [h.cell_row for h in hosts],
                [int(h.cell_row[-1]) if h.cell_row.size else 0
                 for h in hosts], edge_dims=ed)
            cell_block = _stack_pad([h.cell_block for h in hosts], zero_idx,
                                    edge_dims=ed)
            # each member's live cells (a SparseTensor member's exclude its
            # own bucket pad cells) and one pad cell past them for its last
            # row; the stack's extra rows own no cells
            lives = [m._live_cells if isinstance(m, SparseTensor)
                     and m._live_cells is not None else h.n_cells
                     for m, h in zip(members, hosts)]
            ptr = np.stack([sell_row_ptr(r, n_br, live)
                            for r, live in zip(cell_row, lives)])
            arrays = {
                "cell_block": put(cell_block),
                "cell_col": put(_stack_pad(
                    [h.cell_col for h in hosts], 0, edge_dims=ed)),
                "cell_row": put(cell_row),
                "cell_ptr": put(ptr),
                "cell_valid": put(np.stack([
                    sell_cell_valid(c, p, z)
                    for c, p, z in zip(cell_block, ptr, zero_idx)])),
                # identity-extend each member's permutation so padded sorted
                # rows scatter onto padded (sliced-away) output rows
                "row_perm": put(np.stack([
                    np.concatenate([h.row_perm,
                                    np.arange(h.n_block_rows, n_br,
                                              dtype=np.int32)])
                    for h in hosts])),
                "blocks": blocks,
            }
        n_bc = -(-max(h.shape[1] for h in hosts) // bs)
        if shape_bucket:
            n_bc = bucket_edge(n_bc)
        width = n_bc * bs
    return {"arrays": arrays, "shapes": shapes, "layout": layout,
            "bs": bs, "width": width}


def _plan_matvec_rhs_stacked(members: List, schedule: Schedule,
                             backend: str, *, op: str, device: torch.device,
                             rhs_tile, sigma: int, store, shape_bucket: bool,
                             member_keys) -> Plan:
    """Same-matrix bucket as ONE multi-RHS launch: the matrix's single
    prepared container (the same cached ``SparseTensor`` the per-request
    path uses, so either path warms the other) applied to the members' RHS
    vectors stacked as columns — SpMV x B is one SpMM. k is padded to a
    power of two."""
    inner = _plan_matvec((members[0],), schedule, backend, op=op,
                         device=device, rhs_tile=rhs_tile, sigma=sigma,
                         store=store, shape_bucket=shape_bucket,
                         operand_key=member_keys[0])
    n = len(members)

    def run(xs):
        if len(xs) != n:
            raise ValueError(f"bucket has {n} members, got {len(xs)} "
                             "runtime inputs")
        xs = [_as_input(x, device) for x in xs]
        ndims = {x.dim() for x in xs}
        if len(ndims) != 1:
            raise ValueError("stacked launch needs homogeneous runtime "
                             "inputs (got mixed vector/multi-RHS)")
        if n == 1:
            return [inner._run(xs[0])]
        if ndims == {1}:
            ks, X = None, torch.stack(xs, dim=1)
        else:
            ks = [x.shape[1] for x in xs]
            X = torch.cat(xs, dim=1)
        k = X.shape[1]
        k_pad = (1 << (k - 1).bit_length()) if shape_bucket else k
        if k_pad != k:
            X = torch.cat([X, X.new_zeros((X.shape[0], k_pad - k))], dim=1)
        y = inner._run(X)                       # (true_rows, k_pad)
        if ks is None:
            return [y[:, i] for i in range(n)]
        outs, off = [], 0
        for ki in ks:
            outs.append(y[:, off:off + ki])
            off += ki
        return outs

    return Plan(op=op, schedule=schedule, backend=backend, _run=run,
                device=device, operands=inner.operands, n_members=n)


def _pad_member_axis(built: Dict, b_pad: int) -> Dict:
    """Pad the stacked member axis up to ``b_pad`` with zero members, so
    every occupancy in (prev_edge, b_pad] has the same stacked shapes. A
    zero member's indices are in range (0), its RHS is zeroed by the launch
    wrapper and its ``cell_ptr`` gives every row an empty range (its
    ``cell_valid`` is 0), so its output is exactly zero and sliced away; its ``row_perm`` is the
    identity, so every output row is still written once."""
    arrays = {}
    for k, v in built["arrays"].items():
        extra = b_pad - int(v.shape[0])
        if extra > 0:
            if k == "row_perm":
                pad = torch.arange(v.shape[1], dtype=v.dtype,
                                   device=v.device).expand(extra, -1)
            else:
                pad = v.new_zeros((extra,) + tuple(v.shape[1:]))
            v = torch.cat([v, pad], dim=0)
        arrays[k] = v
    return {**built, "arrays": arrays}


def _plan_matvec_bucket(members: List, schedule: Schedule, backend: str, *,
                        op: str = "spmv", device: torch.device,
                        rhs_tile: Optional[int] = None,
                        sigma: int = SELL_SIGMA,
                        store: Optional[PreparedStore] = None,
                        shape_bucket: bool = True,
                        member_keys=None) -> Plan:
    if (store is not None and member_keys is not None
            and all(member_keys) and len(set(member_keys)) == 1
            and all(isinstance(m, CSR) for m in members)):
        # content-pure bucket: one prepared container, RHS columns stacked
        return _plan_matvec_rhs_stacked(
            members, schedule, backend, op=op, device=device,
            rhs_tile=rhs_tile, sigma=sigma, store=store,
            shape_bucket=bool(shape_bucket), member_keys=member_keys)
    key = None if store is None else _members_key(
        "matvec_bucket", members, schedule,
        extra=(op, sigma, bool(shape_bucket), str(device)),
        member_keys=member_keys)
    b_pad = bucket_edge(len(members)) if shape_bucket else len(members)
    built = _cached(store, key, lambda: _pad_member_axis(
        _build_matvec_bucket(members, schedule, sigma, shape_bucket, device,
                             store=store, member_keys=member_keys), b_pad))
    arrays, shapes = built["arrays"], built["shapes"]
    layout, width = built["layout"], built["width"]
    tile = rhs_tile if rhs_tile is not None else RHS_TILE

    def run(xs):
        if len(xs) != len(shapes):
            raise ValueError(f"bucket has {len(shapes)} members, got "
                             f"{len(xs)} runtime inputs")
        xs = [_as_input(x, device) for x in xs]
        sigs = {(x.dim(),) + tuple(x.shape[1:]) for x in xs}
        if len(sigs) != 1:
            raise ValueError(
                "stacked launch needs homogeneous runtime inputs, got "
                f"{sorted(sigs)}; split the bucket by RHS signature")
        if xs[0].dim() == 2:
            k = xs[0].shape[1]
            xpad = xs[0].new_zeros((b_pad, width, -(-k // tile) * tile))
            for i, x in enumerate(xs):
                xpad[i, : x.shape[0], :k] = x
        else:
            xpad = xs[0].new_zeros((b_pad, width))
            for i, x in enumerate(xs):
                xpad[i, : x.shape[0]] = x
        ys = _exec_matvec_stacked(arrays, xpad, layout, backend)
        if xs[0].dim() == 2:
            return [ys[i, : shapes[i][0], : xs[i].shape[1]]
                    for i in range(len(xs))]
        return [ys[i, : shapes[i][0]] for i in range(len(xs))]

    return Plan(op=op, schedule=schedule, backend=backend, _run=run,
                device=device, n_members=len(shapes))


# ---------------------------------------------------------------------------
# spmv / spmm — sharded launch
# ---------------------------------------------------------------------------

def _shard_devices(device: torch.device, n: int) -> List[torch.device]:
    """Round-robin placement of ``n`` shards: over every card when the
    plan is on the card, else all on ``device``."""
    if device.type != "cuda":
        return [device] * n
    count = torch.cuda.device_count()
    return [torch.device("cuda", (device.index + i) % count)
            for i in range(n)]


def _check_matvec_shards(op: str, sst: ShardedSparseTensor) -> None:
    for st in sst.shards:
        if st.layout not in MATVEC_LAYOUTS:
            raise ValueError(f"{op} needs ell/sell/dense shards, got a "
                             f"{st.layout!r} SparseTensor")


def _plan_matvec_sharded(operands, schedules, backend: str, *, op: str,
                         device: torch.device, part=None,
                         shard_csrs: Optional[List] = None,
                         rhs_tile: Optional[int] = None,
                         sigma: int = SELL_SIGMA,
                         store: Optional[PreparedStore] = None,
                         shape_bucket: bool = True,
                         operand_key: Optional[str] = None) -> Plan:
    """A row-sharded matvec plan: one prepared shard per row range, the
    outputs concatenated by row range on ``device``.

    The shards of a CSR operand under one schedule run as ONE stacked
    launch of the layout's member-axis kernel, the shards as members, all
    reading one x (member stride 0, no copy per shard); the stack is the
    only device copy, under ``("matvec_shards_stacked", ...)``. Shards
    under different schedules (the per-shard selector picking other
    layouts or block sizes for a skewed matrix's shards), and the shards
    of a prepared ``ShardedSparseTensor`` (already on the device, so a
    stack would be a second copy), launch one by one, round-robin over
    the cards. On the card each shard's launch goes on its own CUDA
    stream, which waits for the caller's stream (where x was made), and
    every output joins the caller's stream before the concatenation, so
    nothing passes through the host; a shard on another card gets x by a
    device-to-device copy, which orders itself after both cards' current
    streams, and sends its output back the same way. The per-shard
    containers of a CSR operand ride the store under ``("matvec_shards",
    ...)``. On the CPU the same code runs in order.
    """
    (a,) = operands
    sst: Optional[ShardedSparseTensor] = a if isinstance(
        a, ShardedSparseTensor) else None
    if sst is not None:
        bounds = sst.meta.bounds
        schedules = tuple(s if s is not None else st.meta.schedule
                          for s, st in zip(schedules, sst.shards))
        _check_matvec_shards(op, sst)
        shape, strategy = sst.meta.shape, sst.meta.strategy
    else:
        if part is None:
            raise ValueError("sharded planning needs the RowPartition for a "
                             "CSR operand")
        bounds = part.bounds
        if shard_csrs is None:
            shard_csrs = part.slice(a)
        shape = (int(a.shape[0]), int(a.shape[1]))
        strategy = part.strategy
    n_shards = len(bounds) - 1
    true_rows = [bounds[i + 1] - bounds[i] for i in range(n_shards)]
    n_cols = int(shape[1])
    tile = rhs_tile if rhs_tile is not None else RHS_TILE
    uniform = len(set(schedules)) == 1 and schedules[0] is not None

    def check_x(x):
        x = _as_input(x, device)
        if x.shape[0] != n_cols:
            raise ValueError(f"{op}: runtime input leading dim "
                             f"{x.shape[0]} != operand cols {n_cols}")
        return x

    if uniform and sst is None:
        stack_key = None if store is None else (
            "matvec_shards_stacked", operand_key or content_key(a),
            strategy, bounds, tuple(schedules), sigma, bool(shape_bucket),
            n_shards, str(device))
        built = _cached(store, stack_key, lambda: _build_matvec_bucket(
            shard_csrs, schedules[0], sigma, shape_bucket, device))
        arrays, width, layout = (built["arrays"], built["width"],
                                 built["layout"])

        def run(x):
            x = check_x(x)
            if x.dim() == 2:
                k = x.shape[1]
                xb = x.new_zeros((width, -(-k // tile) * tile))
                xb[: n_cols, :k] = x
            else:
                xb = x.new_zeros((width,))
                xb[: n_cols] = x
            # every shard multiplies the whole x: one x, member stride 0
            xs = xb.unsqueeze(0).expand(n_shards, *xb.shape)
            ys = _exec_matvec_stacked(arrays, xs, layout, backend)
            if x.dim() == 2:
                return torch.cat([ys[i, : true_rows[i], : x.shape[1]]
                                  for i in range(n_shards)])
            return torch.cat([ys[i, : true_rows[i]]
                              for i in range(n_shards)])
    else:
        devs = _shard_devices(device, n_shards)
        if sst is None:
            key = None if store is None else (
                "matvec_shards", operand_key or content_key(a), strategy,
                bounds, tuple(schedules), sigma, bool(shape_bucket),
                str(device))
            sst = _cached(store, key, lambda: ShardedSparseTensor(
                ShardedMeta(shape, bounds, strategy),
                [SparseTensor.from_csr(c, schedule=s, sigma=sigma,
                                       shape_bucket=shape_bucket, device=d)
                 for c, s, d in zip(shard_csrs, schedules, devs)]))
            _check_matvec_shards(op, sst)
        sub = [_plan_matvec((st.to(d),), s, backend, op=op, device=d,
                            rhs_tile=rhs_tile)
               for st, s, d in zip(sst.shards, schedules, devs)]
        streams = ([torch.cuda.Stream(device=d) for d in devs]
                   if device.type == "cuda" else None)

        def run(x):
            x = check_x(x)
            if streams is None:
                return torch.cat([p._run(x) for p in sub])
            caller = torch.cuda.current_stream(device)
            ys = []
            for p, d, s in zip(sub, devs, streams):
                s.wait_stream(caller)               # x is ready
                if d == device:
                    with torch.cuda.stream(s):
                        x.record_stream(s)          # read on s
                        y = p._run(x)
                    ys.append((y, s))
                    continue
                # another card: the copies there and back order themselves
                # after the current streams of both cards (s on d, the
                # caller's here), so neither tensor changes streams
                with torch.cuda.device(d), torch.cuda.stream(s):
                    y = p._run(x.to(d, non_blocking=True))
                    ys.append((y.to(device, non_blocking=True), None))
            for y, s in ys:
                if s is not None:
                    caller.wait_stream(s)
                    y.record_stream(caller)  # made on s, read on the caller
            return torch.cat([y for y, _ in ys])

    return Plan(op=op, schedule=schedules[0] if uniform else None,
                backend=backend, _run=run, device=device,
                operands=(sst,) if sst is not None else (),
                n_members=n_shards, n_shards=n_shards)


# ---------------------------------------------------------------------------
# spgemm / spadd — the executor of their three kernels, host-prep helpers
# ---------------------------------------------------------------------------

# mode -> (CUDA kernel wrapper, plain PyTorch version, device arguments,
# the leaf the wrapper alone takes as a keyword, or None: the pairs'
# per-block counts, spadd's per-member sentinels); both take the arguments
# with an optional leading member axis.
_PAIROP_FNS = {
    "pairs": (GK.bsr_spgemm_pairs_cuda, GR.ref_pair_gemm,
              ("pair_a", "pair_b", "a_blocks", "b_blocks"), "pair_counts"),
    "cells": (GK.bsr_spgemm_cells_cuda, GR.ref_cell_gemm_ptr,
              ("cell_a", "cell_b", "cell_ptr", "a_blocks", "b_blocks"),
              None),
    "spadd": (AK.bsr_spadd_cuda, AR.ref_block_union_add,
              ("ia", "ib", "a_blocks", "b_blocks"), "sentinels"),
}


def pairop_args(dev: Dict[str, torch.Tensor], mode: str,
                n_out: Optional[int] = None
                ) -> Tuple[List[torch.Tensor], Dict[str, torch.Tensor]]:
    """The mode's kernel arguments from a prepared entry's device leaves:
    the positional ones both versions take, and the keyword leaf only the
    CUDA wrapper takes. ``n_out`` keeps only the first ``n_out`` output
    blocks of a single (unstacked) plan: the plan returns the output cut to
    the real block count, so the bucket-pad blocks past it are not computed
    at all."""
    _, _, names, key = _PAIROP_FNS[mode]
    args = [dev[k] for k in names]
    kw = {key: dev[key]} if key else {}
    if n_out is not None:
        # the leading index arrays and the pair counts are per output block
        # (pairs, spadd; spadd's sentinels are per member), or the pointer
        # is (cells: n_out + 1 entries)
        if mode == "cells":
            args[2] = args[2][: n_out + 1]
        else:
            args[0], args[1] = args[0][:n_out], args[1][:n_out]
        if mode == "pairs":
            kw[key] = kw[key][:n_out]
    return args, kw


def _exec_pairop(dev: Dict[str, torch.Tensor], mode: str, backend: str,
                 n_out: Optional[int] = None) -> torch.Tensor:
    """One launch of the mode's kernel (or its plain version)."""
    cuda_fn, plain_fn, _, _ = _PAIROP_FNS[mode]
    args, kw = pairop_args(dev, mode, n_out)
    return cuda_fn(*args, **kw) if backend == "cuda" else plain_fn(*args)


def _with_zero_block(blocks: np.ndarray, bs: int) -> np.ndarray:
    return np.concatenate(
        [blocks.astype(np.float32), np.zeros((1, bs, bs), np.float32)])


def _pad_rows(arr: np.ndarray, n: int, fill) -> np.ndarray:
    """Pad axis 0 of a host array to ``n`` rows with ``fill``."""
    if arr.shape[0] >= n:
        return arr
    out = np.full((n,) + arr.shape[1:], fill, dtype=arr.dtype)
    out[: arr.shape[0]] = arr
    return out


def _as_bsr(a, bs: int, op: str) -> BSR:
    """Coerce a spgemm/spadd operand — CSR, prepared BSR container, or a
    bsr-layout SparseTensor — to the raw blocked form the symbolic phase
    consumes, validating the block size against the schedule's."""
    if isinstance(a, SparseTensor):
        if a.layout != "bsr":
            raise ValueError(f"{op} operands must be raw blocked (bsr) "
                             f"SparseTensors, got layout {a.layout!r}")
        a = a.to_host()
    if isinstance(a, BSR):
        if a.block_size != bs:
            raise ValueError(f"{op} operand was prepared with block_size "
                             f"{a.block_size}, schedule wants {bs}")
        return a
    return BSR.from_csr(a, bs)


def _bsr_pair(a, b, bs: int, op: str) -> Tuple[BSR, BSR]:
    """Both operands blocked; ``A op A`` blocks its matrix once."""
    bsr_a = _as_bsr(a, bs, op)
    return bsr_a, (bsr_a if b is a else _as_bsr(b, bs, op))


def _put(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a), device=device)


def _result_structure(h: Dict, device: torch.device) -> Dict:
    """C's host structure and its device copy (what every execute hands
    back, so it is uploaded once, at plan time)."""
    return {"c_ptrs": h["c_ptrs"], "c_cols": h["c_cols"], "n_c": h["n_c"],
            "out_shape": h["out_shape"], "bs": h["bs"],
            "c_ptrs_dev": _put(h["c_ptrs"].astype(np.int32), device),
            "c_cols_dev": _put(h["c_cols"], device)}


def _bsr_result(st: Dict, blocks: torch.Tensor,
                schedule: Schedule) -> SparseTensor:
    """C as the port's "bsr" SparseTensor on the plan's device:
    ``to_host()`` gives the BSR the JAX facade returns."""
    meta = SparseMeta("bsr", tuple(st["out_shape"]), st["bs"],
                      n_block_rows=int(st["c_ptrs"].shape[0]) - 1,
                      schedule=schedule)
    return SparseTensor(meta, {"block_ptrs": st["c_ptrs_dev"],
                               "block_cols": st["c_cols_dev"],
                               "blocks": blocks})


# ---------------------------------------------------------------------------
# spgemm — padded pairs ("ell") or flattened cells ("sell" layout axis)
# ---------------------------------------------------------------------------

def _spgemm_host_products(a, b, schedule: Schedule):
    """Host symbolic products + sentinel-extended block arrays (numpy) —
    shared by the single-plan prepare and the stacked bucket build."""
    bs = schedule.block_size
    bsr_a, bsr_b = _bsr_pair(a, b, bs, "spgemm")
    zero_a, zero_b = bsr_a.n_blocks, bsr_b.n_blocks
    a_bl = _with_zero_block(bsr_a.blocks, bs)
    b_bl = _with_zero_block(bsr_b.blocks, bs)
    if schedule.layout == "sell":
        c_ptrs, c_cols, ca, cb, cc = spgemm_symbolic_cells(bsr_a, bsr_b)
        return {"mode": "cells", "c_ptrs": c_ptrs, "c_cols": c_cols,
                "cell_a": ca, "cell_b": cb, "cell_c": cc,
                "a_blocks": a_bl, "b_blocks": b_bl,
                "zero_a": zero_a, "zero_b": zero_b,
                "n_c": int(c_cols.size),
                "out_shape": (a.shape[0], b.shape[1]), "bs": bs}
    c_ptrs, c_cols, pair_a, pair_b = spgemm_symbolic(bsr_a, bsr_b)
    # real pairs lead each row, the sentinels fill the rest
    counts = (pair_a != zero_a).sum(1).astype(np.int32)
    return {"mode": "pairs", "c_ptrs": c_ptrs, "c_cols": c_cols,
            "pair_a": pair_a, "pair_b": pair_b, "pair_counts": counts,
            "a_blocks": a_bl, "b_blocks": b_bl,
            "zero_a": zero_a, "zero_b": zero_b,
            "n_c": int(c_cols.size),
            "out_shape": (a.shape[0], b.shape[1]), "bs": bs}


def _prepare_spgemm(a, b, schedule: Schedule,
                    store: Optional[PreparedStore], shape_bucket: bool,
                    device: torch.device, operand_key: Optional[str] = None):
    """Device-staged (and optionally bucket-padded) spgemm symbolic-phase
    products; cached in the PreparedStore keyed by exact matrix bytes."""
    key = None
    if store is not None and isinstance(a, CSR) and isinstance(b, CSR):
        key = ("spgemm", schedule.block_size, schedule.layout,
               bool(shape_bucket), operand_key or content_key(a),
               content_key(b), str(device))
    return _cached(store, key,
                   lambda: _build_spgemm(a, b, schedule, shape_bucket,
                                         device))


def _build_spgemm(a, b, schedule: Schedule, shape_bucket: bool,
                  device: torch.device):
    h = _spgemm_host_products(a, b, schedule)
    n_c = h["n_c"]
    if h["mode"] == "cells":
        ca, cb, cc = h["cell_a"], h["cell_b"], h["cell_c"]
        n_live, n_c_pad = ca.size, n_c
        if shape_bucket:
            n_cells_p = bucket_edge(ca.size)
            n_c_pad = bucket_edge(n_c)
            ca = _pad_rows(ca, n_cells_p, h["zero_a"])
            cb = _pad_rows(cb, n_cells_p, h["zero_b"])
            cc = _pad_rows(cc, n_cells_p, max(n_c - 1, 0))
            h["a_blocks"] = _pad_rows(h["a_blocks"],
                                      bucket_edge(h["a_blocks"].shape[0]), 0.0)
            h["b_blocks"] = _pad_rows(h["b_blocks"],
                                      bucket_edge(h["b_blocks"].shape[0]), 0.0)
        # the JAX leaves as they are, plus the pointer over the live cells:
        # the pad cells (cell_c = n_c - 1) belong to no output block
        dev = {"cell_a": ca, "cell_b": cb, "cell_c": cc,
               "cell_ptr": spgemm_cell_ptr(cc, n_c_pad, n_live)}
        n_pairs = n_live
    else:
        pa, pb, cnt = h["pair_a"], h["pair_b"], h["pair_counts"]
        n_pairs = int(cnt.sum())
        if shape_bucket and pa.size:
            n_c_p, mp_p = bucket_edge(pa.shape[0]), bucket_edge(pa.shape[1])
            pa2 = np.full((n_c_p, mp_p), h["zero_a"], np.int32)
            pa2[: pa.shape[0], : pa.shape[1]] = pa
            pb2 = np.full((n_c_p, mp_p), h["zero_b"], np.int32)
            pb2[: pb.shape[0], : pb.shape[1]] = pb
            pa, pb = pa2, pb2
            cnt = _pad_rows(cnt, n_c_p, 0)   # pad blocks own no pair
            h["a_blocks"] = _pad_rows(h["a_blocks"],
                                      bucket_edge(h["a_blocks"].shape[0]), 0.0)
            h["b_blocks"] = _pad_rows(h["b_blocks"],
                                      bucket_edge(h["b_blocks"].shape[0]), 0.0)
        dev = {"pair_a": pa, "pair_b": pb, "pair_counts": cnt}
    dev["a_blocks"], dev["b_blocks"] = h["a_blocks"], h["b_blocks"]
    return {"mode": h["mode"],
            "dev": {k: _put(v, device) for k, v in dev.items()},
            "n_pairs": n_pairs, "zero_a": h["zero_a"], "zero_b": h["zero_b"],
            **_result_structure(h, device)}


def _plan_pairop(op: str, prep: Dict, schedule: Schedule,
                 backend: str, device: torch.device) -> Plan:
    """The single-pair Plan of spgemm/spadd: execute() -> C as a "bsr"
    SparseTensor on ``device``. ``operands`` holds the prepared entry (the
    device leaves under ``"dev"``, C's structure, and ``zero_a``/``zero_b``,
    the real tile counts of A and B)."""
    n_c, bs = prep["n_c"], prep["bs"]

    def run():
        if n_c == 0:
            blocks = torch.zeros((0, bs, bs), dtype=torch.float32,
                                 device=device)
        else:
            blocks = _exec_pairop(prep["dev"], prep["mode"], backend,
                                  n_out=n_c)
        return _bsr_result(prep, blocks, schedule)

    return Plan(op=op, schedule=schedule, backend=backend, _run=run,
                device=device, operands=(prep,))


def _plan_spgemm(operands, schedule: Optional[Schedule], backend: str, *,
                 device: torch.device, block_size: int = 128,
                 store: Optional[PreparedStore] = None,
                 shape_bucket: bool = True,
                 operand_key: Optional[str] = None) -> Plan:
    a, b = operands
    if schedule is None:
        schedule = Schedule("bsr", block_size, 1.0)
    if schedule.backend == "dense":
        raise ValueError("dense schedules have no BSR path; dispatch a "
                         "dense matmul instead")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"inner dims mismatch {a.shape} @ {b.shape}")
    prep = _prepare_spgemm(a, b, schedule, store, shape_bucket, device,
                           operand_key)
    return _plan_pairop("spgemm", prep, schedule, backend, device)


# ---------------------------------------------------------------------------
# spgemm / spadd — stacked bucket launches
# ---------------------------------------------------------------------------

def _pair_members(members: List, op: str) -> List[Tuple]:
    pairs = []
    for i, m in enumerate(members):
        if not (isinstance(m, (tuple, list)) and len(m) == 2):
            raise ValueError(f"{op} bucket members are (A, B) operand "
                             f"pairs; member {i} is {type(m).__name__}")
        pairs.append((m[0], m[1]))
    return pairs


def _plan_stacked_pairop(op: str, built: Dict, schedule: Schedule,
                         backend: str, device: torch.device,
                         n_members: int) -> Plan:
    """ONE launch for the whole bucket (the member on the kernel grid);
    execute() -> one "bsr" SparseTensor per member, each a view of the
    stacked output cut to the member's block count."""

    def run():
        cs = _exec_pairop(built["stacked"], built["mode"], backend)
        return [_bsr_result(st, cs[i, : st["n_c"]], schedule)
                for i, st in enumerate(built["members"])]

    return Plan(op=op, schedule=schedule, backend=backend, _run=run,
                device=device, operands=(built,), n_members=n_members)


def _plan_spgemm_bucket(members: List, schedule: Schedule, backend: str, *,
                        device: torch.device,
                        store: Optional[PreparedStore] = None,
                        shape_bucket: bool = True,
                        member_keys=None) -> Plan:
    """ONE stacked launch for a same-schedule spgemm bucket: per-member
    symbolic products are padded to common (edge-rounded) shapes, stacked
    along a member axis, and the numeric phase runs as a single kernel
    launch; results are sliced back per member."""
    if schedule.backend == "dense":
        raise ValueError("dense schedules have no BSR path")
    pairs = _pair_members(members, "spgemm")
    for i, (a, b) in enumerate(pairs):
        if a.shape[1] != b.shape[0]:
            raise ValueError(f"bucket member {i}: inner dims mismatch "
                             f"{a.shape} @ {b.shape}")
    key = None if store is None else _members_key(
        "spgemm_bucket", members, schedule,
        extra=(bool(shape_bucket), str(device)), member_keys=member_keys)
    ed = (0,) if shape_bucket else ()

    def build():
        hs = [_spgemm_host_products(a, b, schedule) for a, b in pairs]
        mode = hs[0]["mode"]
        if mode == "cells":
            stacked = {
                "cell_a": _stack_pad([h["cell_a"] for h in hs],
                                     [h["zero_a"] for h in hs],
                                     edge_dims=ed),
                "cell_b": _stack_pad([h["cell_b"] for h in hs],
                                     [h["zero_b"] for h in hs],
                                     edge_dims=ed),
                # pad cells accumulate zero products onto the member's LAST
                # output block, keeping cell_c nondecreasing
                "cell_c": _stack_pad([h["cell_c"] for h in hs],
                                     [max(h["n_c"] - 1, 0) for h in hs],
                                     edge_dims=ed),
            }
            n_c_pad = max(h["n_c"] for h in hs)
            if shape_bucket:
                n_c_pad = bucket_edge(n_c_pad)
            # each member's pointer over its own live cells: its pad cells
            # and its blocks past its n_c own nothing
            stacked["cell_ptr"] = np.stack([
                spgemm_cell_ptr(cc, n_c_pad, h["cell_c"].size)
                for cc, h in zip(stacked["cell_c"], hs)])
        else:
            ed2 = (0, 1) if shape_bucket else ()
            stacked = {
                "pair_a": _stack_pad([h["pair_a"] for h in hs],
                                     [h["zero_a"] for h in hs],
                                     edge_dims=ed2),
                "pair_b": _stack_pad([h["pair_b"] for h in hs],
                                     [h["zero_b"] for h in hs],
                                     edge_dims=ed2),
                # each member's own counts; its pad blocks own no pair
                "pair_counts": _stack_pad([h["pair_counts"] for h in hs], 0,
                                          edge_dims=ed),
            }
        stacked["a_blocks"] = _stack_pad([h["a_blocks"] for h in hs], 0.0,
                                         edge_dims=ed)
        stacked["b_blocks"] = _stack_pad([h["b_blocks"] for h in hs], 0.0,
                                         edge_dims=ed)
        return {"mode": mode,
                "stacked": {k: _put(v, device) for k, v in stacked.items()},
                "members": [_result_structure(h, device) for h in hs]}

    built = _cached(store, key, build)
    return _plan_stacked_pairop("spgemm", built, schedule, backend, device,
                                len(pairs))


# ---------------------------------------------------------------------------
# spadd
# ---------------------------------------------------------------------------

def _spadd_host_products(a, b, schedule: Schedule):
    bs = schedule.block_size
    bsr_a, bsr_b = _bsr_pair(a, b, bs, "spadd")
    c_ptrs, c_cols, ia, ib = spadd_symbolic(bsr_a, bsr_b)
    return {"c_ptrs": c_ptrs, "c_cols": c_cols, "ia": ia, "ib": ib,
            "a_blocks": _with_zero_block(bsr_a.blocks, bs),
            "b_blocks": _with_zero_block(bsr_b.blocks, bs),
            "zero_a": bsr_a.n_blocks, "zero_b": bsr_b.n_blocks,
            "n_c": int(ia.size), "out_shape": a.shape, "bs": bs}


def _sentinels(h: Dict) -> np.ndarray:
    """A member's ``(zero_a, zero_b)``: every block at or past them is
    +0.0 (the sentinel, then the bucket-pad blocks)."""
    return np.array([h["zero_a"], h["zero_b"]], np.int32)


def _prepare_spadd(a, b, schedule: Schedule,
                   store: Optional[PreparedStore], shape_bucket: bool,
                   device: torch.device, operand_key: Optional[str] = None):
    key = None
    if store is not None and isinstance(a, CSR) and isinstance(b, CSR):
        # layout is irrelevant to spadd prep (only block_size is consumed),
        # so the key deliberately omits it: sell- and ell-schedule plans of
        # the same block size share one cached entry.
        key = ("spadd", schedule.block_size, bool(shape_bucket),
               operand_key or content_key(a), content_key(b), str(device))
    return _cached(store, key,
                   lambda: _build_spadd(a, b, schedule, shape_bucket,
                                        device))


def _build_spadd(a, b, schedule: Schedule, shape_bucket: bool,
                 device: torch.device):
    h = _spadd_host_products(a, b, schedule)
    ia, ib = h["ia"], h["ib"]
    if shape_bucket:
        n_c_p = bucket_edge(h["n_c"])
        ia = _pad_rows(ia, n_c_p, h["zero_a"])
        ib = _pad_rows(ib, n_c_p, h["zero_b"])
        h["a_blocks"] = _pad_rows(h["a_blocks"],
                                  bucket_edge(h["a_blocks"].shape[0]), 0.0)
        h["b_blocks"] = _pad_rows(h["b_blocks"],
                                  bucket_edge(h["b_blocks"].shape[0]), 0.0)
    dev = {"ia": ia, "ib": ib, "a_blocks": h["a_blocks"],
           "b_blocks": h["b_blocks"], "sentinels": _sentinels(h)}
    return {"mode": "spadd",
            "dev": {k: _put(v, device) for k, v in dev.items()},
            "zero_a": h["zero_a"], "zero_b": h["zero_b"],
            **_result_structure(h, device)}


def _plan_spadd(operands, schedule: Optional[Schedule], backend: str, *,
                device: torch.device, block_size: int = 128,
                store: Optional[PreparedStore] = None,
                shape_bucket: bool = True,
                operand_key: Optional[str] = None) -> Plan:
    a, b = operands
    if schedule is None:
        schedule = Schedule("bsr", block_size, 1.0)
    if schedule.backend == "dense":
        raise ValueError("dense schedules have no BSR path; dispatch a "
                         "dense matmul instead")
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    prep = _prepare_spadd(a, b, schedule, store, shape_bucket, device,
                          operand_key)
    return _plan_pairop("spadd", prep, schedule, backend, device)


def _plan_spadd_bucket(members: List, schedule: Schedule, backend: str, *,
                       device: torch.device,
                       store: Optional[PreparedStore] = None,
                       shape_bucket: bool = True,
                       member_keys=None) -> Plan:
    """ONE stacked launch for a same-schedule spadd bucket."""
    if schedule.backend == "dense":
        raise ValueError("dense schedules have no BSR path")
    pairs = _pair_members(members, "spadd")
    for i, (a, b) in enumerate(pairs):
        if a.shape != b.shape:
            raise ValueError(f"bucket member {i}: shape mismatch "
                             f"{a.shape} vs {b.shape}")
    key = None if store is None else _members_key(
        "spadd_bucket", members, schedule,
        extra=(bool(shape_bucket), str(device)), member_keys=member_keys)

    def build():
        hs = [_spadd_host_products(a, b, schedule) for a, b in pairs]
        ed = (0,) if shape_bucket else ()
        stacked = {
            "ia": _stack_pad([h["ia"] for h in hs],
                             [h["zero_a"] for h in hs], edge_dims=ed),
            "ib": _stack_pad([h["ib"] for h in hs],
                             [h["zero_b"] for h in hs], edge_dims=ed),
            "a_blocks": _stack_pad([h["a_blocks"] for h in hs], 0.0,
                                   edge_dims=ed),
            "b_blocks": _stack_pad([h["b_blocks"] for h in hs], 0.0,
                                   edge_dims=ed),
            "sentinels": np.stack([_sentinels(h) for h in hs]),
        }
        return {"mode": "spadd",
                "stacked": {k: _put(v, device) for k, v in stacked.items()},
                "members": [_result_structure(h, device) for h in hs]}

    built = _cached(store, key, build)
    return _plan_stacked_pairop("spadd", built, schedule, backend, device,
                                len(pairs))


# ---------------------------------------------------------------------------
# moe_gmm
# ---------------------------------------------------------------------------

def _as_operand(x, device: torch.device) -> torch.Tensor:
    """A runtime operand on ``device``, float32 or bfloat16 as given (any
    other float becomes float32). A contiguous tensor already on the
    device, such as the decode loop's expert weights, is used as it is."""
    t = torch.as_tensor(x)
    if t.dtype not in (torch.float32, torch.bfloat16):
        t = t.to(torch.float32)
    return t.to(device).contiguous()


def _plan_moe(operands, schedule: Optional[Schedule], backend: str, *,
              device: torch.device, tile_m: Optional[int] = None,
              tile_n: int = 128, tile_k: int = 128,
              store: Optional[PreparedStore] = None) -> Plan:
    (tile_expert,) = operands
    tm = tile_m if tile_m is not None else (
        schedule.block_size if schedule is not None else 128)
    te_host = np.asarray(torch.as_tensor(tile_expert).cpu(), np.int32)
    key = None if store is None else (
        "moe_gmm", array_key(te_host), str(device))
    te = _cached(store, key, lambda: _put(te_host, device))

    def run(x, w):
        x, w = _as_operand(x, device), _as_operand(w, device)
        if te_host.size and (te_host.min() < 0
                             or te_host.max() >= w.shape[0]):
            raise ValueError(f"moe_gmm: tile experts must lie in [0, "
                             f"{w.shape[0]}), got {te_host.min()}.."
                             f"{te_host.max()}")
        if backend == "cuda":
            return MK.moe_gmm_cuda(te, x, w, tile_m=tm, tile_n=tile_n,
                                   tile_k=tile_k)
        MK.check_tiling(x.shape[0], x.shape[1], w.shape[2], tm, tile_n,
                        tile_k)
        return MR.ref_gmm(te, x, w, tile_m=tm)

    return Plan(op="moe_gmm", schedule=schedule, backend=backend, _run=run,
                device=device, operands=(te,))


def moe_tile_schedule(tokens_per_expert, d_model: int, platform,
                      cache=None) -> Schedule:
    """Selector-backed MoE tile choice for the serving decode path.

    The routing histogram is fingerprinted (``routing_fingerprint``) and
    looked up in a ``ScheduleCache`` exactly like a sparse matrix: decode
    ticks with recurring routing shapes hit the cache instead of re-running
    the imbalance rule. The returned Schedule's ``block_size`` is the
    grouped-GEMM ``tile_m`` (Eq. 5 imbalance rule on a miss). Only
    ``platform.name`` is read, as the key.
    """
    fp = None
    if cache is not None:
        if not cache.context:
            cache.context = "moe_gmm"
        fp = routing_fingerprint(tokens_per_expert, d_model, platform.name)
        hit = cache.get(fp)
        if hit is not None:
            return hit
    tile = select_moe_block_size(np.asarray(tokens_per_expert, np.float64),
                                 d_model, platform)
    sched = Schedule("bsr", tile, 1.0)
    if cache is not None:
        cache.put(fp, sched, "moe-rule")
    return sched


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------

def _plan_flash(operands, schedule: Optional[Schedule], backend: str, *,
                device: torch.device, causal: bool = True,
                block_q: int = 128, block_k: int = 128) -> Plan:
    if operands not in ((), None):
        raise ValueError("flash_attention takes no planned operands; pass "
                         "q, k, v to execute()")

    def run(q, k, v):
        q, k, v = (_as_operand(t, device) for t in (q, k, v))
        if backend == "cuda":
            return FK.flash_attention_cuda(q, k, v, causal=causal,
                                           block_q=block_q, block_k=block_k)
        FK.check_shapes(q, k, v, block_q, block_k)
        return FR.ref_attention(q, k, v, causal=causal)

    return Plan(op="flash_attention", schedule=schedule, backend=backend,
                _run=run, device=device)


# ---------------------------------------------------------------------------
# dense references — the guard's terminal fallback rung (DESIGN.md §11)
# ---------------------------------------------------------------------------
# Pure-numpy implementations matched to each op's execute() contract: same
# runtime signature, same output type on the plan's device (a tensor, or a
# "bsr" SparseTensor for spgemm/spadd), computed on the host. Builders are
# LAZY by contract (resilience._DENSE_REFS): the builder call does only
# cheap type + size-cap validation — raising TypeError means the guard has
# no dense rung and the chain ends at torch — while the O(n*m)
# densification is deferred (and memoized) inside the returned run, so
# plan() never materializes a dense copy unless the guard actually falls
# to this rung.

def _dense_elems(a) -> int:
    """Element count the dense reference would materialize for one operand
    (cheap: shapes only). Raises TypeError for operand types with no dense
    reference — the same signal `_dense_of` would give, moved to plan time."""
    if isinstance(a, (CSR, BSR)):
        n, m = a.shape
        return int(n) * int(m)
    if isinstance(a, SparseTensor):
        if a.layout == "dense":
            tr, tc = a.true_shape
            return int(tr) * int(tc)
        raise TypeError(f"no dense reference for a prepared {a.layout!r} "
                        "SparseTensor (plan from the CSR to enable the "
                        "dense rung)")
    if isinstance(a, np.ndarray):
        return int(a.size)
    raise TypeError(f"no dense reference for operand {type(a).__name__}")


def _dense_check(a) -> None:
    """Plan-time eligibility gate for the dense rung: unsupported operand
    types and over-cap shapes raise TypeError (→ no dense rung) WITHOUT
    touching any data, so planning a huge matrix never OOMs here."""
    elems = _dense_elems(a)
    cap = dense_ref_cap()
    if elems > cap:
        raise TypeError(f"dense reference refused: {elems} elements exceeds "
                        f"the {cap}-element cap (REPRO_DENSE_REF_MAX_ELEMS)")


def _dense_of(a) -> np.ndarray:
    if isinstance(a, CSR):
        return a.to_dense().astype(np.float32)
    if isinstance(a, BSR):
        return np.asarray(a.to_dense(), np.float32)
    if isinstance(a, SparseTensor):
        if a.layout == "dense":
            tr, tc = a.true_shape
            return a.arrays["dense"].cpu().numpy()[:tr, :tc]
        raise TypeError(f"no dense reference for a prepared {a.layout!r} "
                        "SparseTensor (plan from the CSR to enable the "
                        "dense rung)")
    if isinstance(a, np.ndarray):
        return np.asarray(a, np.float32)
    raise TypeError(f"no dense reference for operand {type(a).__name__}")


def _lazy_dense(a) -> Callable[[], np.ndarray]:
    """Deferred, memoized densification: the dense copy is built on the
    first call — i.e. only once the guard has actually fallen to the dense
    rung — and reused across subsequent launches of the same plan."""
    _dense_check(a)
    box: list = []

    def get() -> np.ndarray:
        if not box:
            box.append(_dense_of(a))
        return box[0]

    return get


def _host(x) -> np.ndarray:
    """A runtime input as a float32 host array (tensors on any device)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x, np.float32)


def _dense_to_bsr(dense: np.ndarray, bs: int, schedule: Optional[Schedule],
                  device: torch.device) -> SparseTensor:
    """Re-block a dense product into the "bsr" SparseTensor spgemm/spadd
    callers get on the plan's device (block structure may differ from the
    symbolic union — ``to_dense()`` equivalence is the contract)."""
    bsr = BSR.from_csr(CSR.from_dense(np.asarray(dense, np.float32)), bs)
    return SparseTensor.from_layout(
        bsr, schedule=(schedule if schedule is not None
                       else Schedule("bsr", bs, 1.0)), device=device)


def _dense_ref_matvec(operands, schedule, device: torch.device, **_):
    (a,) = operands
    ad = _lazy_dense(a)

    def run(x):
        d = ad()
        x = _host(x)
        if x.shape[0] > d.shape[1]:     # bucket-padded RHS: pad is zeros
            x = x[: d.shape[1]]
        return torch.as_tensor(d @ x, device=device)

    return run


def _dense_ref_spgemm(operands, schedule, device: torch.device,
                      block_size: int = 128, **_):
    a, b = operands
    ad, bd = _lazy_dense(a), _lazy_dense(b)
    bs = schedule.block_size if schedule is not None else block_size

    def run():
        return _dense_to_bsr(ad() @ bd(), bs, schedule, device)

    return run


def _dense_ref_spadd(operands, schedule, device: torch.device,
                     block_size: int = 128, **_):
    a, b = operands
    ad, bd = _lazy_dense(a), _lazy_dense(b)
    bs = schedule.block_size if schedule is not None else block_size

    def run():
        return _dense_to_bsr(ad() + bd(), bs, schedule, device)

    return run


def _dense_ref_moe(operands, schedule, device: torch.device,
                   tile_m: Optional[int] = None, **_):
    (tile_expert,) = operands
    tm = tile_m if tile_m is not None else (
        schedule.block_size if schedule is not None else 128)

    def run(x, w):
        te = np.asarray(torch.as_tensor(tile_expert).cpu(), np.int64).ravel()
        x, w = _host(x), _host(w)
        out = np.zeros((x.shape[0], w.shape[2]), np.float32)
        for i, e in enumerate(te):
            lo = i * tm
            hi = min(lo + tm, x.shape[0])
            if lo >= hi:
                break
            out[lo:hi] = x[lo:hi] @ w[int(e)]
        return torch.as_tensor(out, device=device)

    return run


def _dense_ref_flash(operands, schedule, device: torch.device,
                     causal: bool = True, **_):
    def run(q, k, v):
        q, k, v = _host(q), _host(k), _host(v)
        s = np.einsum("bqd,bkd->bqk", q, k) / np.sqrt(q.shape[-1])
        if causal:
            mask = np.tril(np.ones(s.shape[-2:], bool))
            s = np.where(mask, s, -np.inf)
        s = s - s.max(axis=-1, keepdims=True)
        p = np.exp(s)
        p = p / p.sum(axis=-1, keepdims=True)
        return torch.as_tensor(np.einsum("bqk,bkd->bqd", p, v),
                               device=device)

    return run


# ---------------------------------------------------------------------------
# registrations
# ---------------------------------------------------------------------------

def _matvec_bucket_layouts(s: Schedule) -> Tuple[str, ...]:
    return ("dense",) if s.backend == "dense" else (s.layout,)


def _pairop_bucket_layouts(s: Schedule) -> Tuple[str, ...]:
    # spgemm/spadd operands are raw blocked rows whatever the schedule's
    # ell/sell axis says (that axis picks the numeric formulation).
    return ("bsr",)


register_op(
    "spmv", functools.partial(_plan_matvec, op="spmv"),
    operand_spec="(A: CSR | SparseTensor | ELLBSR/SELLBSR) -> execute(x: (n,))",
    layouts=MATVEC_LAYOUTS,
    bucket_planner=functools.partial(_plan_matvec_bucket, op="spmv"),
    bucket_layouts=_matvec_bucket_layouts,
    sharded_planner=functools.partial(_plan_matvec_sharded, op="spmv"))
register_op(
    "spmm", functools.partial(_plan_matvec, op="spmm"),
    operand_spec="(A: CSR | SparseTensor) -> execute(X: (n, k))",
    layouts=MATVEC_LAYOUTS,
    bucket_planner=functools.partial(_plan_matvec_bucket, op="spmm"),
    bucket_layouts=_matvec_bucket_layouts,
    sharded_planner=functools.partial(_plan_matvec_sharded, op="spmm"))
register_op(
    "spgemm", _plan_spgemm,
    operand_spec="(A: CSR, B: CSR) -> execute() -> SparseTensor (bsr)",
    layouts=("ell", "sell"), symbolic=spgemm_symbolic,
    bucket_planner=_plan_spgemm_bucket,
    bucket_layouts=_pairop_bucket_layouts)
# spadd accepts sell-layout schedules (tuner sweeps emit them; the modeled
# spadd time ignores layout) but executes the block-union path either way —
# only block_size is consumed, matching the legacy schedule= contract.
register_op(
    "spadd", _plan_spadd,
    operand_spec="(A: CSR, B: CSR) -> execute() -> SparseTensor (bsr)",
    layouts=("ell", "sell"), symbolic=spadd_symbolic,
    bucket_planner=_plan_spadd_bucket,
    bucket_layouts=_pairop_bucket_layouts)
register_op(
    "moe_gmm", _plan_moe,
    operand_spec="(tile_expert: (M/tile_m,)) -> execute(x: (M, K), "
                 "w: (E, K, N))",
    layouts=("ell",))
register_op(
    "flash_attention", _plan_flash,
    operand_spec="() -> execute(q, k, v: (BH, S, D))",
    layouts=("ell",))
register_dense_ref("spmv", _dense_ref_matvec)
register_dense_ref("spmm", _dense_ref_matvec)
register_dense_ref("spgemm", _dense_ref_spgemm)
register_dense_ref("spadd", _dense_ref_spadd)
register_dense_ref("moe_gmm", _dense_ref_moe)
register_dense_ref("flash_attention", _dense_ref_flash)
