"""spmv / spmm registrations of the plan/execute facade (port of the matvec
part of ``repro.sparse.ops_builtin``).

Each planner resolves its operand into a device ``SparseTensor`` once and
hands back a ``Plan`` whose launch is one call of the layout's kernel: the
CUDA kernel on ``backend="cuda"``, its plain PyTorch version on
``backend="torch"``. Layouts are ell, sell and dense; dense stays
``torch.matmul``, as the JAX package left it to XLA.

Two serving-path hooks ride through every planner, as in the JAX package:
``store`` (a ``PreparedStore``: a warm hit returns the finished device
operands and skips host prep) and ``shape_bucket`` (default on: containers
padded to ``bucket_edge``s).

A bucket of members is ONE launch with the member on the kernel grid
(``blockIdx.z``), where the JAX pallas path looped over members in Python.
A content-pure bucket (every member the same matrix) is one multi-RHS
launch of the single-request container instead.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.autotune import SELL_SIGMA, Schedule
from ..core.csr import CSR, SELLBSR
from ..kernels.bsr_spmv import kernel as K
from ..kernels.bsr_spmv import ref as R
from ..kernels.bsr_spmv.ops import sell_cell_ptr
from .plan import Plan
from .prepared import PreparedStore, bucket_edge, content_key
from .registry import register_op
from .tensor import SparseTensor

MATVEC_LAYOUTS = ("ell", "sell", "dense")
# RHS columns are padded to a multiple of this on both backends: the SpMM
# kernels compute k in tiles of 8 (one CTA per tile).
RHS_TILE = K.RHS_TILE

# (layout, multi-RHS) -> (CUDA kernel wrapper, plain PyTorch version); both
# take the layout's index arrays, the blocks and the blocked RHS, and return
# rows in original order.
_MATVEC_FNS = {
    ("ell", False): (K.bsr_spmv_cuda, R.ref_bsr_spmv),
    ("ell", True): (K.bsr_spmm_cuda, R.ref_bsr_spmm),
    ("sell", False): (K.bsr_spmv_sell_cuda, R.ref_bsr_spmv_sell_perm),
    ("sell", True): (K.bsr_spmm_sell_cuda, R.ref_bsr_spmm_sell_perm),
}
_LAYOUT_ARGS = {
    "ell": ("block_indices", "block_cols", "blocks"),
    "sell": ("cell_block", "cell_col", "cell_ptr", "row_perm", "blocks"),
}


def _cached(store: Optional[PreparedStore], key, builder):
    """Route a host-prep build through the PreparedStore when one is in
    play (``key=None`` marks an uncacheable operand)."""
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
    cuda_fn, plain_fn = _MATVEC_FNS[(layout,
                                     xb.dim() == arrays["blocks"].dim())]
    fn = cuda_fn if backend == "cuda" else plain_fn
    return fn(*(arrays[k] for k in _LAYOUT_ARGS[layout]), xb)


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
                 operand_key: Optional[str] = None, **_) -> Plan:
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
            device=device))
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
            shape_bucket=bool(shape_bucket), device=device)))
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
    ``row_perm`` extends with identity, and ``cell_ptr`` keeps the member's
    own row ranges (extra rows empty)."""
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
            cr.append(_pad_to(a["cell_row"], (n_cells,), last))
            perm = a["row_perm"]
            rp.append(torch.cat([perm, torch.arange(
                perm.shape[0], n_br, dtype=perm.dtype, device=perm.device)]))
            # the member's own row pointer; extra rows own no cells, and the
            # pad cells past its end belong to no row
            p = a["cell_ptr"]
            ptr.append(_pad_to(p, (n_br + 1,), int(p[-1])))
        arrays = {
            "cell_block": torch.stack(cb),
            "cell_col": torch.stack([_pad_to(a["cell_col"], (n_cells,))
                                     for a in A]),
            "cell_row": torch.stack(cr),
            "row_perm": torch.stack(rp),
            "cell_ptr": torch.stack(ptr),
            "blocks": blocks}
    return {"arrays": arrays, "shapes": shapes, "layout": layout,
            "bs": bs, "width": int(n_bc * bs)}


def _members_key(kind: str, members: List, schedule: Schedule,
                 extra: Tuple = (),
                 member_keys: Optional[Sequence[str]] = None
                 ) -> Optional[Tuple]:
    """Store key for a bucket of CSR members (None = uncacheable member).
    ``member_keys`` lets a caller that already hashed its matrices skip the
    second O(nnz) hashing pass; one key per member, in member order."""
    keys = []
    ki = iter(member_keys) if member_keys is not None else None
    for m in members:
        if ki is not None:
            k = next(ki, None)
            if k is None:
                return None
            keys.append(k)
        elif isinstance(m, CSR):
            keys.append(content_key(m))
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
                "blocks": blocks,
            }
        else:
            n_br = max(h.n_block_rows for h in hosts)
            if shape_bucket:
                n_br = bucket_edge(n_br)
            # each member's row pointer over its own live cells (a
            # SparseTensor member's excludes its bucket pad cells); pad
            # cells past it belong to no row
            ptrs = [m.arrays["cell_ptr"].cpu().numpy()
                    if isinstance(m, SparseTensor)
                    else sell_cell_ptr(h.cell_row, h.n_block_rows)
                    for m, h in zip(members, hosts)]
            # pad cells extend the member's LAST sorted row (+0 from the
            # zero block), keeping cell_row nondecreasing as in the JAX
            # container
            cell_row = _stack_pad(
                [h.cell_row for h in hosts],
                [int(h.cell_row[-1]) if h.cell_row.size else 0
                 for h in hosts], edge_dims=ed)
            arrays = {
                "cell_block": put(_stack_pad(
                    [h.cell_block for h in hosts], zero_idx, edge_dims=ed)),
                "cell_col": put(_stack_pad(
                    [h.cell_col for h in hosts], 0, edge_dims=ed)),
                "cell_row": put(cell_row),
                "cell_ptr": put(np.stack([
                    np.pad(p, (0, n_br + 1 - p.size), mode="edge")
                    for p in ptrs])),
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
    wrapper and its ``cell_ptr`` gives every row an empty range, so its
    output is exactly zero and sliced away; its ``row_perm`` is the
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
                        member_keys=None, **_) -> Plan:
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
# registrations
# ---------------------------------------------------------------------------

def _matvec_bucket_layouts(s: Schedule) -> Tuple[str, ...]:
    return ("dense",) if s.backend == "dense" else (s.layout,)


register_op(
    "spmv", functools.partial(_plan_matvec, op="spmv"),
    operand_spec="(A: CSR | SparseTensor | ELLBSR/SELLBSR) -> execute(x: (n,))",
    layouts=MATVEC_LAYOUTS,
    bucket_planner=functools.partial(_plan_matvec_bucket, op="spmv"),
    bucket_layouts=_matvec_bucket_layouts)
register_op(
    "spmm", functools.partial(_plan_matvec, op="spmm"),
    operand_spec="(A: CSR | SparseTensor) -> execute(X: (n, k))",
    layouts=MATVEC_LAYOUTS,
    bucket_planner=functools.partial(_plan_matvec_bucket, op="spmm"),
    bucket_layouts=_matvec_bucket_layouts)
