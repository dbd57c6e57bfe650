"""Sharding rules (port of ``repro.launch.sharding``): the logical-axis
map and path-based parameter, batch and cache specs.

Strategy per DESIGN.md §6:
  params  -- FSDP over "data" x tensor-parallel over "model" where the
             arch's dims divide the 16-way model axis; otherwise FSDP over
             ("data", "model") combined (ZeRO-3-style), which always
             divides because every assigned d_model % 256 == 0.
  acts    -- batch over ("pod", "data"); heads/ffn/vocab/experts over
             "model" when divisible (see DESIGN.md §5).
  caches  -- KV sequence dim over "model".
  MoE     -- experts over "model" when E % 16 == 0 (dbrx: EP all-to-all);
             otherwise d_ff over "model" (mixtral: TP).

A spec is a tuple with one entry per tensor dim, as ``PartitionSpec``
holds them: a mesh-axis name, a tuple of names (the dim split over both,
the first major) or None. ``as_named`` turns specs into DTensor
placements on a ``DeviceMesh``. The rules read only the mesh's axis names
and sizes, so a stand-in (an object with ``axis_names`` and a ``shape``
dict) serves for rule math without a process group.

The port's parameters are per layer (``blocks.{l}.mixer.wq``) where the
reference stacks each pattern position over its groups: a block or
encoder parameter gets the reference leaf's spec without its leading
group entry, the leaf being ``blocks[l % len(layer_pattern)]`` (as
``convert.params_from_jax`` maps them). The port's caches are per layer
too, (B, S, KV, D) where the reference's are (G, B, S, KV, D), so every
dim index of the reference's cache rules is one less here.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, NamedTuple, Optional, Tuple

from ..configs.base import ArchConfig, ShapeConfig
from .mesh import axis_names, axis_sizes, dp_axes

TP_AXIS = "model"
Spec = Tuple[Any, ...]


def tp_size(mesh) -> int:
    return axis_sizes(mesh)[TP_AXIS]


def divisible(n: int, d: int) -> bool:
    return d > 0 and n % d == 0


# ---------------------------------------------------------------- logical
def logical_rules(cfg: ArchConfig, mesh,
                  batch_size: Optional[int] = None,
                  seq_len: Optional[int] = None) -> Dict[str, Any]:
    tp = tp_size(mesh)
    sizes = axis_sizes(mesh)
    dpa = dp_axes(mesh)
    dp_total = 1
    for a in dpa:
        dp_total *= sizes[a]
    batch_axes: Any = dpa
    if batch_size is not None and batch_size % dp_total != 0:
        # long_500k (B=1): replicate batch rather than shard unevenly.
        batch_axes = None
    w = cfg.lru_width or cfg.d_model
    return {
        "batch": batch_axes,
        "heads": TP_AXIS if divisible(cfg.n_heads, tp) else None,
        "kv_heads": TP_AXIS if divisible(cfg.n_kv_heads, tp) else None,
        "ffn": TP_AXIS if (divisible(cfg.d_ff, tp) or divisible(w, tp)) else None,
        "vocab": TP_AXIS,
        "experts": TP_AXIS if divisible(cfg.n_experts, tp) else None,
        # MoE hidden dim: TP only when experts are NOT expert-parallel
        # (both on "model" would duplicate the axis in one spec).
        "moe_ffn": (TP_AXIS if (not divisible(cfg.n_experts, tp)
                                and divisible(cfg.d_ff, tp)) else None),
        "expert_dm": None,
        # §Perf H-AR2: the TP-MoE expert output is a partial sum over the
        # ff contraction; sharding its d_model dim over the model axis
        # turns its all-reduce into a reduce-scatter.
        "moe_out_dm": (TP_AXIS if (not divisible(cfg.n_experts, tp)
                                   and divisible(cfg.d_model, tp)) else None),
        "kv_seq": TP_AXIS,
        # sequence parallelism for the residual stream (disabled for
        # decode, S=1, by the launcher)
        "act_seq": TP_AXIS if divisible(seq_len or 0, tp) else None,
        # context parallelism for archs whose head counts don't divide the
        # model axis: queries and scores shard on the sequence dim
        "attn_q_seq": (TP_AXIS if (not divisible(cfg.n_heads, tp)
                                   and divisible(seq_len or 0, tp)) else None),
    }


def heads_shardable(cfg: ArchConfig, mesh) -> bool:
    return divisible(cfg.n_heads, tp_size(mesh))


def moe_ep(cfg: ArchConfig, mesh) -> bool:
    return divisible(cfg.n_experts, tp_size(mesh))


# ----------------------------------------------------------------- params
def reference_path(cfg: ArchConfig, name: str) -> Tuple[str, ...]:
    """The reference tree's path of the port parameter ``name``:
    ``blocks.{l}.x.y`` -> ``("blocks", str(l % pattern_len), "x", "y")``,
    ``encoder.{i}.x.y`` -> ``("encoder", "x", "y")``."""
    parts = name.split(".")
    if parts[0] == "blocks":
        return ("blocks", str(int(parts[1]) % cfg.pattern_len), *parts[2:])
    if parts[0] == "encoder":
        return ("encoder", *parts[2:])
    return tuple(parts)


def param_specs(cfg: ArchConfig, named_params: Iterable, mesh
                ) -> Dict[str, Spec]:
    """{name: spec} for ``named_params`` (``model.named_parameters()`` or
    a dict of them), by the reference's path rules."""
    hs = heads_shardable(cfg, mesh)
    kvs = divisible(cfg.n_kv_heads, tp_size(mesh))
    ep = moe_ep(cfg, mesh)
    ffn_tp = divisible(cfg.d_ff, tp_size(mesh))
    w_tp = divisible(cfg.lru_width or cfg.d_model, tp_size(mesh))
    fsdp_all = ("data", TP_AXIS)

    def under(path, seg):
        return seg in path[:-1]

    def spec_for(path: Tuple[str, ...], nd: int) -> Spec:
        name = path[-1]
        if name == "embed":
            return (TP_AXIS, "data")
        if name == "unembed":
            return ("data", TP_AXIS)
        # --- norms / small vectors
        if name in ("scale", "bias", "a_log", "dt_bias", "d_skip",
                    "norm_scale", "lam"):
            return (None,) * nd
        if name == "conv_w":
            # the reference tests "rglru" in the joined path, which names
            # positions, not kinds: kept as written
            return (None, TP_AXIS if w_tp and "rglru" in "/".join(path)
                    else None)
        # --- attention
        if under(path, "mixer") and name == "wq":
            return ("data", TP_AXIS) if hs else (fsdp_all, None)
        if under(path, "mixer") and name in ("wk", "wv"):
            if kvs:
                return ("data", TP_AXIS)
            return ("data", None) if hs else (fsdp_all, None)
        if under(path, "mixer") and name == "wo" and nd == 2:
            return (TP_AXIS, "data") if hs else (fsdp_all, None)
        if under(path, "cross"):
            if name == "wq":
                return ("data", TP_AXIS) if hs else (fsdp_all, None)
            if name in ("wk", "wv"):
                return (("data", TP_AXIS) if kvs else
                        (("data", None) if hs else (fsdp_all, None)))
            if name == "wo":
                return (TP_AXIS, "data") if hs else (fsdp_all, None)
        # --- MoE
        if name == "router":
            return ("data", None)
        if under(path, "ffn") and nd == 3:  # (E, d, ff) expert weights
            if name in ("wi_gate", "wi_up"):
                return ((TP_AXIS, "data", None) if ep
                        else (None, "data", TP_AXIS))
            if name == "wo":
                return ((TP_AXIS, None, "data") if ep
                        else (None, TP_AXIS, "data"))
        # --- dense FFN
        if name in ("wi_gate", "wi_up", "wi"):
            return ("data", TP_AXIS) if ffn_tp else (fsdp_all, None)
        if name == "wo":
            return (TP_AXIS, "data") if ffn_tp else (fsdp_all, None)
        # --- SSD
        if name == "w_in":
            return ("data", None)
        if name == "w_out":
            return (TP_AXIS, "data") if w_tp else (fsdp_all, None)
        # --- RG-LRU
        if name in ("w_x", "w_gate"):
            return ("data", TP_AXIS) if w_tp else (fsdp_all, None)
        if name in ("w_a", "w_i"):
            return (TP_AXIS, None) if w_tp else (fsdp_all, None)
        # fallback: FSDP on the largest dim
        if nd:
            return ("data",) + (None,) * (nd - 1)
        return ()

    items = (named_params.items() if isinstance(named_params, dict)
             else named_params)
    return {name: spec_for(reference_path(cfg, name), p.dim())
            for name, p in items}


class NamedSharding(NamedTuple):
    """A mesh and the DTensor placements of one tensor on it (the
    reference's ``NamedSharding(mesh, spec)``)."""
    mesh: Any
    placements: list


def placements(mesh, spec: Spec) -> list:
    """DTensor placements of ``spec`` on ``mesh``: per mesh dim,
    ``Shard(d)`` for the tensor dim whose entry names it, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for axis in axis_names(mesh):
        dims = [d for d, e in enumerate(spec)
                if e == axis or (isinstance(e, tuple) and axis in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def as_named(mesh, spec_tree):
    """A ``NamedSharding`` for each spec of a tree (dicts and lists of
    specs; a spec is a tuple)."""
    if isinstance(spec_tree, dict):
        return {k: as_named(mesh, v) for k, v in spec_tree.items()}
    if isinstance(spec_tree, list):
        return [as_named(mesh, v) for v in spec_tree]
    return NamedSharding(mesh, placements(mesh, spec_tree))


# ------------------------------------------------------------------ batch
def _entry(axes):
    """One spec entry of mesh ``axes``, as ``PartitionSpec`` normalizes
    it: a 1-tuple becomes its name."""
    return axes[0] if isinstance(axes, tuple) and len(axes) == 1 else axes


def batch_specs(cfg: ArchConfig, shape: ShapeConfig, mesh) -> Dict:
    rules = logical_rules(cfg, mesh, batch_size=shape.global_batch)
    b = _entry(rules["batch"])
    out = {"tokens": (b, None), "loss_mask": (b, None)}
    if cfg.is_encdec:
        out["audio_embed"] = (b, None, None)
    return out


def cache_specs(cfg: ArchConfig, cache, mesh, batch_size: int) -> list:
    """Specs of a port cache (one dict per layer): KV sequence over the
    model axis, batch over the dp axes if divisible; recurrent states:
    channel / head dims over the model axis."""
    rules = logical_rules(cfg, mesh, batch_size=batch_size)
    b = _entry(rules["batch"])
    tp = tp_size(mesh)

    def over_tp(n: int):
        return TP_AXIS if n % tp == 0 else None

    def leaf_spec(name: str, leaf) -> Spec:
        nd = leaf.dim()
        if name in ("k", "v"):          # (B, S, KV, D)
            return (b, over_tp(leaf.shape[1]), None, None)
        if name == "h" and nd == 4:     # ssd state (B, H, N, P)
            return (b, over_tp(leaf.shape[1]), None, None)
        if name == "h" and nd == 2:     # rglru state (B, W)
            return (b, over_tp(leaf.shape[1]))
        if name == "conv":              # (B, K-1, C)
            return (b, None, over_tp(leaf.shape[2]))
        return (None,) * nd

    def walk(tree):
        if isinstance(tree, list):
            return [walk(c) for c in tree]
        return {k: (walk(v) if isinstance(v, dict) else leaf_spec(k, v))
                for k, v in tree.items()}

    return walk(cache)
