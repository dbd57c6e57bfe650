"""Dry run of every (arch x shape x mesh) cell (port of
``repro.launch.dryrun``).

The reference lowers and compiles each cell's step for a 256- or 512-chip
mesh and reads XLA's memory and cost analyses. The port builds each cell
on abstract tensors and computes nothing: this entry point takes no
``--device``, by design. For each cell it

  1. starts a fake process group of 256 (16 x 16) or 512 (2 x 16 x 16)
     ranks in this process (``FakeStore``; collectives return at once) as
     the busiest rank, and builds the production mesh on it: (data,
     model) or (pod, data, model), the pod axis its own;
  2. places a ``Model(cfg, device="meta")``'s parameters as DTensors of
     ``param_specs``'s placements (replicated over the pods), the batch
     (and the decode cache) of ``batch_specs`` / ``cache_specs`` (batch
     over (pod, data)), and installs ``logical_rules`` as they stand;
  3. runs one train step (``make_train_step`` with ``grad_shardings``,
     AdamW's moments on the parameters' shards: each gradient is
     reduce-scattered over "data" and all-reduced over "pod"), prefill
     step or decode step on the abstract inputs of ``specs`` under
     ``OpCounter`` (per-chip FLOPs, bytes and collectives of this rank's
     local operators) and ``MemTracker`` (peak bytes of what the step
     allocates on this rank, followed through the DTensor step directly
     on meta tensors);
  4. writes the report to ``reports/dryrun_torch/<arch>__<shape>__<mesh>.
     json`` (or ``--out``), and destroys the group.

The counted rank is the one at coordinate (0, ..., 0, tp - 1): the last
of the model axis. Where ``attn_q_seq`` splits the queries' sequence over
that axis (context parallelism), the port's causal skip leaves each rank
the KV chunks at or below its rows' diagonal, so the last rank computes
every chunk of its rows and rank 0 the fewest; the step waits for the
slowest rank, and the reference's XLA program, which masks every chunk
on every device, is compared with this one.

The report has the reference's keys, without ``cost_analysis`` (the
counter is the one source; ``roofline.analysis`` says why) and with
``collective_count`` (per primitive) added; ``hlo_*_per_chip`` hold the
counted operators' totals. ``memory``: ``argument_bytes`` are the local
shard bytes of the step's inputs (params, AdamW state and batch; params
and batch; params, cache and token), ``output_bytes`` those of its
outputs, ``alias_bytes`` those donated as the reference donates them
(params and optimizer state in train, the cache in decode, updated in
place), ``temp_bytes`` MemTracker's peak on ``meta`` (where the step
runs), and ``per_device_total`` =
arguments + outputs - aliases + temporaries. ``compile_seconds`` is the
cell's build time. Nothing global is set at import (the reference's
``XLA_FLAGS`` line has no counterpart).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b \\
      --shape train_4k [--multi-pod] [--out DIR]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--both-meshes]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
import traceback
from pathlib import Path
from typing import Optional

import torch
from torch import nn
from torch.utils._pytree import tree_leaves

from ..configs import SHAPES, get_config, list_archs, shape_applicable
from ..configs.base import ArchConfig, ShapeConfig
from ..models.model import Model, count_active_params, count_params
from ..models.partitioning import logical_axis_rules
from ..optim.adamw import AdamW
from ..roofline.analysis import roofline_terms
from ..roofline.model_flops import model_bytes, model_flops
from ..roofline.op_analysis import OpCounter
from ..train.serve_step import make_decode_step, make_prefill_step
from ..train.train_step import make_train_step
from . import sharding as shd
from . import specs as specs_mod
from .mesh import make_mesh

REPORT_DIR = Path(__file__).resolve().parents[3] / "reports" / "dryrun_torch"
MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}


def mesh_name_of(multi_pod: bool, mesh_override=None) -> str:
    shape = (mesh_override or MESHES[multi_pod])[0]
    return "x".join(str(s) for s in shape)


@contextlib.contextmanager
def fake_group(world: int, rank: int):
    """A fake process group of ``world`` ranks in this process, which is
    rank ``rank``, destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def busiest_rank(mshape, maxes) -> int:
    """The rank at coordinate (0, ..., 0, tp - 1), the last of the model
    axis (row-major ranks, as ``init_device_mesh`` lays them out): with
    context parallelism it computes the most attention."""
    i = list(maxes).index(shd.TP_AXIS)
    stride = 1
    for s in mshape[i + 1:]:
        stride *= s
    return (mshape[i] - 1) * stride


def _place(t: torch.Tensor, sharding) -> torch.Tensor:
    """``t`` (meta) as a DTensor of ``sharding``: this rank's shard."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, sharding.mesh, sharding.placements,
                             src_data_rank=None)


def _place_params(model: Model, shardings) -> None:
    for name, p in list(model.named_parameters()):
        prefix, _, attr = name.rpartition(".")
        mod = model.get_submodule(prefix) if prefix else model
        new = nn.Parameter(_place(p.detach(), shardings[name]))
        if getattr(p, "stacked", False):
            new.stacked = True
        setattr(mod, attr, new)


def local_bytes(tree) -> int:
    """Bytes of this rank's shards of the tensors in ``tree``."""
    total = 0
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            t = t.to_local() if hasattr(t, "to_local") else t
            total += t.numel() * t.element_size()
    return total


def build_cell(arch: str, shape_name: str, multi_pod: bool,
               attn_chunk: int = 1024, remat: str = "dots_no_batch",
               extra_rules=None, grad_rs: bool = True,
               microbatches: int = 1, mesh_override=None,
               cfg: Optional[ArchConfig] = None,
               shape: Optional[ShapeConfig] = None) -> dict:
    """The report of one cell. mesh_override: (shape tuple, axis names)
    for elastic / degraded meshes, or the small meshes of tests; ``cfg``
    and ``shape`` stand in for ``get_config(arch)`` and
    ``SHAPES[shape_name]`` (reduced cells)."""
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    mesh_name = mesh_name_of(multi_pod, mesh_override)
    if not shape_applicable(cfg, shape):
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped(full-attention long-context)"}
    mshape, maxes = mesh_override or MESHES[multi_pod]
    n_chips = 1
    for s in mshape:
        n_chips *= s

    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor.experimental import implicit_replication
    t0 = time.time()
    with fake_group(n_chips, busiest_rank(mshape, maxes)):
        mesh = make_mesh("cpu", tuple(mshape), tuple(maxes))
        model = Model(cfg, device="meta")
        params_n = count_params(model)
        active_n = count_active_params(cfg, model)
        mf = model_flops(cfg, shape, model)
        mb = model_bytes(cfg, shape, model)
        seq_for_rules = shape.seq_len if shape.kind != "decode" else None
        rules = shd.logical_rules(cfg, mesh, batch_size=shape.global_batch,
                                  seq_len=seq_for_rules)
        if extra_rules:
            rules.update(extra_rules)
        params_sh = shd.as_named(mesh, shd.param_specs(
            cfg, model.named_parameters(), mesh))
        _place_params(model, params_sh)
        batch_sh = shd.as_named(mesh, shd.batch_specs(cfg, shape, mesh))

        def place_batch(batch):
            return {k: _place(v, batch_sh[k]) for k, v in batch.items()}

        with logical_axis_rules(mesh, rules), implicit_replication():
            if shape.kind == "train":
                optimizer = AdamW(model.parameters(), learning_rate=3e-4)
                names = [n for n, _ in model.named_parameters()]
                opt = optimizer.opt_state(names)    # moments on the shards
                _, _, batch = specs_mod.train_abstract(model, shape)
                batch = place_batch(batch)
                step = make_train_step(
                    model, optimizer, remat=remat, attn_chunk=attn_chunk,
                    microbatches=microbatches,
                    grad_shardings=params_sh if grad_rs else None)
                args = (batch,)
                donated = (dict(model.named_parameters()), opt.m, opt.v)
                inputs = donated + (batch,)
            elif shape.kind == "prefill":
                step = make_prefill_step(model, attn_chunk=attn_chunk)
                _, batch = specs_mod.prefill_abstract(model, shape)
                args = (place_batch(batch),)
                donated = ()
                inputs = (dict(model.named_parameters()),) + args
            else:  # decode
                step = make_decode_step(model)
                _, cache, token, pos = specs_mod.decode_abstract(model,
                                                                 shape)
                cache_sh = shd.as_named(mesh, shd.cache_specs(
                    cfg, cache, mesh, shape.global_batch))
                cache = [{k: {n: _place(t, cache_sh[i][k][n])
                              for n, t in c.items()}
                          for k, c in layer.items()}
                         for i, layer in enumerate(cache)]
                token = _place(token, shd.as_named(
                    mesh, (rules["batch"],)))
                args = (cache, token, pos)
                donated = (cache,)
                inputs = (dict(model.named_parameters()), cache, token)
            with MemTracker() as tracker, OpCounter() as counter:
                out = step(*args)
            peak = tracker.get_tracker_snapshot("peak")
        # every tensor of the step is on ``meta``: torch 2.11's tracker
        # also records the fake tensors of DTensor's sharding propagation
        # (global shapes, on the mesh's device type), which later
        # releases skip
        temp = peak.get(torch.device("meta"), {}).get("Total", 0)
        stats = counter.stats()
        n_chips = mesh.size()
    compile_s = time.time() - t0

    arg_b = local_bytes(inputs)
    alias_b = local_bytes(donated)
    # train: the updated params and state (in place) and the metrics
    out_b = local_bytes(out) + (alias_b if shape.kind == "train" else 0)
    mem_per_dev = arg_b + out_b - alias_b + temp
    report = roofline_terms(
        arch=arch, shape=shape_name, mesh_name=mesh_name, n_chips=n_chips,
        stats=stats, memory_per_device=mem_per_dev, model_flops_global=mf,
        model_bytes_global=mb)
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "status": "ok", "n_chips": n_chips,
        "compile_seconds": round(compile_s, 1),
        "param_count": params_n,
        "active_param_count": active_n,
        "model_flops_global": mf,
        "model_bytes_global": mb,
        "memory": {
            "argument_bytes": arg_b,
            "output_bytes": out_b,
            "temp_bytes": temp,
            "alias_bytes": alias_b,
            "per_device_total": mem_per_dev,
        },
        "hlo_flops_per_chip": report.hlo_flops,
        "hlo_bytes_per_chip": report.hlo_bytes,
        "collective_bytes_per_chip": report.collective_bytes,
        "collective_breakdown": report.collective_breakdown,
        "collective_count": stats.collective_count,
        "terms": {"compute_s": report.t_compute, "memory_s": report.t_memory,
                  "collective_s": report.t_collective},
        "bottleneck": report.bottleneck,
        "useful_ratio": report.useful_ratio,
        "roofline_fraction": report.roofline_fraction,
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             report_dir: Path = REPORT_DIR, **kw) -> dict:
    mesh_name = mesh_name_of(multi_pod, kw.get("mesh_override"))
    try:
        out = build_cell(arch, shape_name, multi_pod, **kw)
    except Exception as e:  # a failing cell is a bug we must surface
        out = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "status": f"FAILED: {type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
    report_dir = Path(report_dir)
    report_dir.mkdir(parents=True, exist_ok=True)
    path = report_dir / f"{arch}__{shape_name}__{mesh_name}.json"
    path.write_text(json.dumps(out, indent=1, default=float))
    return out


def cells(arch: Optional[str], shape: Optional[str], all_cells: bool):
    if all_cells:
        return [(a, s) for a in list_archs() for s in SHAPES]
    if not (arch and shape):
        raise SystemExit("--arch and --shape, or --all, are required")
    return [(arch, shape)]


def main(argv: Optional[list] = None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--remat", default="dots_no_batch")
    ap.add_argument("--attn-chunk", type=int, default=1024)
    ap.add_argument("--out", default=str(REPORT_DIR))
    args = ap.parse_args(argv)

    meshes = [args.multi_pod] if not args.both_meshes else [False, True]
    outs = []
    for arch, shape in cells(args.arch, args.shape, args.all):
        for mp in meshes:
            t0 = time.time()
            out = run_cell(arch, shape, mp, report_dir=Path(args.out),
                           remat=args.remat, attn_chunk=args.attn_chunk)
            outs.append(out)
            status = out["status"]
            extra = ""
            if status == "ok":
                extra = (f" C={out['terms']['compute_s']:.2e} "
                         f"M={out['terms']['memory_s']:.2e} "
                         f"X={out['terms']['collective_s']:.2e} "
                         f"{out['bottleneck']:9s} "
                         f"rf={out['roofline_fraction']:.3f} "
                         f"mem/dev={out['memory']['per_device_total']/2**30:.2f}GiB")
            print(f"[{time.time()-t0:7.1f}s] {arch:20s} {shape:12s} "
                  f"{mesh_name_of(mp):8s} {status[:60]:60s}{extra}",
                  flush=True)
    return outs


if __name__ == "__main__":
    main()
