"""End-to-end training driver (port of ``repro.launch.train``): config ->
model -> train step -> deterministic data pipeline -> checkpoints -> the
restart supervisor, on one card (or the CPU with ``--device cpu``), or
data-parallel over N processes with ``--data-parallel N``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
      --reduced --steps 50 --batch 8 --seq 128 --device cuda
  ... add --simulate-failures to exercise the restart path;
  ... add --data-parallel 2 --device cpu for two gloo processes.

Each step's batch is ``SyntheticLMDataset.global_batch_at(step)`` (the
reference's bit for bit), copied to the card from pinned memory without
blocking; encoder-decoder configs draw their frames from
``np.random.default_rng(step)`` as the reference does. A restore brings
back the model and the optimizer state. The reference's TPU scheduler
flags have no counterpart.

``--data-parallel N`` (N >= 1) trains on a ``make_debug_mesh(data=N,
model=1)`` with the reference's logical rules installed. N > 1 spawns N
processes (``torch.multiprocessing``, spawn), joined by
``init_process_group(init_method="tcp://127.0.0.1:<free port>")``: NCCL
on cards (rank r on card r; fewer than N cards raise), gloo on the CPU; N
= 1 runs in this process, a group of one. Each rank holds the whole model
and computes on its rows of the global batch (``shard_batch_at``); the
gradients are reduce-scattered onto each parameter's FSDP shard
(``param_specs`` on the mesh), AdamW updates the shards and the
parameters are gathered back (``train_step.make_train_step``'s
``grad_shardings``). The loss is the ranks' mean, as ``--microbatches N``
takes it in one process, which computes the same sums: a run on N ranks
matches the one-process run with N microbatches (at bf16 compute, not the
run with one: each half's weight gradients are rounded apart). Rank 0
writes the checkpoints; every rank restores from them. A rank that fails
fails the run.

``main`` returns the reference's ``losses``, ``final_step`` and
``restarts``, plus ``loss_steps`` (the step of each loss: a step re-run
after a restore appears again), ``grad_norms``, ``step_ms`` (the median
of the steps after each start's first, each ended by reading its loss,
which waits for the card), ``tok_s`` (batch x seq over that median) and
``optimizer`` (None from spawned ranks); with ``--data-parallel``, also
``grad_reduction``: the collective bytes and counts of one step's
gradient reduction, per primitive, on rank 0.
"""
from __future__ import annotations

import argparse
import datetime
import os
import queue
import socket
import statistics
import tempfile
import time
import traceback
from typing import Optional

import numpy as np
import torch

from ..configs import get_config
from ..data.pipeline import SyntheticLMDataset
from ..models.model import Model, count_params
from ..models.partitioning import logical_axis_rules
from ..optim.adamw import AdamW
from ..optim.schedules import linear_warmup_cosine
from ..train.checkpoint import (CheckpointManager, load_train_state,
                                train_state_tree)
from ..train.fault_tolerance import run_with_restarts
from ..train.train_step import make_train_step, shard_params

# a rank that waits on a dead peer gives up after this long
GROUP_TIMEOUT = datetime.timedelta(seconds=300)


def parse_args(argv: Optional[list] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--save-every", type=int, default=20)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="none")
    ap.add_argument("--attn-chunk", type=int, default=64)
    ap.add_argument("--simulate-failures", action="store_true")
    ap.add_argument("--data-parallel", type=int, default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv: Optional[list] = None, *, model: Optional[Model] = None
         ) -> dict:
    """Train ``model`` when given (its config and weights; ``--arch`` and
    ``--reduced`` then only name it), else a ``Model`` of ``--arch`` drawn
    from seed 0 on ``--device``."""
    args = parse_args(argv)
    n = args.data_parallel
    if n is None:
        return train(args, model)
    if n < 1:
        raise ValueError(f"--data-parallel must be >= 1, got {n}")
    if args.batch % n:
        raise ValueError(f"batch {args.batch} does not split over {n} ranks")
    if torch.device(args.device).type == "cuda":
        from ..kernels.common import resolve_device
        resolve_device(args.device)          # raises without a card
        if torch.cuda.device_count() < n:
            raise RuntimeError(
                f"--data-parallel {n} needs {n} cards, "
                f"{torch.cuda.device_count()} visible")
    port = _free_port()
    if n == 1:
        return _rank_main(0, 1, port, args, model)
    if model is not None:
        raise ValueError("model= trains in this process; --data-parallel "
                         f"{n} spawns {n} processes that draw their own")
    return _spawn(n, port, args)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(n: int, port: int, args) -> dict:
    """Run ``_rank_entry`` in n spawned processes; rank 0's result. A rank
    that fails ends the others and raises with its traceback."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_entry, args=(r, n, port, args,
                                                   results))
             for r in range(n)]
    for p in procs:
        p.start()
    got = {}
    try:
        while len(got) < n:
            try:
                rank, res = results.get(timeout=1.0)
            except queue.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"a data-parallel rank exited with "
                                       f"{dead[0]} and reported nothing")
                continue
            if isinstance(res, str):
                raise RuntimeError(f"data-parallel rank {rank} failed:\n"
                                   f"{res}")
            got[rank] = res
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
                p.join()
    return got[0]


def _rank_entry(rank: int, world: int, port: int, args, results) -> None:
    try:
        res = _rank_main(rank, world, port, args, None)
    except BaseException:
        results.put((rank, traceback.format_exc()))
        raise
    results.put((rank, res if rank == 0 else None))


def _rank_main(rank: int, world: int, port: int, args,
               model: Optional[Model]) -> dict:
    import torch.distributed as dist
    from .mesh import make_debug_mesh
    from .sharding import as_named, logical_rules, param_specs
    cuda = torch.device(args.device).type == "cuda"
    if cuda:
        torch.cuda.set_device(rank)
        device = f"cuda:{rank}"
    else:
        device = args.device
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world,
                            timeout=GROUP_TIMEOUT)
    try:
        mesh = make_debug_mesh(data=world, model=1,
                               device_type="cuda" if cuda else "cpu")
        if model is None:
            model = Model(get_config(args.arch, reduced=args.reduced),
                          device=device).init(seed=0)
        rules = logical_rules(model.cfg, mesh, batch_size=args.batch,
                              seq_len=args.seq)
        shardings = as_named(mesh, param_specs(
            model.cfg, model.named_parameters(), mesh))
        with logical_axis_rules(mesh, rules):
            res = train(args, model, rank=rank, world=world,
                        shardings=shardings)
        if world > 1:       # a live optimizer stays in its process
            res["optimizer"] = None
        return res
    finally:
        dist.destroy_process_group()


def train(args: argparse.Namespace, model: Optional[Model] = None, *,
          rank: int = 0, world: int = 1,
          shardings: Optional[dict] = None) -> dict:
    """The training loop on this process: the whole run without
    ``shardings``, else rank ``rank`` of ``world`` data-parallel ranks
    (the process group and mesh of ``shardings`` running)."""
    if model is None:
        model = Model(get_config(args.arch, reduced=args.reduced),
                      device=args.device).init(seed=0)
    cfg, dev = model.cfg, model.device
    sched = linear_warmup_cosine(args.lr, args.warmup, args.steps)
    state = (shard_params(model, shardings).values() if shardings
             else model.parameters())
    optimizer = AdamW(state, learning_rate=sched)
    step_fn = make_train_step(model, optimizer, remat=args.remat,
                              attn_chunk=args.attn_chunk,
                              microbatches=args.microbatches,
                              grad_shardings=shardings)
    dataset = SyntheticLMDataset(cfg.vocab_size, args.seq, args.batch)
    ckpt = CheckpointManager(args.ckpt_dir, keep=2)
    log = print if rank == 0 else (lambda *a, **k: None)
    log(f"{cfg.name}: {count_params(model)/1e6:.1f}M params")

    losses, loss_steps, grad_norms, times = [], [], [], []
    fresh = {"start": True}

    def to_device(a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if dev.type == "cuda":
            t = t.pin_memory()
        return t.to(dev, non_blocking=True)

    def do_step(step: int) -> None:
        batch = dataset.shard_batch_at(step, rank, world)
        batch = {"tokens": to_device(batch["tokens"].astype(np.int64)),
                 "loss_mask": to_device(batch["loss_mask"])}
        if cfg.is_encdec:
            rng = np.random.default_rng(step)
            rows = args.batch // world
            frames = rng.standard_normal(
                (args.batch, cfg.encoder_len, cfg.d_model)).astype(
                    np.float32)[rank * rows:(rank + 1) * rows]
            batch["audio_embed"] = to_device(frames).to(torch.bfloat16)
        t0 = time.monotonic()
        metrics = step_fn(batch)
        loss = float(metrics["loss"])            # waits for the step
        dt = time.monotonic() - t0
        if not fresh.pop("start", False):
            times.append(dt)
        losses.append(loss)
        loss_steps.append(step)
        grad_norms.append(float(metrics["grad_norm"]))
        if step % args.log_every == 0:
            log(f"step {step:5d} loss {loss:.4f} "
                f"gnorm {grad_norms[-1]:.3f} ({dt:.2f}s)")

    def save(step: int) -> None:
        tree = train_state_tree(model, optimizer)   # every rank gathers
        if rank == 0:
            ckpt.save_async(step, tree, extra={"step": step})

    def restore() -> int:
        ckpt.wait()
        if shardings:
            import torch.distributed as dist
            dist.barrier()                  # rank 0's writes are done
        fresh["start"] = True
        latest = ckpt.latest_step()
        if latest is None:
            return 0
        tree, _ = ckpt.restore(latest, train_state_tree(model, optimizer))
        load_train_state(model, optimizer, tree)
        if shardings:
            from ..optim.adamw import copy_full_into
            for (name, _), s in zip(model.named_parameters(),
                                    optimizer.param_groups[0]["params"]):
                copy_full_into(s, tree["params"][name])
        log(f"restored step {latest}")
        return latest

    failures = ({args.steps // 3: RuntimeError("simulated preemption"),
                 2 * args.steps // 3: OSError("simulated host fault")}
                if args.simulate_failures else None)
    result = run_with_restarts(
        do_step, n_steps=args.steps, save_every=args.save_every,
        save_fn=save, restore_fn=restore, failure_schedule=failures)
    ckpt.wait()
    if losses:
        log(f"done: {result}; loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    else:  # resumed past n_steps from an existing checkpoint dir
        log(f"done: {result}; no new steps executed")
    step_ms = statistics.median(times) * 1e3 if times else None
    out = {"losses": losses, **result, "loss_steps": loss_steps,
           "grad_norms": grad_norms, "step_ms": step_ms,
           "tok_s": (args.batch * args.seq / (step_ms / 1e3)
                     if step_ms else None),
           "optimizer": optimizer}
    if shardings:
        red = step_fn.grad_reduction
        out["grad_reduction"] = None if red is None else {
            "collective_bytes": red.collective_bytes,
            "collective_count": red.collective_count}
    return out


if __name__ == "__main__":
    main()
