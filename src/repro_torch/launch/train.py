"""End-to-end training driver (port of ``repro.launch.train``): config ->
model -> train step -> deterministic data pipeline -> checkpoints -> the
restart supervisor, on one card (or the CPU with ``--device cpu``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
      --reduced --steps 50 --batch 8 --seq 128 --device cuda
  ... add --simulate-failures to exercise the restart path.

There is no mesh: ``--data-parallel`` other than 1 raises (the mesh,
sharding and specs modules are ROADMAP Queue A item 8), and the
reference's TPU scheduler flags have no counterpart. Each step's batch is
``SyntheticLMDataset.global_batch_at(step)`` (the reference's bit for bit),
copied to the card from pinned memory without blocking; encoder-decoder
configs draw their frames from ``np.random.default_rng(step)`` as the
reference does. A restore brings back the model and the optimizer
state.

``main`` returns the reference's ``losses``, ``final_step`` and
``restarts``, plus ``loss_steps`` (the step of each loss: a step re-run
after a restore appears again), ``grad_norms``, ``step_ms`` (the median
of the steps after each start's first, each ended by reading its loss,
which waits for the card), ``tok_s`` (batch x seq over that median) and
``optimizer``.
"""
from __future__ import annotations

import argparse
import os
import statistics
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from ..configs import get_config
from ..data.pipeline import SyntheticLMDataset
from ..models.model import Model, count_params
from ..optim.adamw import AdamW
from ..optim.schedules import linear_warmup_cosine
from ..train.checkpoint import (CheckpointManager, load_train_state,
                                train_state_tree)
from ..train.fault_tolerance import run_with_restarts
from ..train.train_step import make_train_step


def main(argv: Optional[list] = None, *, model: Optional[Model] = None
         ) -> dict:
    """Train ``model`` when given (its config and weights; ``--arch`` and
    ``--reduced`` then only name it), else a ``Model`` of ``--arch`` drawn
    from seed 0 on ``--device``."""
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
    ap.add_argument("--data-parallel", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.data_parallel != 1:
        raise NotImplementedError(
            "--data-parallel needs the device mesh and sharding modules "
            "(ROADMAP Queue A item 8); the port trains on one card")
    if model is None:
        model = Model(get_config(args.arch, reduced=args.reduced),
                      device=args.device).init(seed=0)
    cfg, dev = model.cfg, model.device
    sched = linear_warmup_cosine(args.lr, args.warmup, args.steps)
    optimizer = AdamW(model.parameters(), learning_rate=sched)
    step_fn = make_train_step(model, optimizer, remat=args.remat,
                              attn_chunk=args.attn_chunk,
                              microbatches=args.microbatches)
    dataset = SyntheticLMDataset(cfg.vocab_size, args.seq, args.batch)
    ckpt = CheckpointManager(args.ckpt_dir, keep=2)
    print(f"{cfg.name}: {count_params(model)/1e6:.1f}M params")

    losses, loss_steps, grad_norms, times = [], [], [], []
    fresh = {"start": True}

    def to_device(a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        if dev.type == "cuda":
            t = t.pin_memory()
        return t.to(dev, non_blocking=True)

    def do_step(step: int) -> None:
        batch = dataset.global_batch_at(step)
        batch = {"tokens": to_device(batch["tokens"].astype(np.int64)),
                 "loss_mask": to_device(batch["loss_mask"])}
        if cfg.is_encdec:
            rng = np.random.default_rng(step)
            batch["audio_embed"] = to_device(rng.standard_normal(
                (args.batch, cfg.encoder_len, cfg.d_model)).astype(
                    np.float32)).to(torch.bfloat16)
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
            print(f"step {step:5d} loss {loss:.4f} "
                  f"gnorm {grad_norms[-1]:.3f} ({dt:.2f}s)")

    def save(step: int) -> None:
        ckpt.save_async(step, train_state_tree(model, optimizer),
                        extra={"step": step})

    def restore() -> int:
        ckpt.wait()
        fresh["start"] = True
        latest = ckpt.latest_step()
        if latest is None:
            return 0
        tree, _ = ckpt.restore(latest, train_state_tree(model, optimizer))
        load_train_state(model, optimizer, tree)
        print(f"restored step {latest}")
        return latest

    failures = ({args.steps // 3: RuntimeError("simulated preemption"),
                 2 * args.steps // 3: OSError("simulated host fault")}
                if args.simulate_failures else None)
    result = run_with_restarts(
        do_step, n_steps=args.steps, save_every=args.save_every,
        save_fn=save, restore_fn=restore, failure_schedule=failures)
    ckpt.wait()
    if losses:
        print(f"done: {result}; loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    else:  # resumed past n_steps from an existing checkpoint dir
        print(f"done: {result}; no new steps executed")
    step_ms = statistics.median(times) * 1e3 if times else None
    return {"losses": losses, **result, "loss_steps": loss_steps,
            "grad_norms": grad_norms, "step_ms": step_ms,
            "tok_s": (args.batch * args.seq / (step_ms / 1e3)
                      if step_ms else None),
            "optimizer": optimizer}


if __name__ == "__main__":
    main()
