"""End-to-end driver: train a ~100M-parameter llama-family model for a few
hundred steps on the synthetic LM stream, with checkpointing and simulated
preemptions (port of ``examples/train_lm.py``).

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm \\
          [--steps 300] [--device cpu]

The ~100M config widens the reduced llama3.2 config (12 layers x 768, 12
heads, vocab 32k) and is registered as ``llama-100m`` among the reduced
configs, as the reference's example does.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
from typing import Optional

from repro_torch.configs import get_config
from repro_torch.configs.base import _REDUCED  # registry internals
from repro_torch.launch.train import main as train_main


def llama_100m():
    base = get_config("llama3.2-3b", reduced=True)
    return dataclasses.replace(
        base, name="llama-100m", n_layers=12, d_model=768, n_heads=12,
        n_kv_heads=4, d_head=64, d_ff=2048, vocab_size=32_000)


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--simulate-failures", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    _REDUCED["llama-100m"] = llama_100m
    train_argv = ["--arch", "llama-100m", "--reduced", "--steps",
                  str(args.steps), "--batch", str(args.batch), "--seq",
                  str(args.seq), "--lr", "3e-3", "--ckpt-dir", args.ckpt_dir,
                  "--save-every", "50", "--attn-chunk", "128",
                  "--log-every", "10", "--device", args.device]
    if args.simulate_failures:
        train_argv.append("--simulate-failures")
    res = train_main(train_argv)
    losses = res["losses"]
    print(f"\nfinal: loss {losses[0]:.3f} -> {losses[-1]:.3f} over "
          f"{len(losses)} steps")
    if losses[-1] >= losses[0]:
        sys.exit("loss did not improve")
    return res


if __name__ == "__main__":
    main()
