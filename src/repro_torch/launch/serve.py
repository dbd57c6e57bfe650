"""Serving entry point: batched prefill + decode loop (port of
``repro.launch.serve``).

Serves ``--requests`` requests in batches of ``--batch``: each batch's
prompts (drawn from a seeded numpy stream, the reference's) are prefilled
into a cache of ``prompt_len + gen_len`` and decoded greedily for
``--gen-len`` tokens. Runs on the card unless ``--device cpu``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \\
      --device cuda [--reduced] [--requests 8 --prompt-len 32 --gen-len 16]

``main`` returns the reference's result (``throughput_tok_s``,
``outputs``: one (n, gen_len) token array per batch) plus ``prefill_ms``
and ``decode_ms_per_token`` (means over the batches, each ended by a
device synchronize; per batch in ``batch_prefill_ms`` and
``batch_decode_ms_per_token``, the first batch paying the first calls),
``prompts`` (one array per batch), ``audio_embed`` (encoder-decoder
configs: each batch's stub frames, drawn from the prompts' stream after
them as the reference draws them, bfloat16 on the device; else empty) and
``last_logits`` (the last decode
step's logits, on the device).
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from ..configs import get_config
from ..models.model import Model


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: Optional[list] = None, *, model: Optional[Model] = None
         ) -> dict:
    """Serve with ``model`` when given (its config and weights; ``--arch``
    and ``--reduced`` then only name it), else with a ``Model`` of
    ``--arch`` drawn from seed 0 on ``--device``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--attn-chunk", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if model is None:
        cfg = get_config(args.arch, reduced=args.reduced)
        model = Model(cfg, device=args.device).init(seed=0)
    cfg, dev = model.cfg, model.device
    rng = np.random.default_rng(0)
    max_len = args.prompt_len + args.gen_len

    done, latencies, prefill_s, decode_s = 0, [], [], []
    outputs, prompts, audio = [], [], []
    logits = None
    t_start = time.time()
    while done < args.requests:
        n = min(args.batch, args.requests - done)
        batch_prompts = rng.integers(1, cfg.vocab_size,
                                     (args.batch, args.prompt_len))
        batch = {"tokens": torch.as_tensor(batch_prompts.astype(np.int64),
                                           device=dev)}
        if cfg.is_encdec:  # the reference's stub frames, drawn after
            batch["audio_embed"] = torch.as_tensor(rng.standard_normal(
                (args.batch, cfg.encoder_len, cfg.d_model)).astype(
                    np.float32), device=dev).to(torch.bfloat16)
            audio.append(batch["audio_embed"][:n])
        t0 = time.time()
        logits, cache = model.prefill(batch, attn_chunk=args.attn_chunk,
                                      cache_len=max_len)
        tok = torch.argmax(logits, dim=-1)
        _sync(dev)
        t1 = time.time()
        toks = [tok]
        for i in range(args.gen_len - 1):
            logits, cache = model.decode(cache, tok, args.prompt_len + i)
            tok = torch.argmax(logits, dim=-1)
            toks.append(tok)
        gen = torch.stack(toks, dim=1)[:n].cpu().numpy()
        t2 = time.time()
        outputs.append(gen)
        prompts.append(batch_prompts[:n])
        latencies.append(t2 - t0)
        prefill_s.append(t1 - t0)
        decode_s.append((t2 - t1) / max(args.gen_len - 1, 1))
        done += n
    wall = time.time() - t_start
    tput = args.requests * args.gen_len / wall
    print(f"served {args.requests} requests, {tput:.1f} tok/s, "
          f"mean latency {np.mean(latencies):.2f}s")
    return {"throughput_tok_s": tput, "outputs": outputs,
            "prefill_ms": float(np.mean(prefill_s)) * 1e3,
            "decode_ms_per_token": float(np.mean(decode_s)) * 1e3,
            "batch_prefill_ms": [t * 1e3 for t in prefill_s],
            "batch_decode_ms_per_token": [t * 1e3 for t in decode_s],
            "prompts": prompts, "audio_embed": audio, "last_logits": logits}


if __name__ == "__main__":
    main()
