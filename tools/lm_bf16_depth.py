"""Decode versus forward at depth, in both packages, on the CPU.

mamba2-780m at full width cut to ``L`` layers (``python3
tools/lm_bf16_depth.py L``; 48 is the full depth, ~6 min on 8 cores), on
the reference's weights (``PRNGKey(0)``, carried across), batch 2, a
256-token prompt and 16 greedy tokens: the last decode step's logits
against a full forward's at that position, relative to ``max|logits|``,
for the port and for the JAX package, at float32 and bfloat16 compute.
At bf16 the two round at other places, and the error grows with depth in
both; ``chip_smoke.py``'s families phase bounds mamba2's by it.

    PYTHONPATH=src python3 tools/lm_bf16_depth.py 48
"""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402


def main(n_layers: int, batch: int = 2, prompt_len: int = 256,
         gen: int = 16) -> None:
    for compute in ("float32", "bfloat16"):
        cfg = dataclasses.replace(get_config("mamba2-780m"),
                                  n_layers=n_layers, compute_dtype=compute)
        jcfg = dataclasses.replace(jget("mamba2-780m"), n_layers=n_layers,
                                   compute_dtype=compute)
        jm = JModel(jcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        m = Model(cfg, device="cpu")
        m.load_state_dict(convert.params_from_jax(
            cfg, jax.tree.map(np.asarray, jp)))
        prompt = np.random.default_rng(0).integers(1, cfg.vocab_size,
                                                   (batch, prompt_len))
        lg, cache = m.prefill({"tokens": torch.as_tensor(prompt)},
                              attn_chunk=256, cache_len=prompt_len + gen)
        toks = [torch.argmax(lg, -1)]
        for j in range(gen - 1):
            lg, cache = m.decode(cache, toks[-1], prompt_len + j)
            toks.append(torch.argmax(lg, -1))
        out = torch.stack(toks, 1)
        seq = torch.cat([torch.as_tensor(prompt), out[:, :-1]], 1)
        n = seq.shape[1]
        e_port = cs.rel_err(lg.float().numpy(), cs.logits_at_index(
            m, seq, n - 1, 256).float().numpy())
        jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(prompt, jnp.int32)},
                            attn_chunk=256, cache_len=prompt_len + gen)
        for j in range(gen - 1):
            jl, jc = jm.decode(jp, jc, jnp.asarray(out[:, j].numpy(),
                                                   jnp.int32),
                               jnp.asarray(prompt_len + j, jnp.int32))
        pad = -(-n // 256) * 256 - n
        full = jnp.asarray(torch.cat([seq, seq[:, :pad]], 1).numpy(),
                           jnp.int32)
        h, _, _ = jtfm.apply_stack(jcfg, jp["blocks"],
                                   jtfm.embed_tokens(jcfg, jp, full),
                                   mode="train", attn_chunk=256)
        h = jtfm.apply_norm(jcfg, jp["final_norm"], h)
        jf = jtfm.logits_at(jcfg, jp, h[:, n - 1:n])[:, 0]
        e_jax = cs.rel_err(np.asarray(jl, np.float32),
                           np.asarray(jf, np.float32))
        print(f"layers {n_layers} {compute}: decode vs forward, port "
              f"{e_port:.4e}, reference {e_jax:.4e}", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 48)
