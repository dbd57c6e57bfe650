"""Model facade (port of ``repro.models.model``): a config and its
parameters as one ``nn.Module``, with the training and serving API.

    model = Model(get_config("llama3.2-3b"), device="cuda").init(seed=0)
    loss, metrics = model.loss({"tokens": tokens}); loss.backward()
    logits, cache = model.prefill({"tokens": tokens}, cache_len=S + n)
    logits, cache = model.decode(cache, token, pos)
    out = model.generate(prompt, steps=32)

The reference's ``Model`` is a stateless dataclass whose methods take the
parameter tree; this one holds its parameters (it is a ``transformer.
Params``), so the methods do not. ``init`` draws from an explicit
``torch.Generator`` on the model's device with ``dense_init``'s
distribution; the draws are not JAX's (``repro_torch.convert.
params_from_jax`` carries a JAX tree across instead).
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch
from torch import nn

from ..configs.base import ArchConfig
from ..kernels.common import resolve_device
from . import transformer as tfm


def model_device(device) -> torch.device:
    """``device`` resolved as every entry point does (the card by default,
    raising without one), or the ``meta`` device for shapes only."""
    if torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


def count_params(params: nn.Module) -> int:
    return int(sum(t.numel() for t in params.parameters()))


def count_active_params(cfg: ArchConfig, params: nn.Module) -> int:
    """Params touched per token: MoE expert FFNs scaled by top_k / E."""
    total = count_params(params)
    if not cfg.is_moe:
        return total
    inactive = 0
    for blk in params.blocks:
        for name in ("wi_gate", "wi_up", "wo"):
            w = getattr(blk.ffn, name, None)
            if w is not None:
                n = w.numel()
                inactive += n - n * cfg.top_k // cfg.n_experts
    return total - inactive


class Model(tfm.Params):
    """An LM of config ``cfg`` with its parameters on ``device`` (the card
    unless ``device="cpu"``; ``"meta"`` holds shapes only). The weights are
    uninitialised until ``init`` draws them or a state is loaded."""

    def __init__(self, cfg: ArchConfig, device="cuda") -> None:
        dev = model_device(device)
        super().__init__(cfg, dev)
        self.cfg = cfg
        self.device = dev

    # -------------------------------------------------------------- params
    def init(self, seed: int = 0,
             generator: Optional[torch.Generator] = None) -> "Model":
        """Draw every weight in place from ``generator`` (default: a
        generator on the model's device seeded with ``seed``)."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(seed)
        tfm.draw_params(self, generator)
        return self

    # --------------------------------------------------------------- steps
    def loss(self, batch: Dict[str, torch.Tensor], *,
             remat: str = "dots_no_batch", attn_chunk: int = 1024):
        """(loss, metrics) of ``forward_train`` on ``batch`` (tokens [,
        loss_mask, audio_embed]; moved to the model's device), with
        autograd as the caller has it."""
        return tfm.forward_train(self.cfg, self, self._on_device(batch),
                                 remat=remat, attn_chunk=attn_chunk)

    @torch.no_grad()
    def prefill(self, batch: Dict[str, torch.Tensor], *,
                attn_chunk: int = 1024, cache_len: Optional[int] = None):
        return tfm.forward_prefill(self.cfg, self, self._on_device(batch),
                                   attn_chunk=attn_chunk,
                                   cache_len=cache_len)

    @torch.no_grad()
    def decode(self, cache, token: torch.Tensor,
               pos: Union[int, torch.Tensor]):
        return tfm.forward_decode(self.cfg, self, cache,
                                  torch.as_tensor(token, device=self.device),
                                  pos)

    def init_cache(self, batch: int, max_len: int):
        return tfm.init_cache(self.cfg, batch, max_len, self.device)

    def _on_device(self, batch: Dict) -> Dict[str, torch.Tensor]:
        out = {k: torch.as_tensor(v, device=self.device)
               for k, v in batch.items()}
        out["tokens"] = out["tokens"].long()
        return out

    # ------------------------------------------------------------ sampling
    @torch.no_grad()
    def generate(self, prompt: torch.Tensor, steps: int,
                 max_len: Optional[int] = None, temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 audio_embed: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
        """Greedy (``temperature <= 0`` or no generator) or temperature
        sampling; returns the (B, steps) generated tokens. Encoder-decoder
        configs take the frames as ``audio_embed`` (B, encoder_len, d)."""
        prompt = torch.as_tensor(prompt, device=self.device)
        b, s = prompt.shape
        max_len = max_len or (s + steps)
        batch = {"tokens": prompt}
        if audio_embed is not None:
            batch["audio_embed"] = audio_embed
        logits, cache = self.prefill(batch, cache_len=max_len)
        toks = []
        tok = self._sample(logits, temperature, generator)
        for i in range(steps):
            toks.append(tok)
            logits, cache = self.decode(cache, tok, s + i)
            tok = self._sample(logits, temperature, generator)
        return torch.stack(toks, dim=1)

    @staticmethod
    def _sample(logits: torch.Tensor, temperature: float,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        if temperature <= 0.0 or generator is None:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]
