"""Abstract inputs per (arch x shape) (port of ``repro.launch.specs``).

The reference builds ``jax.ShapeDtypeStruct`` stand-ins; here every input
is a tensor on the ``meta`` device: shapes and dtypes, no memory, so a
full-size cell builds on any host. The params are a ``Model(cfg,
device="meta")``'s. For the audio / vlm configs the modality frontend is a
stub, as in the reference: whisper gets precomputed frame embeddings
(B, encoder_len, d_model), qwen2-vl token ids.

Two differences from the reference: ``tokens`` are int64 (the port's
embedding gather takes int64 indices; the reference's are int32), and the
decode cache is the port's, one entry per layer (the reference stacks each
pattern position over its groups).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..configs.base import ArchConfig, ShapeConfig
from ..models.model import Model
from ..optim.adamw import OptState

META = torch.device("meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_abstract(cfg: ArchConfig, shape: ShapeConfig
                   ) -> Dict[str, torch.Tensor]:
    b, s = shape.global_batch, shape.seq_len
    out = {"tokens": _meta((b, s), torch.int64),
           "loss_mask": _meta((b, s), torch.float32)}
    if cfg.is_encdec:
        out["audio_embed"] = _meta((b, cfg.encoder_len, cfg.d_model),
                                   torch.bfloat16)
    return out


def abstract_params(model: Model) -> Dict[str, torch.Tensor]:
    """The model's parameters by name; ``model`` lives on ``meta``."""
    if model.device.type != "meta":
        raise ValueError(f"abstract specs need a Model on the meta device, "
                         f"got {model.device}")
    return dict(model.named_parameters())


def train_abstract(model: Model, shape: ShapeConfig
                   ) -> Tuple[Dict[str, torch.Tensor], OptState,
                              Dict[str, torch.Tensor]]:
    """(params, AdamW state, batch): the state is ``step`` and float32
    ``m`` / ``v`` twins of the params, as ``AdamW.opt_state`` holds them."""
    params = abstract_params(model)
    m = {n: _meta(p.shape, torch.float32) for n, p in params.items()}
    v = {n: _meta(p.shape, torch.float32) for n, p in params.items()}
    return params, OptState(0, m, v), batch_abstract(model.cfg, shape)


def prefill_abstract(model: Model, shape: ShapeConfig):
    return abstract_params(model), batch_abstract(model.cfg, shape)


def decode_abstract(model: Model, shape: ShapeConfig):
    """(params, cache, token, pos) for a one-new-token decode step with a
    cache of ``seq_len`` (the decode_* / long_* shape semantics). The port's
    decode takes its position as a Python int (it indexes the cache on the
    host), so ``pos`` is the last slot, ``seq_len - 1``: the new token
    attends to the whole cache."""
    params = abstract_params(model)
    cache = model.init_cache(shape.global_batch, shape.seq_len)
    token = _meta((shape.global_batch,), torch.int64)
    return params, cache, token, shape.seq_len - 1
