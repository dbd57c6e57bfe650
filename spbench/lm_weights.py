"""The weights of a served model's configuration, drawn by the benchmark from
the run's seed, so that the program and the plain reference are handed the
same values and neither takes them from the other.

Each layer is drawn by its own generator (seeded from the run's seed and the
layer's index) in one call, in the type the model is served in, on the
device, then cut into its weights: a layer can be drawn again, alone and
bit for bit, when the reference needs it. Weights are in the ``x @ W``
layout of the published equations:

- ``wq`` (d, H D), ``wk`` and ``wv`` (d, KV D), ``wo`` (H D, d);
- ``router`` (d, E); ``w_gate`` and ``w_up`` (E, d, ff), ``w_down``
  (E, ff, d): each expert's SwiGLU;
- ``attn_norm`` and ``ffn_norm`` (d,): the RMSNorm scales;
- outside the layers ``embed`` (V, d), ``unembed`` (d, V) and
  ``final_norm`` (d,).

A matrix is normal with std 1/sqrt(fan_in), the embedding standard normal,
a norm scale 1 + N(0, 0.1^2) (not all ones, so that a norm whose scale is
dropped shows). In the first layer each query head's columns of ``wq``
also hold ``SELF_QK`` times its key-value head's columns of ``wk``: a
token's query then meets its own key with a score of about ``SELF_QK
sqrt(D)`` (8 at D = 128) against about N(0, 1.5) for any other key, so
that at 4,096 positions a head gives roughly a quarter of its weight to the
newest token and the rest to the cache. With independent ``wq`` and ``wk``
a head spreads its weight evenly over the cache, and a decode step that
wrote nothing into it, or read nothing from it, would move the logits by
less than rounding. Only the first layer: the same coupling gives an
earlier position holding the same token nearly as much weight, and from
the second layer on a position's keys and values depend on its routing,
which rounding may flip at a near-tie; a later position that leaned on
them would then differ from the reference by a share of the logits, which
no sound comparison can tell from a fault. The first layer's keys and
values depend on the token alone.
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Tuple

NORM_STD = 0.1
SELF_QK = 0.7


def seed_of(seed: int, tag: str) -> int:
    """A 63-bit generator seed for ``tag`` under the run's ``seed`` (any
    whole number, however large)."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def dtype_of(model: Dict):
    import torch
    return getattr(torch, model["dtype"])


def layer_shapes(m: Dict) -> List[Tuple[str, Tuple[int, ...], float]]:
    """(name, shape, std) of one layer's matrices, in draw order."""
    d, h, kv, dh = m["d_model"], m["n_heads"], m["n_kv_heads"], m["d_head"]
    ff, e = m["d_ff"], m["n_experts"]
    return [("wq", (d, h * dh), d ** -0.5), ("wk", (d, kv * dh), d ** -0.5),
            ("wv", (d, kv * dh), d ** -0.5), ("wo", (h * dh, d),
                                              (h * dh) ** -0.5),
            ("router", (d, e), d ** -0.5), ("w_gate", (e, d, ff), d ** -0.5),
            ("w_up", (e, d, ff), d ** -0.5), ("w_down", (e, ff, d),
                                              ff ** -0.5)]


def _draw(shapes, seed: int, tag: str, device, dtype, norms: List[str],
          d: int) -> Dict:
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_of(seed, tag))
    n = sum(math.prod(s) for _, s, _ in shapes)
    flat = torch.randn(n, generator=gen, device=device, dtype=dtype)
    out, at = {}, 0
    for name, shape, std in shapes:
        k = math.prod(shape)
        out[name] = flat[at:at + k].view(shape)
        if std != 1.0:
            out[name].mul_(std)
        at += k
    scales = torch.randn((len(norms), d), generator=gen, device=device,
                         dtype=dtype).mul_(NORM_STD).add_(1.0)
    out.update(zip(norms, scales))
    return out


def layer(m: Dict, seed: int, i: int, device) -> Dict:
    """Layer ``i``'s weights (views into one buffer of the served type)."""
    w = _draw(layer_shapes(m), seed, f"layer{i}", device, dtype_of(m),
              ["attn_norm", "ffn_norm"], m["d_model"])
    if i > 0:
        return w
    d, dh = m["d_model"], m["d_head"]
    rep = m["n_heads"] // m["n_kv_heads"]
    wk = w["wk"].view(d, m["n_kv_heads"], 1, dh)
    w["wq"].view(d, m["n_kv_heads"], rep, dh).add_(wk, alpha=SELF_QK)
    return w


def outer(m: Dict, seed: int, device) -> Dict:
    """The embedding, the output head and the final norm's scale."""
    d, v = m["d_model"], m["vocab_size"]
    return _draw([("embed", (v, d), 1.0), ("unembed", (d, v), d ** -0.5)],
                 seed, "outer", device, dtype_of(m), ["final_norm"], d)


def prompts(seed: int, batch: int, length: int, vocab: int, device):
    """The prompts' token ids (batch, length), uniform over the vocabulary."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_of(seed, "prompts"))
    return torch.randint(0, vocab, (batch, length), generator=gen,
                         device=device)
