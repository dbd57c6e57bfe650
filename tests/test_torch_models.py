"""The port's LM serving path (``repro_torch.models``, ``launch.serve``,
``examples.serve_lm``, ``core.maskchar``, ``roofline.model_flops``) held
against the JAX package's on the CPU, for the attention configs at their
reduced sizes (dense: llama3.2-3b, phi3-medium-14b, phi4-mini-3.8b,
gemma2-9b; MoE: mixtral-8x22b, dbrx-132b); ``test_torch_models_families.py``
runs the same parametrised tests on the ssm, hybrid, audio and vlm configs.

The JAX parameters are carried across (``convert.params_from_jax``), so
both packages run the same weights on the same tokens: prefill and decode
logits within ``1e-4 * max|logits|`` at float32 compute (the two differ
only in summation order) and within the reference's own ``3e-2 *
max|logits|`` at the default bfloat16 compute (``test_models.py:96``:
bf16 rounds at other places in the two frameworks); the KV cache after
prefill (a windowed layer with ``cache_len > window`` among them) and after
a decode step at the same bounds; the MoE aux metrics at float32. Then the
reference's own model tests on the port, the serve CLI (the reference's
tokens at float32 compute), the multi-RHS decode example, ``maskchar`` and
``model_flops``."""
import dataclasses
import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.serve as jserve
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs import list_archs as jlist_archs
from repro.core import maskchar as jmaskchar
from repro.models import Model as JModel
from repro.models import count_active_params as jcount_active
from repro.models import count_params as jcount_params
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro.roofline.model_flops import model_bytes as jmodel_bytes
from repro.roofline.model_flops import model_flops as jmodel_flops
from repro_torch import convert
from repro_torch.configs import (SHAPES, get_config, list_archs,
                                 shape_applicable)
from repro_torch.core import maskchar
from repro_torch.launch import serve
from repro_torch.models import Model, count_active_params, count_params
from repro_torch.models import layers, moe, transformer as tfm
from repro_torch.roofline import model_bytes, model_flops
from repro_torch.sparse import launch_count
from torch_lm_parity import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
# the attention families; test_torch_models_families.py runs the
# parametrised tests below on the other four configs
ARCHS = ("llama3.2-3b", "phi3-medium-14b", "phi4-mini-3.8b", "gemma2-9b",
         "mixtral-8x22b", "dbrx-132b")
MOE_ARCHS = ("mixtral-8x22b", "dbrx-132b")
# relative to max|logits|: float32 compute differs in summation order only;
# bf16 is the reference's own decode-vs-forward bound
TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _cfgs(arch, compute="bfloat16", **kw):
    """The port's and the JAX package's reduced config of ``arch``."""
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              compute_dtype=compute, **kw)
    jcfg = dataclasses.replace(jget_config(arch, reduced=True),
                               compute_dtype=compute, **kw)
    return cfg, jcfg


def _pair(arch, compute="bfloat16", seed=1, **kw):
    """(port model, JAX model, JAX params) on the same weights."""
    cfg, jcfg = _cfgs(arch, compute, **kw)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    model = Model(cfg, device=CPU)
    model.load_state_dict(convert.params_from_jax(
        cfg, jax.tree.map(np.asarray, jp)))
    return model, jm, jp


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        1, cfg.vocab_size, (b, s)).astype(np.int32)


def _batches(cfg, toks, seed=0):
    """(port batch, JAX batch) of ``toks``, with float32 stub frames for
    encoder-decoder configs."""
    tb = {"tokens": torch.as_tensor(toks)}
    jb = {"tokens": jnp.asarray(toks)}
    if cfg.is_encdec:
        a = np.random.default_rng(seed + 100).standard_normal(
            (toks.shape[0], cfg.encoder_len, cfg.d_model)).astype(np.float32)
        tb["audio_embed"], jb["audio_embed"] = torch.as_tensor(a), \
            jnp.asarray(a)
    return tb, jb


class _JRef:
    """The reference model's prefill (attention chunk 32, ``cache_len``)
    and decode under ``jax.jit``, each compiled for the shapes of its first
    call at XLA's backend optimisation level 0: on the CPU that takes a
    third of the time of the eager calls' compiles, and the logits stay
    within 1e-6 relative of theirs."""

    def __init__(self, jm, cache_len):
        self.jm, self.cache_len = jm, cache_len
        self._prefill = self._decode = None

    @staticmethod
    def _compile(fn, *args):
        return jax.jit(fn).lower(*args).compile(
            compiler_options={"xla_backend_optimization_level": 0})

    def prefill(self, jp, batch):
        if self._prefill is None:
            self._prefill = self._compile(functools.partial(
                self.jm.prefill, attn_chunk=32, cache_len=self.cache_len),
                jp, batch)
        return self._prefill(jp, batch)

    def decode(self, jp, cache, token, pos):
        args = (jp, cache, jnp.asarray(token), jnp.asarray(pos, jnp.int32))
        if self._decode is None:
            self._decode = self._compile(self.jm.decode, *args)
        return self._decode(*args)


def _rel(a, ref):
    a = np.asarray(a, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-30))


def _jcache(jcache, cfg, layer, part="self"):
    """Layer ``layer``'s cache entry (``part`` "self" or "cross") of the
    reference's group-stacked cache."""
    pi, g = layer % cfg.pattern_len, layer // cfg.pattern_len
    return {k: np.asarray(v[g], np.float32)
            for k, v in jcache[pi][part].items()}


# ------------------------------------------------------------------ configs

def test_configs_are_the_reference_configs():
    assert list_archs() == jlist_archs() and len(list_archs()) == 10
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JSHAPES.items()}
    for arch in list_archs():
        for reduced in (False, True):
            cfg = get_config(arch, reduced=reduced)
            jcfg = jget_config(arch, reduced=reduced)
            assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
            assert cfg.vocab_padded == jcfg.vocab_padded
            for shape in SHAPES.values():
                assert shape_applicable(cfg, shape) == \
                    shape_applicable(jcfg, JSHAPES[shape.name])


def test_shape_applicability_rules():
    long = SHAPES["long_500k"]
    for arch in ("mamba2-780m", "recurrentgemma-9b", "mixtral-8x22b",
                 "gemma2-9b"):
        assert shape_applicable(get_config(arch), long), arch
    for arch in ("llama3.2-3b", "phi3-medium-14b", "phi4-mini-3.8b",
                 "qwen2-vl-72b", "dbrx-132b", "whisper-large-v3"):
        assert not shape_applicable(get_config(arch), long), arch


def test_model_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this checks the no-card refusal")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(get_config("llama3.2-3b", reduced=True))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "llama3.2-3b", "--reduced", "--requests",
                    "1"])


# ------------------------------------------------------------------ layers

def test_layers_like_jax():
    """The shared layers on the same float32 inputs: both norms, the
    softcap, RoPE and M-RoPE, sinusoidal positions, the gated RMSNorm, the
    causal depthwise conv with its decode tail, and the three FFNs."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 12, 4, 16)).astype(np.float32)
    pos = np.arange(12)
    close = dict(rtol=1e-5, atol=1e-5)

    def t(a):
        return torch.as_tensor(a)

    np.testing.assert_allclose(
        layers.rope(t(x), t(pos), 500_000.0).numpy(),
        jlayers.rope(jnp.asarray(x), jnp.asarray(pos), 500_000.0), **close)
    pos3 = np.stack([pos, pos + 1, 2 * pos])
    np.testing.assert_allclose(
        layers.mrope(t(x), t(pos3), 1e6, (4, 2, 2)).numpy(),
        jlayers.mrope(jnp.asarray(x), jnp.asarray(pos3), 1e6, (4, 2, 2)),
        **close)
    np.testing.assert_allclose(
        layers.sinusoidal_positions(t(pos), 16).numpy(),
        jlayers.sinusoidal_positions(jnp.asarray(pos), 16), **close)
    h = x.reshape(2, 12, 64)
    z = rng.standard_normal(h.shape).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    np.testing.assert_allclose(
        layers.gated_rmsnorm(t(scale), t(h), t(z)).numpy(),
        jlayers.gated_rmsnorm(jnp.asarray(scale), jnp.asarray(h),
                              jnp.asarray(z)), **close)
    np.testing.assert_allclose(layers.softcap(t(h), 5.0).numpy(),
                               jlayers.softcap(jnp.asarray(h), 5.0), **close)
    w = rng.standard_normal((4, 64)).astype(np.float32)
    tail = rng.standard_normal((2, 3, 64)).astype(np.float32)
    for tl in (None, tail):
        y, nt = layers.causal_depthwise_conv1d(
            t(h), t(w), None if tl is None else t(tl))
        jy, jnt = jlayers.causal_depthwise_conv1d(
            jnp.asarray(h), jnp.asarray(w),
            None if tl is None else jnp.asarray(tl))
        np.testing.assert_allclose(y.numpy(), jy, **close)
        np.testing.assert_allclose(nt.numpy(), jnt, **close)
    for norm in ("rmsnorm", "layernorm"):
        for act in ("swiglu", "geglu", "gelu"):
            cfg, jcfg = _cfgs("llama3.2-3b", "float32", norm=norm, act=act)
            p = layers.Norm(cfg, 64, CPU)
            with torch.no_grad():
                p.scale.copy_(t(scale))
            jp = {"scale": jnp.asarray(scale)}
            if norm == "layernorm":
                bias = rng.standard_normal(64).astype(np.float32)
                with torch.no_grad():
                    p.bias.copy_(t(bias))
                jp["bias"] = jnp.asarray(bias)
            np.testing.assert_allclose(
                layers.apply_norm(cfg, p, t(h)).detach().numpy(),
                jlayers.apply_norm(jcfg, jp, jnp.asarray(h)), **close)
            ffn = layers.init_ffn(cfg, CPU)
            jffn = {}
            for name, par in ffn.named_parameters():
                v = rng.standard_normal(par.shape).astype(np.float32) / 8
                with torch.no_grad():
                    par.copy_(t(v))
                jffn[name] = jnp.asarray(v)
            with torch.no_grad():
                got = layers.apply_ffn(cfg, ffn, t(h)).numpy()
            np.testing.assert_allclose(
                got, jlayers.apply_ffn(jcfg, jffn, jnp.asarray(h)),
                rtol=1e-4, atol=1e-4)


# -------------------------------------------------- the reference's numbers

def _bf16_floor(arch, run):
    """The reference's own bfloat16 error: ``run(jax model, params)``'s
    outputs at bfloat16 against float32 compute, largest relative error
    over them (same weights, same inputs)."""
    outs = {}
    for compute in ("float32", "bfloat16"):
        _, jcfg = _cfgs(arch, compute)
        jm = JModel(jcfg)
        outs[compute] = run(jm, jm.init(jax.random.PRNGKey(1)))
    return max(_rel(a, b) for a, b in zip(outs["bfloat16"],
                                          outs["float32"]))


def _bound(arch, compute, run):
    """``TOL[compute]``; for recurrentgemma at bfloat16, twice the
    reference's own bfloat16 error where that is larger (its RG-LRU layers
    round more: the reference's bf16 decode logits sit 4e-2 from its
    float32 ones)."""
    if compute == "float32" or arch != "recurrentgemma-9b":
        return TOL[compute]
    return max(TOL[compute], 2 * _bf16_floor(arch, run))


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_jax(arch, compute):
    model, jm, jp = _pair(arch, compute)
    cfg = model.cfg
    b, s = 2, 64
    toks = _tokens(cfg, b, s)
    tb, jb = _batches(cfg, toks)

    def jrun(jm, jp):
        ref = _JRef(jm, s + 4)
        jl, jc = ref.prefill(jp, jb)
        out = [jl]
        for step, t in enumerate(nxts):
            jl, jc = ref.decode(jp, jc, t, s + step)
            out.append(jl)
        return out

    # the tokens decoded: the reference's greedy picks at this compute
    ref = _JRef(jm, s + 4)
    jl, jc = ref.prefill(jp, jb)
    want, nxts = [jl], []
    for step in range(2):
        nxts.append(np.argmax(np.asarray(jl), -1).astype(np.int32))
        jl, jc = ref.decode(jp, jc, nxts[-1], s + step)
        want.append(jl)
    bound = _bound(arch, compute, jrun)
    lg, cache = model.prefill(tb, attn_chunk=32, cache_len=s + 4)
    assert lg.shape == (b, cfg.vocab_padded) and lg.dtype == torch.float32
    got = [lg]
    for step, t in enumerate(nxts):
        lg, cache = model.decode(cache, torch.as_tensor(t), s + step)
        got.append(lg)
    for step, (lg, jl) in enumerate(zip(got, want)):
        assert _rel(lg, jl) < bound, (step, _rel(lg, jl), bound)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_kv_cache_matches_jax(arch, compute):
    """The cache after prefill and after one decode step, layer by layer:
    gemma2's local layers and mixtral's sliding-window layers (window 32)
    hold a rolling buffer of the last 32 positions of a 64-token prompt
    (``cache_len`` 68 > window), the full-attention layers 64 positions
    zero-padded to 68; the SSD and RG-LRU layers their float32 state and
    conv tail; whisper's decoder layers also the encoder's cross K/V
    (padded to 512 frames)."""
    model, jm, jp = _pair(arch, compute)
    cfg = model.cfg
    toks = _tokens(cfg, 2, 64, seed=3)
    tb, jb = _batches(cfg, toks, seed=3)
    ref = _JRef(jm, 68)
    _, jc = ref.prefill(jp, jb)
    _, cache = model.prefill(tb, attn_chunk=32, cache_len=68)
    windowed = [i for i in range(cfg.n_layers)
                if cfg.layer_pattern[i % cfg.pattern_len] != "attn"]
    if arch in ("gemma2-9b", "mixtral-8x22b"):
        assert windowed and all(cache[i]["self"]["k"].shape[1] == cfg.window
                                < 68 for i in windowed)
    parts = ("self", "cross") if cfg.cross_attention else ("self",)
    for when in ("prefill", "decode"):
        for i in range(cfg.n_layers):
            for part in parts:
                want = _jcache(jc, cfg, i, part)
                assert sorted(cache[i][part]) == sorted(want)
                for k, got in cache[i][part].items():
                    # recurrent states are float32, the rest compute dtype
                    assert got.dtype == (torch.float32 if k == "h" else
                                         getattr(torch, compute))
                    assert tuple(got.shape) == want[k].shape
                    assert _rel(got.float(), want[k]) < TOL[compute], \
                        (when, i, part, k)
        tok = np.full((2,), 7, np.int32)
        _, jc = ref.decode(jp, jc, tok, 64)
        _, cache = model.decode(cache, torch.as_tensor(tok), 64)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_layer_and_aux_metrics_match_jax(arch):
    """At float32 compute: one MoE layer's output and aux metrics on the
    same input, and the stack's summed metrics in train mode, with
    capacity drops (a capacity factor of 0.5 drops tokens)."""
    for cap in (None, 0.5):
        kw = {} if cap is None else {"capacity_factor": cap}
        model, jm, jp = _pair(arch, "float32", **kw)
        cfg = model.cfg
        x = np.random.default_rng(5).standard_normal(
            (2, 48, cfg.d_model)).astype(np.float32)
        ffn = jax.tree.map(lambda t: t[0], jp["blocks"][0]["ffn"])
        jy, jaux = jmoe.apply_moe(jm.cfg, ffn, jnp.asarray(x))
        with torch.no_grad():
            y, aux = moe.apply_moe(cfg, model.blocks[0].ffn,
                                   torch.as_tensor(x))
        assert _rel(y, jy) < 1e-5
        for k in tfm.MOE_AUX_KEYS:
            np.testing.assert_allclose(float(aux[k]), float(jaux[k]),
                                       rtol=1e-5, atol=1e-7)
        if cap is not None:
            assert float(aux["dropped_fraction"]) > 0
        toks = _tokens(cfg, 2, 32, seed=9)
        jx = jtfm.embed_tokens(jm.cfg, jp, jnp.asarray(toks))
        _, _, jtot = jtfm.apply_stack(jm.cfg, jp["blocks"], jx, mode="train",
                                      attn_chunk=32)
        with torch.no_grad():
            tx = tfm.embed_tokens(cfg, model, torch.as_tensor(toks))
            _, _, tot = tfm.apply_stack(cfg, model.blocks, tx, mode="train",
                                        attn_chunk=32)
        for k in tfm.MOE_AUX_KEYS:
            np.testing.assert_allclose(float(tot[k]), float(jtot[k]),
                                       rtol=1e-5, atol=1e-7)


def test_top_k_breaks_ties_toward_the_lower_index():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4]])
    vals, idx = moe.top_k_lower_index(probs, 2)
    jvals, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


def test_generate_matches_jax_at_float32():
    model, jm, jp = _pair("llama3.2-3b", "float32", seed=2)
    prompt = _tokens(model.cfg, 2, 16, seed=4)
    want = np.asarray(jm.generate(jp, jnp.asarray(prompt), steps=6))
    got = model.generate(torch.as_tensor(prompt), steps=6)
    np.testing.assert_array_equal(got.numpy(), want)


def test_temperature_sampling_draws_from_the_generator():
    """Temperature sampling: the same generator seed gives the same tokens,
    every token a valid id; without a generator it is greedy."""
    model = Model(get_config("llama3.2-3b", reduced=True),
                  device=CPU).init(seed=5)
    prompt = torch.as_tensor(_tokens(model.cfg, 2, 8))
    draws = [model.generate(prompt, steps=5, temperature=1.0,
                            generator=torch.Generator().manual_seed(7))
             for _ in range(2)]
    assert torch.equal(draws[0], draws[1]) and draws[0].shape == (2, 5)
    assert int(draws[0].min()) >= 0
    assert int(draws[0].max()) < model.cfg.vocab_padded
    assert torch.equal(model.generate(prompt, steps=5, temperature=1.0),
                       model.generate(prompt, steps=5))


# ----------------------------------------- the reference's model tests

@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_prefill_decode_shapes(arch):
    cfg = get_config(arch, reduced=True)
    model = Model(cfg, device=CPU).init(seed=0)
    b, s = 2, 64
    tb, _ = _batches(cfg, _tokens(cfg, b, s))
    logits, cache = model.prefill(tb, attn_chunk=32, cache_len=s + 4)
    assert logits.shape == (b, cfg.vocab_padded)
    assert torch.isfinite(logits).all()
    lg, cache2 = model.decode(cache, torch.ones(b, dtype=torch.int64), s)
    assert lg.shape == (b, cfg.vocab_padded) and torch.isfinite(lg).all()
    assert len(cache2) == cfg.n_layers
    # the decode step writes attention K/V into the prefill cache's
    # tensors in place
    assert all(c2["self"]["k"] is c["self"]["k"]
               for c, c2 in zip(cache, cache2) if "k" in c["self"])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_full_forward(arch):
    """The reference's property on the port: the decode step's logits at
    position s-1 match a full forward over the tokens at bf16 compute, the
    prefill cache holding positions 0..s-2 (MoE capacity lifted, as
    there, so drops do not differ between the two lengths)."""
    cfg = get_config(arch, reduced=True)
    if cfg.is_moe:
        cfg = dataclasses.replace(cfg, capacity_factor=16.0)
    model = Model(cfg, device=CPU).init(seed=1)
    b, s = 2, 65
    toks = torch.as_tensor(_tokens(cfg, b, s, seed=6))
    full = torch.cat([toks, toks[:, :31]], dim=1)
    batch, _ = _batches(cfg, toks[:, :s - 1].numpy(), seed=6)
    _, cache = model.prefill(batch, attn_chunk=32, cache_len=s)
    lg_d, _ = model.decode(cache, toks[:, s - 1], s - 1)
    with torch.no_grad():
        x = tfm.embed_tokens(cfg, model, full)
        enc, valid = tfm._cross(cfg, model, batch, 32)
        h, _, _ = tfm.apply_stack(cfg, model.blocks, x, mode="train",
                                  cross_enc=enc, enc_valid=valid,
                                  attn_chunk=32)
        h = tfm.apply_norm(cfg, model.final_norm, h)
        lg_ref = tfm.logits_at(cfg, model, h[:, s - 1:s])[:, 0]
    assert _rel(lg_d, lg_ref) < 3e-2, _rel(lg_d, lg_ref)


def test_param_counts_in_expected_range():
    """Full-config parameter counts equal the reference's and sit in the
    advertised ballpark (``meta`` tensors: no memory)."""
    expect = {"llama3.2-3b": (2.5e9, 4.5e9), "phi3-medium-14b": (12e9, 16e9),
              "mixtral-8x22b": (120e9, 150e9), "dbrx-132b": (110e9, 145e9),
              "qwen2-vl-72b": (62e9, 80e9), "gemma2-9b": (8e9, 11.5e9),
              "mamba2-780m": (0.6e9, 1.0e9), "phi4-mini-3.8b": (3e9, 5e9),
              "recurrentgemma-9b": (7.5e9, 11e9),
              "whisper-large-v3": (1.2e9, 2.1e9)}
    for arch, (lo, hi) in expect.items():
        n = count_params(Model(get_config(arch), device="meta"))
        assert lo <= n <= hi, (arch, n)
        assert n == jcount_params(JModel(jget_config(arch))
                                  .abstract_params())


def test_moe_active_params_fraction():
    cfg = get_config("mixtral-8x22b")
    p = Model(cfg, device="meta")
    total, active = count_params(p), count_active_params(cfg, p)
    assert active < 0.55 * total
    jp = JModel(jget_config("mixtral-8x22b")).abstract_params()
    assert (total, active) == (jcount_params(jp),
                               jcount_active(jget_config("mixtral-8x22b"),
                                             jp))


def test_moe_imbalance_is_eq5():
    """The MoE layer's expert_imbalance is Eq. 5 over tokens-per-expert:
    against the closed form on the routing it made, and on synthetic
    counts."""
    cfg = get_config("mixtral-8x22b", reduced=True)
    model = Model(cfg, device=CPU).init(seed=0)
    toks = torch.as_tensor(_tokens(cfg, 1, 64))
    with torch.no_grad():
        x = tfm.embed_tokens(cfg, model, toks)
        h = tfm.apply_norm(cfg, model.blocks[0].norm2, x)
        _, aux = moe.apply_moe(cfg, model.blocks[0].ffn, h)
        logits = h.float() @ model.blocks[0].ffn.router.to(h.dtype).float()
    _, idx = moe.top_k_lower_index(torch.softmax(logits, -1), cfg.top_k)
    counts = np.bincount(idx.numpy().ravel(), minlength=cfg.n_experts)
    ideal = counts.sum() / counts.size
    imb = float(aux["expert_imbalance"])
    assert np.isfinite(imb) and imb >= 0.0
    assert imb == pytest.approx(np.mean(np.abs(counts - ideal) / ideal),
                                rel=1e-6)
    counts = np.array([10.0, 2.0, 2.0, 2.0])
    ideal = counts.sum() / counts.size
    assert np.mean(np.abs(counts - ideal) / ideal) == pytest.approx(0.75)


# ------------------------------------------------------------ serving

def test_serving_generates_tokens():
    """``test_system.py``'s serving test on the port."""
    res = serve.main(["--arch", "gemma2-9b", "--reduced", "--requests", "4",
                      "--batch", "2", "--prompt-len", "32", "--gen-len", "8",
                      "--attn-chunk", "32", "--device", CPU])
    assert res["throughput_tok_s"] > 0
    outs = np.concatenate(res["outputs"])
    assert outs.shape == (4, 8) and (outs >= 0).all()
    assert res["prefill_ms"] > 0 and res["decode_ms_per_token"] > 0
    assert res["last_logits"].shape == (2, get_config(
        "gemma2-9b", reduced=True).vocab_padded)


@pytest.mark.parametrize("arch", ["gemma2-9b", "mixtral-8x22b"])
def test_serve_cli_gives_the_reference_tokens_at_float32(arch, monkeypatch):
    """Both serve CLIs on the same weights (the reference's draw from
    ``PRNGKey(0)``, carried across) at float32 compute: the same prompts
    (and, for whisper, the same bfloat16 stub frames, drawn after them from
    the same stream) and the same greedy tokens."""
    cfg, jcfg = _cfgs(arch, "float32")
    monkeypatch.setattr(jserve, "get_config", lambda *a, **k: jcfg)
    argv = ["--arch", arch, "--reduced", "--requests", "4", "--batch", "2",
            "--prompt-len", "32", "--gen-len", "8", "--attn-chunk", "32"]
    want = jserve.main(argv)
    jp = JModel(jcfg).init(jax.random.PRNGKey(0))
    model = Model(cfg, device=CPU)
    model.load_state_dict(convert.params_from_jax(
        cfg, jax.tree.map(np.asarray, jp)))
    got = serve.main(argv + ["--device", CPU], model=model)
    assert len(got["outputs"]) == len(want["outputs"]) == 2
    for a, b in zip(got["outputs"], want["outputs"]):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.fixture(scope="module")
def jserve_lm():
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        import serve_lm
    finally:
        sys.path.remove(str(ROOT / "examples"))
    return serve_lm


def test_decode_multirhs_ticks_like_jax(jserve_lm):
    from repro_torch.examples.serve_lm import decode_multirhs_ticks
    want = jserve_lm.decode_multirhs_ticks(3, n=256)
    l0 = (launch_count("spmv"), launch_count("spmm"))
    got = decode_multirhs_ticks(3, n=256, device=CPU)
    for key in ("ticks", "batch", "spmv_launches", "spmm_launches"):
        assert got[key] == want[key], key
    assert (got["spmv_launches"], got["spmm_launches"]) == (12, 3)
    assert (launch_count("spmv") - l0[0], launch_count("spmm") - l0[1]) == \
        (12, 3)


# ------------------------------------------------- maskchar, model flops

def test_maskchar_like_jax():
    for kind, w in (("local_attn", 512), ("attn", 0), ("bidirectional", 0)):
        m = maskchar.mask_csr(kind, 2048, window=w)
        jm = jmaskchar.mask_csr(kind, 2048, window=w)
        for f in ("row_ptrs", "col_idxs", "nnz_vals"):
            np.testing.assert_array_equal(getattr(m, f), getattr(jm, f))
    for arch, seq in (("gemma2-9b", 32768), ("mixtral-8x22b", 524_288)):
        got = maskchar.characterize_attention(get_config(arch), seq)
        want = jmaskchar.characterize_attention(jget_config(arch), seq)
        assert got == want
    out = maskchar.characterize_attention(get_config("gemma2-9b"), 32768)
    assert out["local_attn"]["fraction_of_causal"] < 0.3


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_and_bytes_like_jax(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    p = Model(cfg, device="meta")
    jp = JModel(jcfg).abstract_params()
    for name, shape in SHAPES.items():
        if not shape_applicable(cfg, shape):
            continue
        assert model_flops(cfg, shape, p) == jmodel_flops(
            jcfg, JSHAPES[name], jp)
        assert model_bytes(cfg, shape, p) == jmodel_bytes(
            jcfg, JSHAPES[name], jp)
