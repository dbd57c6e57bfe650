"""The port's LM serving path for the ssm, hybrid, audio and vlm configs
at their reduced sizes (mamba2-780m; recurrentgemma-9b; whisper-large-v3,
with stub frames; qwen2-vl-72b, M-RoPE) held against the JAX package's on
the CPU: the parametrised tests of ``test_torch_models.py`` run on these
configs (its bodies and tolerances; a file of its own so that the two run
side by side), then the tests of these families' own parts: the
Hillis-Steele scan, SSD's chunked form against its decode recurrence, and
whisper's ``generate`` with frames."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_models as base
from test_torch_models import CPU, _cfgs, _pair, _rel, _tokens
from torch_lm_parity import one_torch_thread  # noqa: F401 (autouse)

FAMILY_ARCHS = ("mamba2-780m", "recurrentgemma-9b", "whisper-large-v3",
                "qwen2-vl-72b")


def test_the_two_files_cover_every_config():
    from repro_torch.configs import list_archs
    assert sorted(base.ARCHS + FAMILY_ARCHS) == sorted(list_archs())


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_prefill_and_decode_logits_match_jax(arch, compute):
    base.test_prefill_and_decode_logits_match_jax(arch, compute)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_kv_cache_matches_jax(arch, compute):
    base.test_kv_cache_matches_jax(arch, compute)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_smoke_prefill_decode_shapes(arch):
    base.test_smoke_prefill_decode_shapes(arch)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_decode_matches_full_forward(arch):
    base.test_decode_matches_full_forward(arch)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_serve_cli_gives_the_reference_tokens_at_float32(arch, monkeypatch):
    base.test_serve_cli_gives_the_reference_tokens_at_float32(arch,
                                                              monkeypatch)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_model_flops_and_bytes_like_jax(arch):
    base.test_model_flops_and_bytes_like_jax(arch)


# ------------------------------------------- the recurrent and audio parts

def test_linear_scan_matches_the_sequential_recurrence():
    """The Hillis-Steele scan (ceil(log2 S) passes) against the loop
    h_t = a_t h_{t-1} + b_t, over lengths that are and are not powers of
    two, and ``_rglru_core`` against the reference's
    ``associative_scan`` with and without an initial state."""
    from repro.models import rglru as jrglru
    from repro_torch.models import rglru
    rng = np.random.default_rng(11)
    for s in (1, 2, 7, 64, 100):
        a = torch.as_tensor(rng.uniform(0.2, 1.0, (2, s, 5)))
        b = torch.as_tensor(rng.standard_normal((2, s, 5)))
        prod, h = rglru.linear_scan(a, b)
        want, acc = [], torch.zeros(2, 5, dtype=torch.float64)
        for t in range(s):
            acc = a[:, t] * acc + b[:, t]
            want.append(acc)
        torch.testing.assert_close(h, torch.stack(want, 1), rtol=1e-12,
                                   atol=1e-12)
        torch.testing.assert_close(prod, torch.cumprod(a, 1), rtol=1e-12,
                                   atol=1e-12)
    cfg, jcfg = _cfgs("recurrentgemma-9b", "float32")
    model, jm, jp = _pair("recurrentgemma-9b", "float32")
    x = rng.standard_normal((2, 37, 64)).astype(np.float32)
    h0 = rng.standard_normal((2, 64)).astype(np.float32)
    mix = jax.tree.map(lambda t: t[0], jp["blocks"][0]["mixer"])
    for init in (None, h0):
        jy, jh = jrglru._rglru_core(
            mix, jnp.asarray(x), None if init is None else jnp.asarray(init))
        with torch.no_grad():
            y, h = rglru._rglru_core(
                model.blocks[0].mixer, torch.as_tensor(x),
                None if init is None else torch.as_tensor(init))
        assert _rel(y, jy) < 1e-5 and _rel(h, jh) < 1e-5


def test_ssd_chunked_matches_its_decode_recurrence():
    """SSD's chunked train/prefill form against S steps of its decode
    recurrence from the zero cache: the same outputs and final state (and
    the conv tail) at float32."""
    from repro_torch.models import ssm
    model, _, _ = _pair("mamba2-780m", "float32")
    cfg = model.cfg
    p = model.blocks[0].mixer
    u = torch.as_tensor(np.random.default_rng(12).standard_normal(
        (2, 64, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        c0 = ssm.init_ssd_cache(cfg, 2, torch.float32, CPU)
        y, c = ssm.apply_ssd(cfg, p, u, cache=c0)
        cache, ys = ssm.init_ssd_cache(cfg, 2, torch.float32, CPU), []
        for t in range(64):
            yt, cache = ssm.apply_ssd(cfg, p, u[:, t:t + 1], cache=cache)
            ys.append(yt)
    assert _rel(torch.cat(ys, 1), y) < 1e-4
    assert _rel(cache["h"], c["h"]) < 1e-4
    assert torch.equal(cache["conv"], c["conv"])


def test_generate_with_audio_matches_jax_at_float32():
    """whisper's greedy ``generate`` with stub frames: the encoder, the
    cross-attention cache and its decode, and the sinusoidal positions of
    each decoded token give the reference's tokens."""
    model, jm, jp = _pair("whisper-large-v3", "float32", seed=2)
    cfg = model.cfg
    prompt = _tokens(cfg, 2, 16, seed=4)
    audio = np.random.default_rng(5).standard_normal(
        (2, cfg.encoder_len, cfg.d_model)).astype(np.float32)
    want = np.asarray(jm.generate(jp, jnp.asarray(prompt), steps=6,
                                  audio_embed=jnp.asarray(audio)))
    got = model.generate(torch.as_tensor(prompt), steps=6,
                         audio_embed=torch.as_tensor(audio))
    np.testing.assert_array_equal(got.numpy(), want)
