"""Helpers of the port's LM tests (``test_torch_train*.py``,
``test_torch_models*.py``; not a test module): the ``one_torch_thread``
fixture, the reduced configs of both packages, the port's model on the
reference's weights, seeded batches, the reference's loss and gradients,
and the loss-and-gradient parity check that the
``test_torch_train_grads*.py`` files run for every config, split between
them so that each file takes about a minute and a half on one core.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import Model as JModel
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import Model

CPU = "cpu"
# the configs of the two parity files: the attention families (dense and
# MoE), and the ssm, hybrid, audio and vlm families
ATTENTION_ARCHS = ("llama3.2-3b", "phi3-medium-14b", "phi4-mini-3.8b",
                   "gemma2-9b", "mixtral-8x22b", "dbrx-132b")
FAMILY_ARCHS = ("mamba2-780m", "recurrentgemma-9b", "whisper-large-v3",
                "qwen2-vl-72b")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run the importing module's tests on one intra-op thread, then
    restore the count. The reduced models' tensors are small, and a thread
    per core in each of several test processes makes them contend: the
    five LM test files, one process each on 8 cores, took 246 s with the
    default thread count and 79 s with one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfgs(arch, compute, **kw):
    return (dataclasses.replace(get_config(arch, reduced=True),
                                compute_dtype=compute, **kw),
            dataclasses.replace(jget_config(arch, reduced=True),
                                compute_dtype=compute, **kw))


def pair(arch, compute, seed=1, **kw):
    """(port model, JAX model, JAX params) on the same weights."""
    cfg, jcfg = cfgs(arch, compute, **kw)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    model = Model(cfg, device=CPU)
    model.load_state_dict(convert.params_from_jax(
        cfg, jax.tree.map(np.asarray, jp)))
    return model, jm, jp


def lm_batch(cfg, b=2, s=64, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(1, cfg.vocab_size, (b, s)).astype(
        np.int32)}
    if cfg.is_encdec:
        batch["audio_embed"] = rng.standard_normal(
            (b, cfg.encoder_len, cfg.d_model)).astype(np.float32)
    return batch


def compiled(fn, *args):
    """``jax.jit(fn)`` compiled for ``args`` at XLA's backend optimisation
    level 0: on the CPU it compiles in about half the default level's
    time, and the reference's gradients move by about 1e-6 relative."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})


def leaf_err(got, want):
    """Largest per-leaf error relative to the leaf's max |want|."""
    return max(float((torch.as_tensor(got[n]).float()
                      - torch.as_tensor(want[n]).float()).abs().max())
               / max(float(torch.as_tensor(want[n]).abs().max()), 1e-30)
               for n in want)



@functools.lru_cache(maxsize=None)
def jax_grads(arch, compute):
    """(loss, metrics, grads by port name) of ``jax.value_and_grad`` of the
    reference's loss on its seed-1 weights and ``lm_batch``."""
    _, jcfg = cfgs(arch, compute)
    cfg = get_config(arch, reduced=True)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(1))
    batch = {k: jnp.asarray(v) for k, v in lm_batch(cfg).items()}
    grad_fn = jax.value_and_grad(
        lambda p: jm.loss(p, batch, remat="none", attn_chunk=32),
        has_aux=True)
    (loss, metrics), g = compiled(grad_fn, jp)(jp)
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            convert.params_from_jax(cfg, jax.tree.map(np.asarray, g)))


def port_grads(model, batch, remat="none"):
    model.zero_grad(set_to_none=True)
    loss, metrics = model.loss(batch, remat=remat, attn_chunk=32)
    loss.backward()
    return (float(loss.detach()), {k: float(v) for k, v in metrics.items()},
            {n: p.grad.clone() for n, p in model.named_parameters()})


def check_loss_and_grads(arch, compute):
    """``Model.loss`` and its gradients (autograd) against
    ``jax.value_and_grad(JModel.loss)`` on the same weights and batch.

    float32 compute: loss within 1e-5 relative, each gradient within
    ``1e-4 * max|grad|`` of its leaf. bfloat16: the loss within 1e-2
    relative; each gradient within ``3e-2 * max|grad|`` of its leaf, or
    twice the reference's own bf16 error (its bf16 gradients against its
    float32 ones, largest over the leaves) where that is larger: bf16
    rounds at other places in the two frameworks, and the gradients of the
    norm scales, SSD's 8-entry ``d_skip`` and the RG-LRU gates already sit
    3-5e-2 from float32 in the reference. The MoE configs' gradients are
    held at float32 only: at bf16 a top-2 choice within a rounding of a
    tie flips between the two frameworks (mixtral's second layer, token 41
    of batch row 0: probabilities 0.2557 / 0.2570 against 0.2565 / 0.2561),
    which moves that token's whole expert rows; their loss and aux
    metrics are held at bf16 too."""
    model, _, _ = pair(arch, compute)
    cfg = model.cfg
    jloss, jmet, jg = jax_grads(arch, compute)
    loss, met, g = port_grads(model, lm_batch(cfg))
    assert sorted(g) == sorted(jg)
    assert set(met) == set(jmet)
    if compute == "float32":
        assert loss == pytest.approx(jloss, rel=1e-5)
        for k in met:
            assert met[k] == pytest.approx(jmet[k], rel=1e-5, abs=1e-7)
        for n in jg:
            err = float((g[n] - jg[n]).abs().max())
            assert err <= 1e-4 * float(jg[n].abs().max()), (n, err)
        return
    assert loss == pytest.approx(jloss, rel=1e-2)
    for k in met:
        assert met[k] == pytest.approx(jmet[k], rel=1e-2, abs=1e-2)
    if cfg.is_moe:
        return
    floor = leaf_err(jg, jax_grads(arch, "float32")[2])
    assert leaf_err(g, jg) < max(3e-2, 2 * floor), (leaf_err(g, jg),
                                                      floor)
