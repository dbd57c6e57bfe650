"""The port's LM training path (``repro_torch.optim``, ``data``,
``train.{train_step,checkpoint,fault_tolerance}``, ``launch.train``,
``examples.train_lm``) held against the JAX package's on the CPU.

First the reference's own tests of the optimizer, the data pipeline, the
checkpoint manager and the fault-tolerance mechanisms, run on the port;
then parity on the same inputs: batches bit for bit, AdamW fed the same
gradients and state as the reference's ``AdamW.update`` (1e-6 relative),
every remat policy against none, microbatching, and the
train driver's first losses against a loop built from the reference's
parts without the mesh (the reference's own driver fails on this JAX in
its mesh code, ROADMAP "Recent"). Then the reference's two failing system
tests' properties on the port alone, and replay exactness after a
restore. ``Model.loss`` and its gradients against ``jax.value_and_grad``
of the reference's loss for all ten reduced configs are in
``test_torch_train_grads.py`` and ``test_torch_train_grads_families.py``.
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import SyntheticLMDataset as JDataset
from repro.models import Model as JModel
from repro.models import ssm as jssm
from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp
from repro.optim import schedules as jsched
from repro.train import fault_tolerance as jft
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.data import DataIterator, SyntheticLMDataset
from repro_torch.launch import train
from repro_torch.models import Model, count_params, ssm
from repro_torch.models.transformer import REMAT_POLICIES
from repro_torch.optim import (AdamW, OptState, apply_updates,
                               compress_tree, cosine_schedule, init_error,
                               linear_warmup_cosine)
from repro_torch.train import CheckpointManager, make_train_step
from repro_torch.train.checkpoint import load_train_state, train_state_tree
from repro_torch.train.fault_tolerance import (ElasticPlan, HeartbeatMonitor,
                                               StragglerDetector,
                                               plan_elastic_restart,
                                               run_with_restarts)
from torch_lm_parity import one_torch_thread  # noqa: F401 (autouse)
from torch_lm_parity import (CPU, cfgs, compiled, leaf_err, lm_batch, pair,
                             port_grads)

# ------------------------------------------- the reference's optim tests

def test_adamw_minimizes_quadratic():
    w = torch.nn.Parameter(torch.tensor([5.0, -3.0]))
    opt = AdamW([w], learning_rate=0.1, weight_decay=0.0,
                grad_clip_norm=None)
    for _ in range(200):
        opt.zero_grad()
        (w ** 2).sum().backward()
        opt.step()
    assert float((w ** 2).sum()) < 1e-3


def test_grad_clip_reported_norm():
    w = torch.nn.Parameter(torch.ones(3))
    opt = AdamW([w], learning_rate=0.0, grad_clip_norm=1.0)
    w.grad = torch.full((3,), 10.0)
    opt.step()
    assert float(opt.last_grad_norm) == pytest.approx(np.sqrt(300.0),
                                                      rel=1e-5)


def test_weight_decay_masked_for_vectors():
    """1-D params (norm scales) are not decayed, unless marked ``stacked``
    (a block parameter, 2-D in the reference's group-stacked tree)."""
    mat = torch.nn.Parameter(torch.ones(2, 2))
    vec = torch.nn.Parameter(torch.ones(2))
    blk = torch.nn.Parameter(torch.ones(2))
    blk.stacked = True
    opt = AdamW([mat, vec, blk], learning_rate=1.0, weight_decay=0.5,
                grad_clip_norm=None)
    mat.grad, vec.grad, blk.grad = (torch.zeros(2, 2), torch.zeros(2),
                                    torch.zeros(2))
    opt.step()
    assert float((mat - 1).abs().max()) > 0      # decay applied
    assert float((vec - 1).abs().max()) == 0     # no decay, zero grad
    assert float((blk - 1).abs().max()) > 0      # stacked: decayed


def test_block_params_are_stacked():
    """Every block and encoder parameter is marked ``stacked``; the
    top-level ones (embeddings, final norms) are not."""
    model = Model(get_config("whisper-large-v3", reduced=True), device=CPU)
    for name, t in model.named_parameters():
        assert getattr(t, "stacked", False) == name.startswith(
            ("blocks.", "encoder.")), name


def test_schedules():
    sched = linear_warmup_cosine(1.0, 10, 100)
    assert sched(0) == pytest.approx(0.0)
    assert sched(10) == pytest.approx(1.0)
    assert sched(100) < 0.2
    cos = cosine_schedule(2.0, 100, final_frac=0.5)
    assert cos(0) == pytest.approx(2.0)
    assert cos(100) == pytest.approx(1.0)


def test_schedules_equal_the_reference():
    for warm, total in ((10, 100), (0, 7), (5, 5), (3, 40)):
        mine = linear_warmup_cosine(3e-3, warm, total)
        ref = jsched.linear_warmup_cosine(3e-3, warm, total)
        for step in range(0, total + 3):
            assert mine(step) == pytest.approx(
                float(ref(jnp.asarray(step))), rel=1e-6, abs=1e-12)


def test_compression_error_feedback():
    """bf16 compression with error feedback: the accumulated compressed
    sum tracks the true sum at least as well as without feedback."""
    rng = np.random.default_rng(0)
    grads = [{"w": torch.as_tensor(rng.standard_normal(64) * 1e-3)}
             for _ in range(50)]
    err = init_error(grads[0])
    acc_fb, acc_nofb, true = np.zeros(64), np.zeros(64), np.zeros(64)
    for g in grads:
        true += g["w"].numpy()
        c, err = compress_tree(g, err, mode="bf16")
        acc_fb += c["w"].numpy()
        c2, _ = compress_tree(g, init_error(g), mode="bf16")
        acc_nofb += c2["w"].numpy()
    assert np.abs(acc_fb - true).max() <= np.abs(acc_nofb - true).max() \
        + 1e-9


def test_int8_compression_scale():
    g = {"w": torch.tensor([1.0, -0.5, 0.25])}
    c, _ = compress_tree(g, init_error(g), mode="int8")
    np.testing.assert_allclose(c["w"].numpy(), [1.0, -0.5, 0.25],
                               atol=1.0 / 127)


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_compress_tree_equals_the_reference(mode):
    """Both modes on the same gradients and error: the representatives and
    the new error equal the reference's (int8 rounds half to even, as
    ``jnp.round``; the values include exact halves of the scale)."""
    rng = np.random.default_rng(3)
    g = {"a": rng.standard_normal((5, 7)).astype(np.float32),
         "b": (np.arange(-6, 7) * 0.5).astype(np.float32)}
    e = {"a": (rng.standard_normal((5, 7)) * 1e-3).astype(np.float32),
         "b": np.zeros(13, np.float32)}
    c, err = compress_tree({k: torch.as_tensor(v) for k, v in g.items()},
                           {k: torch.as_tensor(v) for k, v in e.items()},
                           mode)
    jc, jerr = jcomp.compress_tree({k: jnp.asarray(v) for k, v in g.items()},
                                   {k: jnp.asarray(v) for k, v in e.items()},
                                   mode)
    for k in g:
        np.testing.assert_array_equal(c[k].numpy(), np.asarray(jc[k]))
        np.testing.assert_allclose(err[k].numpy(), np.asarray(jerr[k]),
                                   rtol=0, atol=1e-7)


def test_adamw_steps_equal_the_reference_update():
    """The same numpy gradients and starting state through 3 steps of
    both optimizers with ``linear_warmup_cosine``: parameters, ``m``,
    ``v``, the reported norm and the rate within 1e-6 relative. The grads
    are large enough that clipping acts, and the tree mixes matrices
    (decayed) and vectors (not)."""
    rng = np.random.default_rng(4)
    shapes = {"w": (6, 5), "b": (5,), "e": (3, 4, 2)}
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    m0 = {k: (rng.standard_normal(s) * 0.1).astype(np.float32)
          for k, s in shapes.items()}
    v0 = {k: (rng.random(s) * 0.01).astype(np.float32)
          for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * 3).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    jopt = jadamw.AdamW(learning_rate=jsched.linear_warmup_cosine(
        1e-2, 2, 10))
    jparams = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = jadamw.OptState(jnp.asarray(4, jnp.int32),
                             {k: jnp.asarray(v) for k, v in m0.items()},
                             {k: jnp.asarray(v) for k, v in v0.items()})
    names = list(shapes)
    params = [torch.nn.Parameter(torch.as_tensor(p0[n])) for n in names]
    opt = AdamW(params, learning_rate=linear_warmup_cosine(1e-2, 2, 10))
    opt.load_opt_state(OptState(4, {n: torch.as_tensor(m0[n]) for n in m0},
                                {n: torch.as_tensor(v0[n]) for n in v0}),
                       names)
    for g in grads:
        upd, jstate, jnorm = jopt.update(
            {k: jnp.asarray(v) for k, v in g.items()}, jstate, jparams)
        jparams = jadamw.apply_updates(jparams, upd)
        for p, n in zip(params, names):
            p.grad = torch.as_tensor(g[n])
        opt.step()
        assert float(opt.last_grad_norm) == pytest.approx(float(jnorm),
                                                          rel=1e-6)
        assert float(jnorm) > 1.0                 # the clip acts
        assert opt.last_lr == pytest.approx(float(jopt._lr(jstate.step)),
                                            rel=1e-6)
        st = opt.opt_state(names)
        assert st.step == int(jstate.step)
        for i, n in enumerate(names):
            for a, b in ((params[i].detach(), jparams[n]),
                         (st.m[n], jstate.m[n]), (st.v[n], jstate.v[n])):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-6, atol=1e-9)
    got = apply_updates({"w": torch.ones(2)}, {"w": torch.full((2,), 0.5)})
    assert torch.equal(got["w"], torch.full((2,), 1.5))


def test_adamw_state_dict_round_trip():
    w = torch.nn.Parameter(torch.ones(3, 2))
    opt = AdamW([w], learning_rate=0.1)
    w.grad = torch.ones(3, 2)
    opt.step()
    opt.step()
    sd = opt.state_dict()
    assert sd["step"] == 2
    w2 = torch.nn.Parameter(w.detach().clone())
    opt2 = AdamW([w2], learning_rate=0.1)
    opt2.load_state_dict(sd)
    assert opt2.step_count == 2
    for key in ("m", "v"):
        assert torch.equal(opt2.state[w2][key], opt.state[w][key])


# ---------------------------------------------- the reference's data tests

def test_deterministic_across_instances():
    a = SyntheticLMDataset(1000, 32, 8, seed=3).global_batch_at(17)
    b = SyntheticLMDataset(1000, 32, 8, seed=3).global_batch_at(17)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_different_steps_differ():
    ds = SyntheticLMDataset(1000, 32, 8, seed=3)
    assert not np.array_equal(ds.global_batch_at(0)["tokens"],
                              ds.global_batch_at(1)["tokens"])


def test_shards_partition_global_batch():
    ds = SyntheticLMDataset(1000, 16, 8, seed=1)
    full = ds.global_batch_at(5)["tokens"]
    parts = [ds.shard_batch_at(5, s, 4)["tokens"] for s in range(4)]
    np.testing.assert_array_equal(np.concatenate(parts), full)


def test_elastic_reshard_consistency():
    ds = SyntheticLMDataset(1000, 16, 8, seed=1)
    two = np.concatenate([ds.shard_batch_at(9, s, 2)["tokens"]
                          for s in range(2)])
    eight = np.concatenate([ds.shard_batch_at(9, s, 8)["tokens"]
                            for s in range(8)])
    np.testing.assert_array_equal(two, eight)


def test_tokens_in_vocab_range():
    t = SyntheticLMDataset(500, 64, 4).global_batch_at(0)["tokens"]
    assert t.min() >= 1 and t.max() < 500
    assert t.dtype == np.int32


def test_iterator_resumes_at_step():
    ds = SyntheticLMDataset(1000, 16, 4, seed=2)
    it = DataIterator(ds, start_step=10)
    step, batch = next(it)
    it.close()
    assert step == 10
    np.testing.assert_array_equal(batch["tokens"],
                                  ds.global_batch_at(10)["tokens"])


def test_iterator_prefetch_order():
    it = DataIterator(SyntheticLMDataset(1000, 16, 4), start_step=0,
                      prefetch=3)
    steps = [next(it)[0] for _ in range(5)]
    it.close()
    assert steps == [0, 1, 2, 3, 4]


@pytest.mark.parametrize("vocab,seq,batch,seed", [
    (512, 64, 8, 0), (32_000, 256, 4, 7), (128_256, 512, 4, 0),
    (50_280, 100, 3, 11)])
def test_batches_equal_the_reference_bit_for_bit(vocab, seq, batch, seed):
    ds, jds = SyntheticLMDataset(vocab, seq, batch, seed), \
        JDataset(vocab, seq, batch, seed)
    for step in (0, 1, 17, 1000):
        a, b = ds.global_batch_at(step), jds.global_batch_at(step)
        for k in ("tokens", "loss_mask"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    if batch % 2 == 0:
        for shard in range(2):
            np.testing.assert_array_equal(
                ds.shard_batch_at(5, shard, 2)["tokens"],
                jds.shard_batch_at(5, shard, 2)["tokens"])


# ---------------------------------------- the reference's checkpoint tests

def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": torch.as_tensor(rng.standard_normal((4, 8)),
                                 dtype=torch.float32),
            "nested": {"b": torch.arange(10, dtype=torch.int32)},
            "blocks": (torch.ones(2, 3), np.zeros(5))}


def test_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path)
    tree = _tree()
    mgr.save(7, tree, extra={"note": "x"})
    target = {"a": torch.zeros(4, 8), "nested": {"b": torch.zeros(
        10, dtype=torch.int32)}, "blocks": (torch.zeros(2, 3), np.ones(5))}
    restored, extra = mgr.restore(7, target)
    assert extra == {"note": "x"}
    assert isinstance(restored["blocks"], tuple)
    for a, b in ((tree["a"], restored["a"]),
                 (tree["nested"]["b"], restored["nested"]["b"]),
                 (tree["blocks"][0], restored["blocks"][0])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    np.testing.assert_array_equal(restored["blocks"][1], tree["blocks"][1])


def test_layout_is_the_reference_layout(tmp_path):
    """``step_%08d/`` with ``manifest.json`` (step, names, extra) and
    ``shard_00000.npz`` (leaf_i), readable by the reference's manager."""
    from repro.train.checkpoint import CheckpointManager as JManager
    mgr = CheckpointManager(tmp_path)
    mgr.save(3, {"x": torch.arange(6.0).reshape(2, 3),
                 "y": {"z": torch.ones(4)}}, extra={"step": 3})
    d = tmp_path / "step_00000003"
    man = json.loads((d / "manifest.json").read_text())
    assert man == {"step": 3, "names": ["x", "y/z"], "extra": {"step": 3}}
    assert sorted(np.load(d / "shard_00000.npz").files) == ["leaf_0",
                                                            "leaf_1"]
    tree, extra = JManager(tmp_path).restore(
        3, {"x": jnp.zeros((2, 3)), "y": {"z": jnp.zeros(4)}})
    np.testing.assert_array_equal(np.asarray(tree["x"]),
                                  np.arange(6.0).reshape(2, 3))
    assert extra == {"step": 3}


def test_latest_and_retention(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(s))
    assert mgr.latest_step() == 4
    assert mgr.available_steps() == [3, 4]


def test_async_save(tmp_path):
    mgr = CheckpointManager(tmp_path)
    tree = _tree()
    mgr.save_async(5, tree)
    tree["a"].add_(1.0)      # the snapshot was taken before the write
    mgr.wait()
    assert mgr.latest_step() == 5
    restored, _ = mgr.restore(5, _tree())
    assert torch.equal(restored["a"], _tree()["a"])


def test_tmp_dirs_garbage_collected(tmp_path):
    (tmp_path / "step_00000009.tmp").mkdir()
    mgr = CheckpointManager(tmp_path)
    assert not (tmp_path / "step_00000009.tmp").exists()
    assert mgr.available_steps() == []


def test_incomplete_checkpoint_ignored(tmp_path):
    mgr = CheckpointManager(tmp_path)
    (tmp_path / "step_00000003").mkdir()
    assert mgr.available_steps() == []


def test_shape_mismatch_raises(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"a": torch.ones(3)})
    with pytest.raises(ValueError):
        mgr.restore(1, {"a": torch.ones(4)})
    with pytest.raises(KeyError):
        mgr.restore(1, {"b": torch.ones(3)})


def test_restart_replay_equivalence(tmp_path):
    """Save at step k, keep training, restore -> identical params as a
    fresh run that never crashed (determinism of the whole loop)."""
    def run(steps, crash_at=None, mgr=None):
        w = torch.nn.Parameter(torch.ones(8, 8) * 0.1)
        opt = AdamW([w], learning_rate=1e-2)
        ds = SyntheticLMDataset(32, 16, 8, seed=1)
        step = 0
        while step < steps:
            if crash_at is not None and step == crash_at:
                latest = mgr.latest_step()
                tree, _ = mgr.restore(latest, {
                    "params": {"w": w}, "opt": opt.state_dict()})
                with torch.no_grad():
                    w.copy_(tree["params"]["w"])
                opt.load_state_dict(tree["opt"])
                step, crash_at = latest, None
                continue
            batch = ds.global_batch_at(step)
            w.grad = torch.as_tensor(
                batch["tokens"][:8, :8].astype(np.float32) / 100.0)
            opt.step()
            step += 1
            if mgr is not None and step % 2 == 0:
                mgr.save(step, {"params": {"w": w},
                                "opt": opt.state_dict()})
        return w.detach()

    clean = run(8)
    crashed = run(8, crash_at=5, mgr=CheckpointManager(tmp_path, keep=10))
    assert torch.equal(clean, crashed)


def test_train_state_round_trip(tmp_path):
    """The model's state and the optimizer's step, m and v by port names
    save and restore into a fresh model and optimizer."""
    cfg = get_config("mamba2-780m", reduced=True)
    model = Model(cfg, device=CPU).init(seed=3)
    opt = AdamW(model.parameters(), learning_rate=1e-3)
    model.loss(lm_batch(cfg, s=32), remat="none", attn_chunk=32)[0].backward()
    opt.step()
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, train_state_tree(model, opt), extra={"step": 1})
    fresh = Model(cfg, device=CPU).init(seed=4)
    opt2 = AdamW(fresh.parameters(), learning_rate=1e-3)
    tree, extra = mgr.restore(1, train_state_tree(fresh, opt2))
    assert load_train_state(fresh, opt2, tree) == 1 and extra == {"step": 1}
    names = [n for n, _ in model.named_parameters()]
    assert any(n.startswith("opt/m/blocks.0.mixer.")
               for n in json.loads((tmp_path / "step_00000001" /
                                    "manifest.json").read_text())["names"])
    for (n, a), b in zip(model.state_dict().items(),
                         fresh.state_dict().values()):
        assert torch.equal(a, b), n
    s1, s2 = opt.opt_state(names), opt2.opt_state(names)
    assert s2.step == s1.step == 1
    for n in names:
        assert torch.equal(s1.m[n], s2.m[n]) and torch.equal(s1.v[n],
                                                             s2.v[n])


# -------------------------------------- the reference's fault-tolerance tests

def test_heartbeat_detects_silent_host():
    mon = HeartbeatMonitor(["h0", "h1"], timeout_s=10.0)
    mon.beat("h0", now=100.0)
    mon.beat("h1", now=100.0)
    mon.beat("h0", now=120.0)
    assert mon.dead_hosts(now=121.0) == ["h1"]


def test_straggler_detector_flags_slow_host():
    det, jdet = StragglerDetector(k=3.0, patience=2), \
        jft.StragglerDetector(k=3.0, patience=2)
    for step in range(4):
        for h in ("h0", "h1", "h2", "h3"):
            t = 1.0 + (2.0 if h == "h3" else 0.0) + 0.01 * step
            det.record(h, t)
            jdet.record(h, t)
        stragglers = det.stragglers()
        assert stragglers == jdet.stragglers()
    assert stragglers == ["h3"]


def test_straggler_needs_patience():
    det = StragglerDetector(k=3.0, patience=3)
    for h in ("h0", "h1", "h2"):
        det.record(h, 1.0)
    det.record("h3", 9.0)
    assert det.stragglers() == []


def test_elastic_plan_drops_pod_keeps_tp():
    plan = plan_elastic_restart(total_hosts=64, dead=["pod1:h3"],
                                hosts_per_pod=32, model_axis=16,
                                data_axis=16, resume_step=100)
    assert plan == ElasticPlan((16, 16), ("data", "model"), ("pod1",), 100)


def test_elastic_plan_multi_pod_survivors():
    kw = dict(total_hosts=96, dead=["pod2:h0"], hosts_per_pod=32,
              model_axis=16, data_axis=16, resume_step=None)
    plan = plan_elastic_restart(**kw)
    assert plan.mesh_shape == (2, 16, 16)
    assert plan.axis_names == ("pod", "data", "model")
    assert dataclasses.asdict(plan) == dataclasses.asdict(
        jft.plan_elastic_restart(**kw))


def test_run_with_restarts_completes_through_failures():
    executed, saved = [], {"step": 0}

    def save_fn(step):
        saved["step"] = step

    res = run_with_restarts(
        executed.append, n_steps=20, save_every=5, save_fn=save_fn,
        restore_fn=lambda: saved["step"],
        failure_schedule={7: RuntimeError("preempted"),
                          13: OSError("node died")})
    assert res == {"final_step": 20, "restarts": 2}
    assert executed.count(6) >= 2


def test_run_with_restarts_gives_up():
    with pytest.raises(RuntimeError):
        run_with_restarts(lambda s: None, n_steps=5, save_every=100,
                          save_fn=lambda s: None, restore_fn=lambda: 0,
                          failure_schedule={0: RuntimeError("x")},
                          max_restarts=0)


# ------------------------------------------------------------- remat

# one config of each family, and gemma2's local layers and softcaps
REMAT_ARCHS = ("llama3.2-3b", "gemma2-9b", "mixtral-8x22b", "mamba2-780m",
               "recurrentgemma-9b", "whisper-large-v3", "qwen2-vl-72b")


def _port_model(arch):
    """The port's reduced ``arch`` at float32 compute on its own seed-1
    weights."""
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              compute_dtype="float32")
    return Model(cfg, device=CPU).init(seed=1)


@functools.lru_cache(maxsize=None)
def _none_grads(arch):
    model = _port_model(arch)
    return port_grads(model, lm_batch(model.cfg))


@pytest.mark.parametrize("remat", [r for r in REMAT_POLICIES if r != "none"])
@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_remat_policies_change_no_number(arch, remat):
    """Loss, metrics and every gradient under each remat policy equal
    ``"none"``'s bit for bit (the recomputation repeats the same
    operations on the same inputs)."""
    model = _port_model(arch)
    want = _none_grads(arch)
    got = port_grads(model, lm_batch(model.cfg), remat=remat)
    assert got[0] == want[0] and got[1] == want[1]
    for n in want[2]:
        assert torch.equal(got[2][n], want[2][n]), n


def test_remat_policies_save_the_ops_they_name(monkeypatch):
    """What each selective policy keeps for the backward pass, recorded
    from its decisions over one forward of whisper (self- and
    cross-attention, FFN): ``dots`` the matmuls and the batched attention
    products, ``dots_no_batch`` the matmuls only, ``save_outs`` the three
    tagged sublayer outputs of every decoder layer and nothing else."""
    from repro_torch.models import transformer as tfm
    from torch.utils.checkpoint import CheckpointPolicy
    model = _port_model("whisper-large-v3")
    batch = lm_batch(model.cfg)
    seen = []
    real = tfm._saving

    def spy(ops, ctx, func, *args, **kwargs):
        out = real(ops, ctx, func, *args, **kwargs)
        if out == CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            seen.append(func.__name__)
        return out

    monkeypatch.setattr(tfm, "_saving", spy)
    saved = {}
    for remat in ("dots", "dots_no_batch", "save_outs"):
        seen.clear()
        model.loss(batch, remat=remat, attn_chunk=32)
        saved[remat] = sorted(set(seen)), len(seen)
    assert saved["dots"][0] == ["addmm.default", "bmm.default",
                                "mm.default"] or \
        saved["dots"][0] == ["bmm.default", "mm.default"]
    assert "bmm.default" not in saved["dots_no_batch"][0]
    assert "mm.default" in saved["dots_no_batch"][0]
    assert saved["save_outs"] == (["checkpoint_name.default"],
                                  3 * model.cfg.n_layers)


# ------------------------------------------------------------ train step

def test_microbatched_grads_match_full_batch():
    """``test_system.py``'s microbatch test on the port, and both steps'
    parameters against the reference's ``make_train_step`` at float32."""
    arch = "phi4-mini-3.8b"
    out = {}
    for mb in (1, 2):
        model, jm, jp = pair(arch, "float32", seed=0)
        cfg = model.cfg
        batch = {"tokens": np.random.default_rng(0).integers(
            1, cfg.vocab_size, (4, 64)).astype(np.int32)}
        opt = AdamW(model.parameters(), learning_rate=1e-2)
        step = make_train_step(model, opt, remat="none", attn_chunk=32,
                               microbatches=mb)
        m = step({"tokens": torch.as_tensor(batch["tokens"])})
        jopt = jadamw.AdamW(learning_rate=1e-2)
        jstep = jmake_train_step(jm, jopt, remat="none", attn_chunk=32,
                                 microbatches=mb)
        jargs = (jp, jopt.init(jp), {"tokens": jnp.asarray(batch["tokens"])})
        jp2, jst, jm_ = compiled(jstep, *jargs)(*jargs)
        assert float(m["loss"]) == pytest.approx(float(jm_["loss"]),
                                                 rel=1e-5)
        assert float(m["grad_norm"]) == pytest.approx(
            float(jm_["grad_norm"]), rel=1e-4)
        assert m["lr"] == pytest.approx(float(jm_["lr"]), rel=1e-6)
        # m holds the clipped gradients; the first step moves each
        # parameter by about +-lr whatever its gradient's size, so a
        # gradient near zero moves its parameter's sign at 1e-5 of max
        names = [n for n, _ in model.named_parameters()]
        jst = convert.opt_state_from_jax(cfg, jax.tree.map(np.asarray, jst))
        assert leaf_err(opt.opt_state(names).m, jst.m) < 1e-4
        want = convert.params_from_jax(cfg, jax.tree.map(np.asarray, jp2))
        assert leaf_err(dict(model.state_dict()), want) < 1e-3
        out[mb] = (float(m["loss"]), {n: p.detach().clone()
                                      for n, p in model.named_parameters()})
    assert out[1][0] == pytest.approx(out[2][0], rel=1e-3)
    assert max(float((out[1][1][n] - out[2][1][n]).abs().max())
               for n in out[1][1]) < 5e-2


def test_bf16_grad_compression_rounds_the_grads():
    model = Model(get_config("llama3.2-3b", reduced=True),
                  device=CPU).init(seed=0)
    seen = {}

    class Spy(AdamW):
        def step(self, closure=None):
            seen.update({n: p.grad.clone() for n, p in
                         zip(names, self._params())})
            return super().step()

    names = [n for n, _ in model.named_parameters()]
    opt = Spy(model.parameters(), learning_rate=1e-3)
    step = make_train_step(model, opt, remat="none", attn_chunk=32,
                           grad_compression="bf16")
    step(lm_batch(model.cfg))
    for g in seen.values():
        assert torch.equal(g, g.to(torch.bfloat16).float())
    with pytest.raises(ValueError):
        make_train_step(model, opt, grad_compression="int4")


# ------------------------------------------------------------ the driver

def _reference_losses(jcfg, jp, argv_kw, n_steps):
    """The reference's parts without the mesh: ``SyntheticLMDataset``,
    ``AdamW(linear_warmup_cosine)``, ``make_train_step`` under
    ``jax.jit``, the driver's batches (and stub frames)."""
    jm = JModel(jcfg)
    jopt = jadamw.AdamW(learning_rate=jsched.linear_warmup_cosine(
        argv_kw["lr"], argv_kw["warmup"], argv_kw["steps"]))
    ds = JDataset(jcfg.vocab_size, argv_kw["seq"], argv_kw["batch"])
    state = jopt.init(jp)
    losses = []
    jstep = None
    for step in range(n_steps):
        batch = {k: jnp.asarray(v) for k, v in
                 ds.global_batch_at(step).items()}
        if jcfg.is_encdec:
            rng = np.random.default_rng(step)
            batch["audio_embed"] = jnp.asarray(rng.standard_normal(
                (argv_kw["batch"], jcfg.encoder_len, jcfg.d_model)),
                jnp.bfloat16)
        if jstep is None:
            jstep = compiled(jmake_train_step(
                jm, jopt, remat="none", attn_chunk=argv_kw["attn_chunk"]),
                jp, state, batch)
        jp, state, m = jstep(jp, state, batch)
        losses.append(float(m["loss"]))
    return losses, state


@pytest.mark.parametrize("arch", ["llama3.2-3b", "mixtral-8x22b",
                                  "mamba2-780m", "whisper-large-v3"])
def test_driver_losses_match_the_reference_parts(arch, tmp_path):
    """``launch.train.main(model=...)`` on carried-across weights at
    float32 compute: its first 5 losses within 1e-4 relative of the
    reference's parts run without the mesh; both optimizers start from the
    same (zero) state, the reference's carried across by
    ``opt_state_from_jax``, and end in the same one."""
    model, jm, jp = pair(arch, "float32", seed=0)
    kw = dict(steps=5, batch=4, seq=64, lr=3e-3, warmup=2, attn_chunk=32)
    want, jstate = _reference_losses(jm.cfg, jp, kw, 5)
    res = train.main(["--arch", arch, "--reduced", "--steps", "5",
                      "--batch", "4", "--seq", "64", "--lr", "3e-3",
                      "--warmup", "2", "--attn-chunk", "32",
                      "--save-every", "100", "--ckpt-dir",
                      str(tmp_path / "ckpt"), "--device", CPU], model=model)
    assert res["final_step"] == 5 and res["restarts"] == 0
    np.testing.assert_allclose(res["losses"], want, rtol=1e-4)
    names = [n for n, _ in model.named_parameters()]
    st = res["optimizer"].opt_state(names)
    jst = convert.opt_state_from_jax(model.cfg,
                                     jax.tree.map(np.asarray, jstate))
    assert st.step == jst.step == 5
    assert leaf_err(st.m, jst.m) < 1e-4


def test_opt_state_from_jax_starts_both_optimizers_alike():
    """A reference ``OptState`` with values in ``m`` / ``v`` carried into
    the port's AdamW: one step on the same gradients gives the same
    parameters (whisper: the encoder's stacked leaves unstack too)."""
    arch = "whisper-large-v3"
    model, jm, jp = pair(arch, "float32")
    cfg = model.cfg
    rng = np.random.default_rng(2)
    jg = jax.tree.map(lambda p: jnp.asarray(
        rng.standard_normal(p.shape).astype(np.float32)), jp)
    jm0 = jax.tree.map(lambda p: p * 0.01, jg)
    jv0 = jax.tree.map(lambda p: p * p * 0.001, jg)
    jopt = jadamw.AdamW(learning_rate=1e-3)
    jstate = jadamw.OptState(jnp.asarray(3, jnp.int32), jm0, jv0)
    upd, _, _ = jopt.update(jg, jstate, jp)
    want = convert.params_from_jax(cfg, jax.tree.map(
        np.asarray, jadamw.apply_updates(jp, upd)))
    names = [n for n, _ in model.named_parameters()]
    opt = AdamW(model.parameters(), learning_rate=1e-3)
    opt.load_opt_state(convert.opt_state_from_jax(
        cfg, jax.tree.map(np.asarray, jstate)), names)
    grads = convert.params_from_jax(cfg, jax.tree.map(np.asarray, jg))
    for n, p in model.named_parameters():
        p.grad = grads[n]
    opt.step()
    assert any(n.startswith("encoder.1.") for n in names)
    assert leaf_err(dict(model.named_parameters()), want) < 1e-6


def test_training_loss_decreases(tmp_path):
    """``test_system.py::test_training_loss_decreases`` on the port."""
    res = train.main(["--arch", "llama3.2-3b", "--reduced", "--steps",
                      "40", "--batch", "8", "--seq", "64", "--lr", "3e-3",
                      "--ckpt-dir", str(tmp_path / "ckpt"), "--save-every",
                      "100", "--attn-chunk", "32", "--device", CPU])
    losses = res["losses"]
    assert res["restarts"] == 0 and res["loss_steps"] == list(range(40))
    assert losses[-1] < losses[0] - 0.5, (losses[0], losses[-1])
    assert res["step_ms"] > 0 and res["tok_s"] > 0


def test_training_restart_path(tmp_path):
    """``test_system.py::test_training_restart_path`` on the port."""
    res = train.main(["--arch", "mamba2-780m", "--reduced", "--steps",
                      "12", "--batch", "4", "--seq", "64", "--ckpt-dir",
                      str(tmp_path / "ckpt"), "--save-every", "4",
                      "--simulate-failures", "--attn-chunk", "32",
                      "--device", CPU])
    assert res["final_step"] == 12
    assert res["restarts"] == 2


def test_replay_after_restore_is_exact(tmp_path):
    """Failures at steps 4 and 8 with checkpoints every 3 steps: the
    driver restores steps 3 and 6 (model and optimizer) and re-runs 3 and
    6-7; every re-run loss equals the first run's bit for bit, and every
    loss equals an uninterrupted run's."""
    argv = ["--arch", "mamba2-780m", "--reduced", "--steps", "12",
            "--batch", "4", "--seq", "64", "--save-every", "3",
            "--attn-chunk", "32", "--device", CPU]
    res = train.main(argv + ["--simulate-failures", "--ckpt-dir",
                             str(tmp_path / "a")])
    clean = train.main(argv + ["--ckpt-dir", str(tmp_path / "b")])
    assert res["restarts"] == 2 and res["final_step"] == 12
    assert res["loss_steps"] == [0, 1, 2, 3, 3, 4, 5, 6, 7, 6, 7, 8, 9,
                                 10, 11]
    first = {}
    for step, loss in zip(res["loss_steps"], res["losses"]):
        first.setdefault(step, loss)
        assert loss == first[step] == clean["losses"][step], step
    assert clean["loss_steps"] == list(range(12))


def test_driver_refuses_data_parallel_and_a_missing_card(tmp_path):
    """``--data-parallel`` runs (``tests/test_torch_sharding.py``); a
    count that does not split the batch, or cards it lacks, raise."""
    with pytest.raises(ValueError, match="does not split"):
        train.main(["--arch", "llama3.2-3b", "--reduced",
                    "--data-parallel", "3", "--device", CPU])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(["--arch", "llama3.2-3b", "--reduced",
                        "--data-parallel", "2"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(["--arch", "llama3.2-3b", "--reduced", "--steps",
                        "1", "--ckpt-dir", str(tmp_path)])


def test_train_lm_example_config(tmp_path):
    """``examples.train_lm``'s ~100M llama (``meta``: shapes only) and a
    short run of the example at it on the CPU."""
    from repro_torch.examples import train_lm
    cfg = train_lm.llama_100m()
    n = count_params(Model(cfg, device="meta"))
    assert 80e6 < n < 130e6, n
    res = train_lm.main(["--steps", "4", "--batch", "2", "--seq", "32",
                         "--ckpt-dir", str(tmp_path), "--device", CPU])
    assert res["final_step"] == 4 and res["losses"][-1] < res["losses"][0]


# ------------------------------------------------- SSD's masked decay

def test_ssd_decay_mask_keeps_values_and_finite_grads():
    """The deliberate divergence in ``models/ssm.py``: at mamba2-780m's
    chunk of 256 with its initial decay (A = -1, softplus(dt - 1)), the
    reference's ``where(tri, exp(li), 0)`` overflows above the diagonal and
    its gradient is NaN; the port masks ``li`` first, so its chunk gives
    the reference's values (where the reference's gradient is finite, at a
    chunk of 32, also its gradients) and finite gradients at 256."""
    cfg, jcfg = cfgs("mamba2-780m", "float32", ssm_chunk=256)
    rng = np.random.default_rng(7)
    b, s, h, p, n = 1, 256, 4, 8, 16
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt_pos = np.log1p(np.exp(rng.standard_normal((b, s, h)) - 1.0))
    da = (-dt_pos).astype(np.float32)
    bm = rng.standard_normal((b, s, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, n)).astype(np.float32)
    h0 = np.zeros((b, h, n, p), np.float32)
    assert float(-da.sum(1).max()) > 88.8      # exp overflows in float32

    def jloss(x_, da_, c):
        y, hf = jssm._chunk_scan(c, x_, da_, jnp.asarray(bm),
                                 jnp.asarray(cm), jnp.asarray(h0))
        return jnp.sum(y) + jnp.sum(hf)

    jy, jh = jssm._chunk_scan(jcfg, jnp.asarray(x), jnp.asarray(da),
                              jnp.asarray(bm), jnp.asarray(cm),
                              jnp.asarray(h0))
    jgx, jgda = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x),
                                                jnp.asarray(da), jcfg)
    assert not np.isfinite(np.asarray(jgda)).all()
    xt = torch.as_tensor(x).requires_grad_()
    dat = torch.as_tensor(da).requires_grad_()
    y, hf = ssm._chunk_scan(cfg, xt, dat, torch.as_tensor(bm),
                            torch.as_tensor(cm), torch.as_tensor(h0))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(hf.detach().numpy(), np.asarray(jh),
                               rtol=1e-4, atol=1e-4)
    (y.sum() + hf.sum()).backward()
    assert torch.isfinite(xt.grad).all() and torch.isfinite(dat.grad).all()
    # at a chunk of 32 the reference's gradient is finite: equal there
    cfg32, jcfg32 = cfgs("mamba2-780m", "float32", ssm_chunk=32)
    jgx, jgda = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x),
                                                jnp.asarray(da), jcfg32)
    assert np.isfinite(np.asarray(jgda)).all()
    xt.grad = dat.grad = None
    y, hf = ssm._chunk_scan(cfg32, xt, dat, torch.as_tensor(bm),
                            torch.as_tensor(cm), torch.as_tensor(h0))
    (y.sum() + hf.sum()).backward()
    for got, want in ((xt.grad, jgx), (dat.grad, jgda)):
        want = np.asarray(want)
        assert float(np.abs(got.numpy() - want).max()) <= \
            1e-4 * np.abs(want).max()

