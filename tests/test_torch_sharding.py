"""The port's meshes, sharding rules and data-parallel training
(``repro_torch.launch.{mesh,sharding,train}``, ``models.partitioning``,
``train.train_step``'s ``grad_shardings``) held against the JAX package's
on the CPU.

The rules against the reference's for every arch on 16 x 16 and
2 x 16 x 16 mesh stand-ins (the counterparts of the four
``tests/test_sharding.py`` tests that pass in the reference); the reduced
llama3.2-3b train step with DTensor parameters on a fake-group debug mesh
(the counterpart of the reference's failing
``test_lower_train_step_on_debug_mesh``); ``launch.train --data-parallel
2`` in two gloo processes against the one-process run of the same split.
"""
import math

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jget_config
from repro.launch import sharding as jshd
from repro.models import Model as JModel
from repro_torch.configs import SHAPES, ShapeConfig, get_config, list_archs
from repro_torch.data import SyntheticLMDataset
from repro_torch.launch import mesh as meshes
from repro_torch.launch import sharding as shd
from repro_torch.launch import specs, train
from repro_torch.models import Model
from repro_torch.models.partitioning import logical_axis_rules, shard_hint
from repro_torch.optim import AdamW, linear_warmup_cosine
from repro_torch.roofline import OpCounter
from repro_torch.train import make_train_step
from repro_torch.train.checkpoint import CheckpointManager


class Mesh16:
    """A mesh stand-in: axis names and sizes, no devices."""
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


class Mesh2x16:
    axis_names = ("pod", "data", "model")
    shape = {"pod": 2, "data": 16, "model": 16}


MESHES = [Mesh16(), Mesh2x16()]


def _ref_leaves(tree):
    return {jshd._path_names(p): s for p, s in
            jax.tree_util.tree_leaves_with_path(
                tree, is_leaf=lambda x: isinstance(x, P))}


# --------------------------------------------------------------- rules

@pytest.mark.parametrize("mesh", MESHES, ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", list_archs())
def test_logical_rules_equal_the_reference(arch, mesh):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for kw in (dict(batch_size=256, seq_len=4096), dict(batch_size=1),
               dict(batch_size=128)):          # train; long_500k; decode
        assert shd.logical_rules(cfg, mesh, **kw) == \
            jshd.logical_rules(jcfg, mesh, **kw), kw
    assert shd.heads_shardable(cfg, mesh) == jshd.heads_shardable(jcfg, mesh)
    assert shd.moe_ep(cfg, mesh) == jshd.moe_ep(jcfg, mesh)


@pytest.mark.parametrize("arch", list_archs())
def test_logical_rules_consistency(arch):
    """The reference's own test on the port."""
    cfg = get_config(arch)
    rules = shd.logical_rules(cfg, Mesh16(), batch_size=256, seq_len=4096)
    if cfg.n_heads and cfg.n_heads % 16 == 0:
        assert rules["heads"] == "model"
        assert rules["attn_q_seq"] is None
    elif cfg.n_heads:
        assert rules["heads"] is None
        assert rules["attn_q_seq"] == "model"
    if cfg.is_moe:
        ep = cfg.n_experts % 16 == 0
        assert (rules["experts"] == "model") == ep
        if ep:
            assert rules["moe_ffn"] is None


def test_batch_replicated_when_indivisible():
    rules = shd.logical_rules(get_config("mamba2-780m"), Mesh16(),
                              batch_size=1)
    assert rules["batch"] is None


@pytest.mark.parametrize("mesh", MESHES, ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_equal_the_reference_without_the_lead(arch, mesh):
    cfg = get_config(arch)
    model = Model(cfg, device="meta")
    specs_ = shd.param_specs(cfg, model.named_parameters(), mesh)
    jcfg = jget_config(arch)
    jparams = JModel(jcfg).abstract_params()
    ref = _ref_leaves(jshd.param_specs(jcfg, jparams, mesh))
    seen = set()
    sizes = meshes.axis_sizes(mesh)
    for name, p in model.named_parameters():
        path = shd.reference_path(cfg, name)
        want = tuple(ref[path])
        if path[0] in ("blocks", "encoder"):
            assert want[0] is None
            want = want[1:]
        assert specs_[name] == want, (name, specs_[name], want)
        assert len(specs_[name]) <= p.dim()
        for dim, entry in zip(p.shape, specs_[name]):
            if entry is None:
                continue
            n = math.prod(sizes[a] for a in
                          (entry if isinstance(entry, tuple) else (entry,)))
            assert dim % n == 0, (name, p.shape, specs_[name])
        seen.add(path)
    assert seen == set(ref)                         # no leaf missed
    assert set(specs_) == {n for n, _ in model.named_parameters()}


@pytest.mark.parametrize("arch", list_archs())
def test_batch_and_cache_specs_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for mesh in MESHES:
        for shape in SHAPES.values():
            assert shd.batch_specs(cfg, shape, mesh) == {
                k: tuple(v) for k, v in
                jshd.batch_specs(jcfg, shape, mesh).items()}
        for b, s in ((128, 32768), (1, 4096)):
            cache = Model(cfg, device="meta").init_cache(b, s)
            port = shd.cache_specs(cfg, cache, mesh, batch_size=b)
            jcache = JModel(jcfg).abstract_cache(b, s)
            ref = jshd.cache_specs(jcfg, jcache, mesh, batch_size=b)
            for layer, c in enumerate(port):
                jc = ref[layer % cfg.pattern_len]
                for part, leaves in c.items():
                    for n, spec in leaves.items():
                        want = tuple(jc[part][n])
                        assert want[0] is None
                        assert spec == want[1:], (layer, part, n)


def test_cache_specs_seq_over_model():
    cfg = get_config("llama3.2-3b")
    cache = Model(cfg, device="meta").init_cache(128, 32768)
    spec = shd.cache_specs(cfg, cache, Mesh16(), batch_size=128)
    assert spec[0]["self"]["k"] == ("data", "model", None, None)
    assert "model" in spec[0]["self"]["k"]


# ------------------------------------------------- meshes and placements

@pytest.fixture
def fake_mesh():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield meshes.make_debug_mesh(2, 2, device_type="cpu")
    finally:
        dist.destroy_process_group()


def test_meshes_need_their_group_and_make_shard_mesh_none_without():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="16x16 mesh needs"):
        meshes.make_production_mesh(device_type="cpu")
    assert meshes.make_shard_mesh(4, device_type="cpu") is None
    assert meshes.make_shard_mesh(0, device_type="cpu") is None
    assert meshes.dp_axes(Mesh2x16()) == ("pod", "data")
    assert meshes.dp_axes(Mesh16()) == ("data",)


def test_placements_and_shard_hint_on_a_debug_mesh(fake_mesh):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    assert fake_mesh.mesh_dim_names == ("data", "model")
    assert meshes.axis_sizes(fake_mesh) == {"data": 2, "model": 2}
    assert shd.placements(fake_mesh, (("data", "model"), None)) == [
        Shard(0), Shard(0)]
    assert shd.placements(fake_mesh, ("model", "data")) == [Shard(1),
                                                             Shard(0)]
    named = shd.as_named(fake_mesh, {"w": (None, "model"), "c": [(None,)]})
    assert named["w"].mesh is fake_mesh
    assert named["w"].placements == [Replicate(), Shard(1)]
    assert named["c"][0].placements == [Replicate(), Replicate()]

    x = distribute_tensor(torch.empty(8, 4, 16, device="meta"), fake_mesh,
                          [Shard(0), Replicate()], src_data_rank=None)
    plain = torch.ones(3)
    assert shard_hint(x, "batch", "act_seq", None) is x   # no rules
    rules = {"batch": "data", "act_seq": "model"}
    with logical_axis_rules(fake_mesh, rules):
        assert shard_hint(plain, "batch") is plain
        y = shard_hint(x, "batch", "act_seq", None)
        assert tuple(y.placements) == (Shard(0), Shard(1))
        # a dim its axes do not divide stays replicated (decode's S = 1)
        z = distribute_tensor(torch.empty(8, 1, 16, device="meta"),
                              fake_mesh, [Shard(0), Replicate()],
                              src_data_rank=None)
        assert shard_hint(z, "batch", "act_seq", None) is z
    with pytest.raises(RuntimeError, match="no logical axis rules"):
        from repro_torch.models.partitioning import logical_to_spec
        logical_to_spec(("batch",))


def test_lower_train_step_on_debug_mesh(fake_mesh):
    """The reference's failing test's counterpart: the reduced llama
    train step with DTensor parameters of ``param_specs``'s placements on
    a (fake-group) 2 x 2 debug mesh, its gradients pinned to them."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.launch.dryrun import _place_params

    cfg = get_config("llama3.2-3b", reduced=True)
    model = Model(cfg, device="meta")
    sh = shd.as_named(fake_mesh, shd.param_specs(
        cfg, model.named_parameters(), fake_mesh))
    _place_params(model, sh)
    opt = AdamW(model.parameters(), learning_rate=1e-3)
    rules = shd.logical_rules(cfg, fake_mesh, batch_size=2, seq_len=64)
    step = make_train_step(model, opt, remat="none", attn_chunk=64,
                           grad_shardings=sh)
    _, _, batch = specs.train_abstract(model, ShapeConfig("t", 64, 2,
                                                          "train"))
    bsh = shd.as_named(fake_mesh, shd.batch_specs(
        cfg, ShapeConfig("t", 64, 2, "train"), fake_mesh))
    batch = {k: distribute_tensor(v, bsh[k].mesh, bsh[k].placements,
                                  src_data_rank=None)
             for k, v in batch.items()}
    with logical_axis_rules(fake_mesh, rules), implicit_replication(), \
            OpCounter() as counter:
        metrics = step(batch)
    stats = counter.stats()
    assert stats.flops > 0
    assert stats.collective_count["reduce-scatter"] > 0
    assert tuple(metrics["loss"].shape) == ()
    assert opt.step_count == 1
    for name, p in model.named_parameters():
        assert isinstance(p, DTensor)
        assert list(p.placements) == sh[name].placements
        m, _ = opt._moments(p)
        assert list(m.placements) == sh[name].placements


def test_grad_shardings_of_whole_params_need_the_shard_optimizer(fake_mesh):
    """Whole (non-DTensor) parameters with ``grad_shardings`` take the
    data-parallel path, whose optimizer must hold ``shard_params``'s
    views; an optimizer over the parameters themselves is refused."""
    from repro_torch.train.train_step import shard_params
    cfg = get_config("llama3.2-3b", reduced=True)
    model = Model(cfg, device="meta")
    sh = shd.as_named(fake_mesh, shd.param_specs(
        cfg, model.named_parameters(), fake_mesh))
    with pytest.raises(ValueError, match="shard_params"):
        make_train_step(model, AdamW(model.parameters()), grad_shardings=sh)
    step = make_train_step(model, AdamW(shard_params(model, sh).values()),
                           grad_shardings=sh)
    assert step.grad_reduction is None


# --------------------------------------------- data-parallel training

STEPS = 4


def _argv(ckpt, *extra, steps=STEPS):
    return ["--arch", "llama3.2-3b", "--reduced", "--steps", str(steps),
            "--batch", "8", "--seq", "64", "--remat", "none", "--device",
            "cpu", "--ckpt-dir", str(ckpt), "--save-every", str(steps),
            "--log-every", "100", "--attn-chunk", "64", *extra]


def _one_process_of_two_ranks(steps: int = STEPS):
    """The data-parallel step's arithmetic in one process: each half of
    the batch's loss and gradients on their own (as each rank computes
    them), the gradients' halves summed, AdamW on the sum; the losses,
    grad norms and final parameters."""
    cfg = get_config("llama3.2-3b", reduced=True)
    model = Model(cfg, device="cpu").init(seed=0)
    params = list(model.parameters())
    opt = AdamW(params, learning_rate=linear_warmup_cosine(3e-4, 10, steps))
    data = SyntheticLMDataset(cfg.vocab_size, 64, 8)
    losses, norms = [], []
    for step in range(steps):
        loss, grads = 0.0, None
        for r in range(2):
            b = data.shard_batch_at(step, r, 2)
            l, _ = model.loss({"tokens": torch.as_tensor(
                b["tokens"].astype(np.int64)), "loss_mask":
                torch.as_tensor(b["loss_mask"])}, remat="none",
                attn_chunk=64)
            g = torch.autograd.grad(l, params)
            loss = loss + l.detach() / 2
            grads = ([x / 2 for x in g] if grads is None
                     else [a + x / 2 for a, x in zip(grads, g)])
        for p, g in zip(params, grads):
            p.grad = g
        opt.step()
        losses.append(float(loss))
        norms.append(float(opt.last_grad_norm))
    return losses, norms, {n: p.detach().numpy()
                           for n, p in model.named_parameters()}


def _checkpoint_params(path, step):
    target = {n: np.zeros(p.shape, np.float32)
              for n, p in Model(get_config("llama3.2-3b", reduced=True),
                                device="meta").named_parameters()}
    tree, _ = CheckpointManager(path).restore(step, {"params": target})
    return tree["params"]


def test_data_parallel_two_gloo_ranks_match_one_process(tmp_path):
    """Two gloo ranks, each on 4 of the 8 rows, against the same
    arithmetic in one process and against ``launch.train`` in one process
    with 2 microbatches of those rows (the same sums; with one microbatch
    the halves' bf16 weight gradients are rounded together, ~5e-4 apart):
    losses and final parameters within 1e-5. The grad norms within 1e-4:
    a rank takes the float32 norm of its shard of each gradient, one
    process of the whole, and the tied embedding's 131,072 squares summed
    in float32 in other orders part by ~2e-5 (either is ~2e-6 off the
    float64 norm). The gradients travel as a reduce-scatter onto each
    matrix's FSDP shard; only the replicated norm scales are
    all-reduced."""
    dp = train.main(_argv(tmp_path / "dp", "--data-parallel", "2"))
    assert dp["final_step"] == STEPS and dp["restarts"] == 0
    assert dp["loss_steps"] == list(range(STEPS))
    assert CheckpointManager(tmp_path / "dp").latest_step() == STEPS
    final = _checkpoint_params(tmp_path / "dp", STEPS)
    losses, norms, params = _one_process_of_two_ranks()
    at = dp["loss_steps"]
    np.testing.assert_allclose(dp["losses"], [losses[i] for i in at],
                               rtol=1e-5)
    np.testing.assert_allclose(dp["grad_norms"], [norms[i] for i in at],
                               rtol=1e-4)
    for n, p in params.items():
        np.testing.assert_allclose(final[n], p, rtol=1e-5, atol=1e-5,
                                   err_msg=n)

    mb = train.main(_argv(tmp_path / "mb", "--microbatches", "2"))
    assert mb["loss_steps"] == list(range(STEPS))
    np.testing.assert_allclose(dp["losses"], [mb["losses"][i] for i in at],
                               rtol=1e-5)
    np.testing.assert_allclose(
        dp["grad_norms"], [float(mb["grad_norms"][i]) for i in at],
        rtol=1e-4)
    mb_final = _checkpoint_params(tmp_path / "mb", STEPS)
    for n in params:
        np.testing.assert_allclose(final[n], mb_final[n], rtol=1e-5,
                                   atol=1e-5, err_msg=n)

    # what the reduction moved: each parameter's fp32 gradient once
    cfg = get_config("llama3.2-3b", reduced=True)
    model = Model(cfg, device="meta")
    spec = shd.param_specs(cfg, model.named_parameters(), Mesh16())
    sharded = [p for n, p in model.named_parameters()
               if any(e is not None for e in spec[n])]
    replicated = [p for n, p in model.named_parameters()
                  if all(e is None for e in spec[n])]
    red = dp["grad_reduction"]
    assert red["collective_count"]["reduce-scatter"] == len(sharded)
    assert red["collective_bytes"]["reduce-scatter"] == \
        4 * sum(p.numel() for p in sharded)
    assert red["collective_bytes"]["all-reduce"] == \
        4 * sum(p.numel() for p in replicated)
    assert red["collective_bytes"]["all-gather"] == 0
    assert not dist.is_initialized()


def test_data_parallel_restarts_from_rank_zeros_checkpoints(tmp_path):
    """``--simulate-failures`` on two ranks (failures at steps 2 and 5,
    checkpoints every 2): both restore what rank 0 wrote, step 4 runs
    twice, and every loss equals the uninterrupted two-rank run's."""
    argv = ["--arch", "llama3.2-3b", "--reduced", "--steps", "8",
            "--batch", "4", "--seq", "32", "--attn-chunk", "32",
            "--device", "cpu", "--save-every", "2", "--log-every", "100",
            "--data-parallel", "2"]
    clean = train.main(argv + ["--ckpt-dir", str(tmp_path / "a")])
    res = train.main(argv + ["--ckpt-dir", str(tmp_path / "b"),
                             "--simulate-failures"])
    assert res["final_step"] == 8 and res["restarts"] == 2
    assert res["loss_steps"] == [0, 1, 2, 3, 4, 4, 5, 6, 7]
    assert clean["loss_steps"] == list(range(8))
    for step, loss in zip(res["loss_steps"], res["losses"]):
        assert loss == pytest.approx(clean["losses"][step], rel=1e-6)


def test_data_parallel_one_rank_is_the_plain_run(tmp_path):
    """``--data-parallel 1``: a gloo group of one in this process, the
    same numbers as the run without a mesh."""
    plain = train.main(_argv(tmp_path / "a", steps=2))
    one = train.main(_argv(tmp_path / "b", "--data-parallel", "1", steps=2))
    np.testing.assert_allclose(one["losses"], plain["losses"], rtol=1e-6)
    np.testing.assert_allclose([float(g) for g in one["grad_norms"]],
                               [float(g) for g in plain["grad_norms"]],
                               rtol=1e-6)
    assert one["optimizer"] is not None
    assert not dist.is_initialized()


def test_data_parallel_refuses_what_it_cannot_run(tmp_path):
    with pytest.raises(ValueError, match="does not split"):
        train.main(_argv(tmp_path, "--data-parallel", "3"))
    with pytest.raises(ValueError, match=">= 1"):
        train.main(_argv(tmp_path, "--data-parallel", "0"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(["--arch", "llama3.2-3b", "--reduced",
                        "--data-parallel", "2"])
    elif torch.cuda.device_count() < 64:
        with pytest.raises(RuntimeError, match="needs 64 cards"):
            train.main(["--arch", "llama3.2-3b", "--reduced", "--batch",
                        "64", "--data-parallel", "64"])
