"""The port's roofline (``repro_torch.roofline.{analysis,op_analysis}``) and
abstract specs (``repro_torch.launch.specs``) held against the JAX
package's on the CPU.

``roofline_terms`` against the reference's on the same counts (exactly),
the operator counter's FLOPs against ``analyze_hlo`` of the compiled
twin (a small program, then the reduced llama3.2-3b train step, where the
port recomputes one logits product under its loss checkpoints),
per-chip counting on a fake 16 x 16 mesh, and the abstract inputs of every
arch x shape against the reference's ``ShapeDtypeStruct``s.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.core.platforms import Platform as JPlatform
from repro.launch import specs as jspecs
from repro.models import Model as JModel
from repro.optim.adamw import AdamW as JAdamW
from repro.roofline.analysis import roofline_terms as jroofline_terms
from repro.roofline.hlo_analysis import HLOStats, analyze_hlo
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch.configs import SHAPES, ShapeConfig, get_config, list_archs
from repro_torch.core.platforms import H100_SXM
from repro_torch.launch import specs
from repro_torch.launch.sharding import reference_path
from repro_torch.models import Model
from repro_torch.optim import AdamW
from repro_torch.roofline import (OpCounter, OpStats, measure_step,
                                  roofline_terms)
from repro_torch.train import make_train_step

COLL = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
        "collective-permute")


def _stats(flops, hbm, coll):
    b = dict(zip(COLL, coll))
    n = {k: int(v > 0) for k, v in b.items()}
    return flops, hbm, b, n


# one stat set per bottleneck, at the H100's rates (989 TFLOP/s, 3.35 TB/s,
# 900 GB/s of links)
STAT_SETS = {
    "compute": _stats(4.0e15, 1.0e12, (1e10, 2e9, 3e9, 0.0, 0.0)),
    "memory": _stats(1.0e13, 8.0e11, (1e9, 0.0, 5e8, 0.0, 1e6)),
    "collective": _stats(1.0e12, 1.0e10, (4e10, 3e10, 2e10, 1e10, 5e9)),
}


@pytest.mark.parametrize("which", sorted(STAT_SETS))
def test_roofline_terms_equal_the_reference(which):
    flops, hbm, cb, cn = STAT_SETS[which]
    kw = dict(arch="llama3.2-3b", shape="train_4k", mesh_name="16x16",
              n_chips=256, memory_per_device=3.5e10,
              model_flops_global=7.9e17, model_bytes_global=2.5e12)
    ref = jroofline_terms(
        hlo_text="", cost={}, precomputed=HLOStats(flops, hbm, cb, cn),
        platform=JPlatform(**dataclasses.asdict(H100_SXM)), **kw)
    port = roofline_terms(stats=OpStats(flops, hbm, cb, cn), **kw)
    want = dataclasses.asdict(ref)
    del want["cost_analysis_flops"], want["cost_analysis_bytes"]
    assert dataclasses.asdict(port) == want
    assert port.bottleneck == which
    assert port.row() == ref.row()


def test_roofline_platform_is_the_h100():
    stats = OpStats(989e12, 3.35e12, {c: 0.0 for c in COLL},
                    {c: 0 for c in COLL})
    r = roofline_terms(arch="a", shape="s", mesh_name="1", n_chips=1,
                       stats=stats, memory_per_device=0.0,
                       model_flops_global=989e12)
    assert r.t_compute == 1.0 and r.t_memory == 1.0
    assert r.t_collective == 0.0 and r.useful_ratio == 1.0


# ------------------------------------------------------ FLOPs vs the HLO

def _jax_program(a, b, c, x, y, w, h0):
    h = a @ b                                    # (16, 64), k 32
    h = h @ c                                    # (16, 8), k 64
    z = jnp.tanh(h) @ c.T                        # (16, 64), k 8
    e = jnp.einsum("bij,bjk->bik", x, y)         # (4, 8, 8), k 16

    def body(carry, _):
        return jnp.tanh(carry @ w), None
    hs, _ = jax.lax.scan(body, h0, None, length=4)
    return z.sum() + e.sum() + hs.sum()


def _torch_program(a, b, c, x, y, w, h0):
    h = a @ b
    h = h @ c
    z = torch.tanh(h) @ c.T
    e = torch.einsum("bij,bjk->bik", x, y)
    hs = h0
    for _ in range(4):
        hs = torch.tanh(hs @ w)
    return z.sum() + e.sum() + hs.sum()


def test_counter_flops_equal_analyze_hlo_on_a_small_program():
    rng = np.random.default_rng(0)
    shapes = [(16, 32), (32, 64), (64, 8), (4, 8, 16), (4, 16, 8), (8, 8),
              (8, 8)]
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    hlo = jax.jit(_jax_program).lower(*arrs).compile().as_text()
    ref = analyze_hlo(hlo).flops
    port = measure_step(_torch_program, *map(torch.as_tensor, arrs)).flops
    want = 2 * (16 * 64 * 32 + 16 * 8 * 64 + 16 * 64 * 8 + 4 * 8 * 8 * 16
                + 4 * 8 * 8 * 8)
    assert port == ref == want


def _reference_train_flops(remat: str) -> float:
    cfg = jget_config("llama3.2-3b", reduced=True)
    model, opt = JModel(cfg), JAdamW(learning_rate=1e-3)
    step = jmake_train_step(model, opt, remat=remat, attn_chunk=64)
    params = model.abstract_params()
    batch = {"tokens": jax.ShapeDtypeStruct((2, 64), jnp.int32),
             "loss_mask": jax.ShapeDtypeStruct((2, 64), jnp.float32)}
    hlo = jax.jit(step).lower(params, jax.eval_shape(opt.init, params),
                              batch).compile().as_text()
    return analyze_hlo(hlo).flops


@pytest.mark.parametrize("remat,ref_flops", [("none", 171_966_464),
                                             ("dots_no_batch", 176_160_768)])
def test_train_step_flops_are_the_hlo_plus_one_logits_product(remat,
                                                               ref_flops):
    """The reference's compiled step and the port's eager step count the
    same dots, but the port's ``chunked_xent`` runs each chunk under
    ``torch.utils.checkpoint``, so its backward recomputes the logits:
    one more 2 * B * S * d_model * vocab_padded."""
    assert _reference_train_flops(remat) == ref_flops
    cfg = get_config("llama3.2-3b", reduced=True)
    model = Model(cfg, device="meta")
    step = make_train_step(model, AdamW(model.parameters()), remat=remat,
                           attn_chunk=64)
    _, _, batch = specs.train_abstract(model,
                                       ShapeConfig("t", 64, 2, "train"))
    port = measure_step(step, batch)
    extra = 2 * 2 * 64 * cfg.d_model * cfg.vocab_padded
    assert port.flops == ref_flops + extra
    assert port.total_collective_bytes == 0.0
    assert port.hbm_bytes > 0


# ------------------------------------------------------- per-chip counts

@pytest.fixture
def mesh16():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.mesh import make_production_mesh
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=256)
    try:
        yield make_production_mesh(device_type="cpu")
    finally:
        dist.destroy_process_group()


def test_counter_counts_per_chip_on_a_16x16_mesh(mesh16):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    def put(shape, pl):
        return distribute_tensor(torch.empty(shape, device="meta"), mesh16,
                                 pl, src_data_rank=None)

    m, k, n = 1024, 512, 2048
    glob = 2.0 * m * n * k
    x = put((m, k), [Shard(0), Replicate()])
    w = put((k, n), [Replicate(), Shard(1)])
    with OpCounter() as c:
        y = x @ w
    assert tuple(y.placements) == (Shard(0), Shard(1))
    assert c.flops == glob / 256
    assert c.stats().total_collective_bytes == 0.0

    xr, wr = (put((m, k), [Replicate(), Replicate()]),
              put((k, n), [Replicate(), Replicate()]))
    with OpCounter() as c:
        xr @ wr
    assert c.flops == glob

    with OpCounter() as c:
        full = x.redistribute(mesh16, [Replicate(), Replicate()])
    st = c.stats()
    assert tuple(full.placements) == (Replicate(), Replicate())
    assert st.collective_count["all-gather"] == 1
    assert st.collective_bytes["all-gather"] == m // 16 * k * 4
    assert st.total_collective_bytes == m // 16 * k * 4


def test_counter_skips_views_and_counts_operand_bytes():
    a = torch.ones(4, 8)
    with OpCounter() as c:
        b = a.view(8, 4).t()          # views move nothing
    assert c.hbm_bytes == 0.0 and b.shape == (4, 8)
    with OpCounter() as c:
        a + a                         # two reads, one write
    assert c.hbm_bytes == 3 * 4 * 8 * 4 and c.flops == 0.0


# ------------------------------------------------------------- the specs

def _unstacked(path, leaf):
    return leaf.shape[1:] if path[0] in ("blocks", "encoder") else leaf.shape


def _jax_leaves(tree):
    from repro.launch.sharding import _path_names
    return {_path_names(p): leaf
            for p, leaf in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("arch", list_archs())
def test_abstract_specs_have_the_reference_shapes(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    model, jmodel = Model(cfg, device="meta"), JModel(jcfg)
    jparams = _jax_leaves(jmodel.abstract_params())
    for name, shape in SHAPES.items():
        jshape = JSHAPES[name]
        params, opt, batch = specs.train_abstract(model, shape)
        jb = jspecs.batch_abstract(jcfg, jshape)
        assert set(batch) == set(jb)
        for k, t in batch.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(jb[k].shape)
            want = {"tokens": torch.int64, "loss_mask": torch.float32,
                    "audio_embed": torch.bfloat16}[k]
            assert t.dtype == want
        assert {reference_path(cfg, n) for n in params} == set(jparams)
        assert (sum(p.numel() for p in params.values())
                == sum(int(np.prod(j.shape)) for j in jparams.values()))
        for pname, p in params.items():
            leaf = jparams[reference_path(cfg, pname)]
            assert tuple(p.shape) == tuple(_unstacked(
                reference_path(cfg, pname), leaf)), pname
            assert opt.m[pname].shape == p.shape
            assert opt.v[pname].dtype == torch.float32
        assert opt.step == 0
        pp, pb = specs.prefill_abstract(model, shape)
        assert pp.keys() == params.keys() and pb.keys() == batch.keys()
        if shape.kind != "decode":
            continue
        _, cache, token, pos = specs.decode_abstract(model, shape)
        _, jcache, jtoken, _ = jspecs.decode_abstract(jmodel, jshape)
        assert tuple(token.shape) == tuple(jtoken.shape)
        assert token.dtype == torch.int64 and pos == shape.seq_len - 1
        assert len(cache) == cfg.n_layers
        for layer, c in enumerate(cache):
            jc = jcache[layer % cfg.pattern_len]
            assert c.keys() == jc.keys()
            for part, leaves in c.items():
                assert leaves.keys() == jc[part].keys()
                for n, t in leaves.items():
                    j = jc[part][n]
                    assert tuple(t.shape) == tuple(j.shape[1:]), (
                        name, layer, part, n)
                    assert str(t.dtype).split(".")[-1] == str(j.dtype)
                    assert t.device.type == "meta"


def test_specs_need_a_meta_model():
    with pytest.raises(ValueError, match="meta"):
        specs.prefill_abstract(Model(get_config("llama3.2-3b",
                                                reduced=True),
                                     device="cpu"), SHAPES["train_4k"])
