"""The port's moe_gmm and flash_attention ops, their selector-side helpers
and the MoE decode loop, held against the JAX package with the same
numpy-seeded inputs: ``route_and_pad`` bit for bit, the Eq. 5 imbalance,
the tile rule and the routing fingerprint key, the ``ScheduleCache``
scenario of the facade tests, the grouped GEMM and attention against the
JAX facade's ``jnp`` and ``interpret`` backends at the reference's
tolerances, the registry, the decode loop's tile choices and hit rates,
and the device guards. The kernels themselves run on the card in
``test_torch_cuda.py``."""
import dataclasses
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import TPU_V4, TPU_V5E
from repro.core.autotune import select_moe_block_size as jselect
from repro.core.metrics import partition_imbalance as jimbalance
from repro.kernels import flash_attention as jflash
from repro.kernels import moe_gmm as jmoe
from repro.selector import ScheduleCache as JScheduleCache
from repro.selector.fingerprint import routing_fingerprint as jrouting_fp
from repro.sparse import moe_tile_schedule as jmoe_tile_schedule
from repro.sparse import plan as jplan
from repro.sparse.resilience import GuardedExecutor
from repro_torch.core import (H100_SXM, Schedule, partition_imbalance,
                              select_moe_block_size)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_cuda,
                                                 ref_attention)
from repro_torch.kernels.flash_attention.ref import split_tf32, to_tf32
from repro_torch.kernels.moe_gmm import (live_row_ends, moe_gmm,
                                         moe_gmm_cuda, ref_gmm,
                                         route_and_pad)
from repro_torch.kernels.moe_gmm.kernel import computed_rows
from repro_torch.selector import ScheduleCache, routing_fingerprint
from repro_torch.serving import decode_moe_ticks
from repro_torch.sparse import GuardedExecutor as TGuardedExecutor
from repro_torch.sparse import (PreparedStore, get_op, launch_count,
                                list_ops, moe_tile_schedule, plan,
                                reset_counters)

CPU = "cpu"
ROOT = Path(__file__).resolve().parents[1]
TOL = 2e-4            # the reference's own (tests/test_kernels.py)
# the JAX platforms' names on the port's H100 record: the tile rule and the
# fingerprint read only the name
V5E = dataclasses.replace(H100_SXM, name=TPU_V5E.name)
V4 = dataclasses.replace(H100_SXM, name=TPU_V4.name)

HISTOGRAMS = [np.full(8, 100.0), np.array([600.0] + [10.0] * 7),
              np.array([1.0, 1, 1, 1, 0, 0, 0, 0]), np.array([4.0] + [0] * 7),
              np.array([2.0, 0, 1, 0, 1, 0, 0, 0]), np.zeros(8),
              np.array([1507.0, 753, 502, 377, 301, 251, 215, 188]),
              np.array([3.0, 5.0, 0.0])]


def _routed(t, k, n, e, tm, seed, drop_last=False):
    """Tokens routed by the same seeded draw for both packages; the last
    expert gets no tokens when ``drop_last``."""
    rng = np.random.default_rng(seed)
    tokens = rng.standard_normal((t, k)).astype(np.float32)
    eot = rng.integers(0, e - 1 if drop_last else e, t)
    w = rng.standard_normal((e, k, n)).astype(np.float32)
    return tokens, eot, w


# ------------------------------------------------------------ host helpers

@pytest.mark.parametrize("t,k,e,tm,drop_last", [
    (200, 64, 3, 32, False), (200, 64, 3, 64, False), (133, 8, 4, 32, True),
    (5, 16, 8, 64, False), (4, 32, 8, 128, True), (1, 8, 2, 256, False),
    (0, 8, 3, 32, False)])
def test_route_and_pad_bit_for_bit(t, k, e, tm, drop_last):
    tokens, eot, _ = _routed(t, k, 4, e, tm, seed=t + e, drop_last=drop_last)
    got = route_and_pad(tokens, eot, e, tile_m=tm)
    want = jmoe.route_and_pad(tokens, eot, e, tile_m=tm)
    for g, w_ in zip(got, want):
        assert g.dtype == w_.dtype and g.shape == w_.shape
        assert np.array_equal(g, w_)
    # every expert, an empty one too, owns at least one tile
    assert set(got[1].tolist()) == set(range(e))


@pytest.mark.parametrize("i", range(len(HISTOGRAMS)))
@pytest.mark.parametrize("n_parts", [1, 3, 8])
def test_partition_imbalance_equal(i, n_parts):
    h = HISTOGRAMS[i]
    assert partition_imbalance(h, n_parts) == jimbalance(h, n_parts)


@pytest.mark.parametrize("i", range(len(HISTOGRAMS)))
def test_select_moe_block_size_equal(i):
    h = HISTOGRAMS[i]
    assert select_moe_block_size(h, 512, V5E) == jselect(h, 512, TPU_V5E)


@pytest.mark.parametrize("i", range(len(HISTOGRAMS)))
@pytest.mark.parametrize("d_model", [256, 6144])
@pytest.mark.parametrize("platform", ["tpu_v5e", "h100_sxm", ""])
def test_routing_fingerprint_key_equal(i, d_model, platform):
    got = routing_fingerprint(HISTOGRAMS[i], d_model, platform)
    want = jrouting_fp(HISTOGRAMS[i], d_model, platform)
    assert got.key == want.key
    assert got.canonical == want.canonical
    assert (got.shape, got.nnz) == (want.shape, want.nnz)


def test_moe_tile_schedule_cache_scenario_matches_jax():
    """``tests/test_sparse_api.py``'s scenario on both packages: the same
    tiles, hits and entries, and no hit across platforms."""
    cache, jcache = ScheduleCache(), JScheduleCache()
    balanced = np.full(8, 100.0)
    hot = np.array([600.0] + [10.0] * 7)
    steps = [(balanced, V5E, TPU_V5E), (hot, V5E, TPU_V5E),
             (balanced, V5E, TPU_V5E), (balanced, V4, TPU_V4)]
    for counts, p, jp in steps:
        s = moe_tile_schedule(counts, 512, p, cache=cache)
        js = jmoe_tile_schedule(counts, 512, jp, cache=jcache)
        assert dataclasses.asdict(s) == dataclasses.asdict(js)
        tel, jtel = cache.telemetry(), jcache.telemetry()
        for key in tel:
            assert tel[key] == jtel[key], key
    assert cache.telemetry()["hits"] == 1
    assert cache.telemetry()["entries"] == 3
    assert cache.context == jcache.context == "moe_gmm"


def test_schedule_cache_lru_collision_and_context_like_jax():
    caches = (ScheduleCache(capacity=2), JScheduleCache(capacity=2))
    fps = [(routing_fingerprint(h, 64, "p"), jrouting_fp(h, 64, "p"))
           for h in HISTOGRAMS[:3]]
    sched = Schedule("bsr", 64, 1.0)
    for (fp, jfp) in fps:
        caches[0].put(fp, sched, "rule")
        caches[1].put(jfp, sched, "rule")
    for c, i in ((caches[0], 0), (caches[1], 1)):
        assert c.get(fps[0][i]) is None          # evicted (LRU, capacity 2)
        assert c.get(fps[2][i]).block_size == 64
        forged = dataclasses.replace(fps[2][i], nnz=fps[2][i].nnz + 1)
        assert c.get(forged) is None             # same key, other vector
        c.context = "other"
        assert c.get(fps[2][i]) is None          # put under another context
    tel, jtel = caches[0].telemetry(), caches[1].telemetry()
    for key in tel:
        assert tel[key] == jtel[key], key
    assert tel["evictions"] == 1 and tel["collisions"] == 1
    assert tel["context_misses"] == 1 and tel["hits"] == 1


def test_schedule_cache_persistence_round_trip(tmp_path):
    """The decode cache persists: flushed entries reload in LRU order
    under their context, each checked by its crc32, and serve hits."""
    path = str(tmp_path / "moe_cache.json")
    cache = ScheduleCache(path=path, capacity=4)
    p = H100_SXM
    scheds = [moe_tile_schedule(np.asarray(h, np.float64), 512, p,
                                cache=cache) for h in HISTOGRAMS]
    assert cache.flush()
    again = ScheduleCache(path=path, capacity=4)
    assert len(again) == len(cache) == min(len(HISTOGRAMS), 4)
    assert again.telemetry()["corrupt_entries"] == 0
    again.context = "moe_gmm"
    for h, s in list(zip(HISTOGRAMS, scheds))[-len(again):]:
        assert moe_tile_schedule(np.asarray(h, np.float64), 512, p,
                                 cache=again) == s
    assert again.telemetry()["hits"] == len(again)


# ------------------------------------------------------------------ moe_gmm

MOE_SHAPES = [  # (T, K, N, E, tm, tile_n, tile_k): tests/test_kernels.py
    (200, 64, 96, 3, 32, 32, 32),    # and tests/test_sparse_api.py
    (200, 64, 96, 3, 64, 32, 32),
    (160, 32, 48, 3, 32, 16, 16)]


@pytest.mark.parametrize("shape", MOE_SHAPES)
@pytest.mark.parametrize("backend", ["jnp", "interpret"])
def test_moe_plain_matches_jax(shape, backend):
    t, k, n, e, tm, tn, tk = shape
    tokens, eot, w = _routed(t, k, n, e, tm, seed=t + tm)
    x, te, inv = route_and_pad(tokens, eot, e, tile_m=tm)
    want = np.asarray(jplan("moe_gmm", (te,), tile_m=tm, tile_n=tn,
                            tile_k=tk, backend=backend).execute(x, w))
    p = plan("moe_gmm", (te,), tile_m=tm, tile_n=tn, tile_k=tk, device=CPU)
    got = p.execute(x, w)
    assert got.dtype == torch.float32 and p.backend == "torch"
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    # the shim and the wrapper's CPU path are the same function
    np.testing.assert_array_equal(
        moe_gmm(te, x, w, tile_m=tm, tile_n=tn, tile_k=tk,
                device=CPU).numpy(), got.numpy())
    np.testing.assert_array_equal(
        moe_gmm_cuda(torch.as_tensor(te), torch.as_tensor(x),
                     torch.as_tensor(w), tile_m=tm, tile_n=tn,
                     tile_k=tk).numpy(), got.numpy())
    valid = inv >= 0
    expect = np.einsum("mk,mkn->mn", tokens[inv[valid]], w[eot[inv[valid]]])
    np.testing.assert_allclose(got.numpy()[valid], expect, rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("dtype,tol", [("float32", TOL), ("bfloat16", 5e-2)])
def test_moe_dtypes_match_jax(dtype, tol):
    """``test_moe_gmm_dtypes``: bfloat16 x and w, float32 out, scaled by
    max|ref|."""
    t, k, n, e, tm = 128, 32, 64, 2, 32
    tokens, eot, w = _routed(t, k, n, e, tm, seed=7)
    x, te, inv = route_and_pad(tokens, eot, e, tile_m=tm)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = getattr(torch, dtype)
    want = np.asarray(jplan("moe_gmm", (te,), tile_m=tm, tile_n=32,
                            tile_k=32, backend="interpret").execute(
        jnp.asarray(x, jd), jnp.asarray(w, jd)), dtype=np.float32)
    got = plan("moe_gmm", (te,), tile_m=tm, tile_n=32, tile_k=32,
               device=CPU).execute(torch.as_tensor(x).to(td),
                                   torch.as_tensor(w).to(td))
    assert got.dtype == torch.float32
    valid = inv >= 0
    expect = np.einsum("mk,mkn->mn", tokens[inv[valid]], w[eot[inv[valid]]])
    scale = np.abs(expect).max()
    np.testing.assert_allclose(got.numpy()[valid] / scale, expect / scale,
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(got.numpy() / scale, want / scale, rtol=tol,
                               atol=tol)


def test_moe_tiling_contract_and_guards():
    x = np.zeros((64, 32), np.float32)
    w = np.zeros((2, 32, 48), np.float32)
    te = np.zeros(2, np.int32)
    with pytest.raises(ValueError, match="must divide by"):
        plan("moe_gmm", (te,), tile_m=32, device=CPU).execute(x, w)
    with pytest.raises(ValueError, match="must divide by"):
        moe_gmm_cuda(torch.as_tensor(te), torch.as_tensor(x),
                     torch.as_tensor(w), tile_m=32, tile_n=32, tile_k=32)
    with pytest.raises(ValueError, match="tile experts"):
        moe_gmm_cuda(torch.as_tensor(te[:1]), torch.as_tensor(x),
                     torch.as_tensor(w), tile_m=32, tile_n=16, tile_k=16)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        plan("moe_gmm", (te,), tile_m=32, backend="cuda", device=CPU)
    for bad in ([0, 2], [-1, 0]):
        with pytest.raises(ValueError, match=r"must lie in \[0, 2\)"):
            plan("moe_gmm", (np.array(bad, np.int32),), tile_m=32,
                 tile_n=16, tile_k=16, device=CPU).execute(x, w)


def test_moe_plan_keeps_device_weights_and_store_key():
    """The planned tile experts are cached per (bytes, device); a float32
    weight tensor on the plan's device is used without a copy."""
    from repro_torch.sparse import ops_builtin
    w = torch.zeros((2, 32, 32))
    assert ops_builtin._as_operand(w, torch.device(CPU)) is w
    wb = w.to(torch.bfloat16)
    assert ops_builtin._as_operand(wb, torch.device(CPU)) is wb
    assert ops_builtin._as_operand(w.double(), torch.device(CPU)).dtype \
        == torch.float32
    store = PreparedStore()
    te = np.array([0, 1], np.int32)
    p1 = plan("moe_gmm", (te,), tile_m=32, store=store, device=CPU)
    p2 = plan("moe_gmm", (te,), tile_m=64, store=store, device=CPU)
    assert p1.operands[0] is p2.operands[0]
    (key,) = store._entries
    assert key[0] == "moe_gmm" and key[-1] == CPU
    tel = store.telemetry()
    assert (tel["hits"], tel["misses"]) == (1, 1)


@pytest.mark.parametrize("t,k,e,tm,drop_last", [
    (200, 64, 3, 32, False), (133, 8, 4, 64, True), (5, 16, 8, 128, False),
    (300, 32, 2, 256, True), (0, 8, 3, 32, False)])
def test_live_row_ends_match_route_and_pad(t, k, e, tm, drop_last):
    """On routed tokens, each tile's live rows end after its last token
    (``route_and_pad``'s inverse index), 0 for a tile with none; a pad row
    that holds a value or a NaN is live, a -0.0 one is not."""
    tokens, eot, _ = _routed(t, k, 4, e, tm, seed=t + tm, drop_last=drop_last)
    x, te, inv = route_and_pad(tokens, eot, e, tile_m=tm)
    real = (inv >= 0).reshape(-1, tm)
    want = np.where(real.any(axis=1),
                    tm - np.argmax(real[:, ::-1], axis=1), 0)
    got = live_row_ends(torch.as_tensor(te), torch.as_tensor(x), tm)
    assert got.dtype == torch.int32 and got.tolist() == want.tolist()
    last = len(te) - 1                  # the last expert's last tile
    x[last * tm + tm - 3, 0] = -0.0
    assert live_row_ends(torch.as_tensor(te), torch.as_tensor(x),
                         tm).tolist() == want.tolist()
    for value in (1e-30, np.nan):
        xv = x.copy()
        xv[last * tm + tm - 3, k - 1] = value
        got = live_row_ends(torch.as_tensor(te), torch.as_tensor(xv), tm)
        assert got.tolist() == want.tolist()[:-1] + [tm - 2]


def _zero_row_product(w_e):
    """sum_k 0 * w_e[k, n]: NaN where column n holds a NaN or an Inf."""
    return np.where(np.isfinite(w_e).all(axis=0), 0.0, np.nan)


@pytest.mark.parametrize("backend", ["jnp", "interpret"])
@pytest.mark.parametrize("tm", [32, 64])
def test_pad_rows_get_the_zero_row_product(backend, tm):
    """The rule the CUDA kernel rests on: with a NaN and +-Inf in w, every
    pad row of an expert's tiles is that expert's closed-form zero-row
    product (NaN in the non-finite columns, zero elsewhere), in the JAX
    facade and in the port's plain path alike; an empty expert's too. Both
    NaN guards are off, so the backend asked for is the one that runs."""
    t, k, n, e = 90, 32, 48, 4
    tokens, eot, w = _routed(t, k, n, e, tm, seed=11, drop_last=True)
    w[0, 3, 5] = np.nan
    w[1, 7, 9], w[1, 8, 10] = np.inf, -np.inf
    w[3, 0, 40] = np.inf                   # the empty expert
    x, te, inv = route_and_pad(tokens, eot, e, tile_m=tm)
    want = np.asarray(jplan(
        "moe_gmm", (te,), tile_m=tm, tile_n=16, tile_k=16, backend=backend,
        executor=GuardedExecutor(nan_guard=False)).execute(x, w))
    got = plan("moe_gmm", (te,), tile_m=tm, tile_n=16, tile_k=16,
               device=CPU, executor=TGuardedExecutor(nan_guard=False)
               ).execute(x, w).numpy()
    tile_of_row = np.repeat(te, tm)
    pad = inv < 0
    assert pad[tile_of_row == 3].all()
    for out in (want, got):
        for r in np.flatnonzero(pad):
            z = _zero_row_product(w[tile_of_row[r]])
            np.testing.assert_array_equal(out[r], z)
        assert np.isnan(out[pad & (tile_of_row == 1)][:, [9, 10]]).all()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))


@pytest.mark.parametrize("live,tile_m,rows", [
    ([0, 4, 5, 16], 128, 4 + 4 + 8 + 16), ([17, 64, 65, 128], 128,
                                            64 + 64 + 128 + 128),
    ([200, 256, 0], 256, 256 + 256 + 4), ([20, 32], 32, 32 + 32)])
def test_computed_rows_follow_the_kernel_dispatch(live, tile_m, rows):
    assert computed_rows(live, tile_m) == rows


# ---------------------------------------------------------- flash_attention

FLASH_GRID = [(128, 32, 32, 32), (256, 64, 64, 128), (128, 128, 128, 64)]


@pytest.mark.parametrize("s,d,bq,bk", FLASH_GRID)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_jax(s, d, bq, bk, causal):
    """``test_flash_attention_allclose``: the port against the Pallas body
    in interpret mode and against the exact-softmax reference."""
    rng = np.random.default_rng(s + d)
    q, k, v = (rng.standard_normal((2, s, d)).astype(np.float32)
               for _ in range(3))
    want_i = np.asarray(jplan("flash_attention", (), causal=causal,
                              block_q=bq, block_k=bk,
                              backend="interpret").execute(q, k, v))
    want_r = np.asarray(jflash.ref_attention(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v), causal=causal))
    p = plan("flash_attention", (), causal=causal, block_q=bq, block_k=bk,
             device=CPU)
    got = p.execute(q, k, v)
    assert got.dtype == torch.float32 and p.backend == "torch"
    np.testing.assert_allclose(got.numpy(), want_i, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), want_r, rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(
        flash_attention(q, k, v, causal=causal, block_q=bq, block_k=bk,
                        device=CPU).numpy(), got.numpy())


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 3e-2)])
def test_flash_dtypes_match_jax(dtype, tol):
    """``test_flash_attention_dtypes``: bfloat16 q, k, v against the
    float32 reference."""
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal((2, 128, 64)).astype(np.float32)
               for _ in range(3))
    td = getattr(torch, dtype)
    got = flash_attention_cuda(*(torch.as_tensor(t).to(td)
                                 for t in (q, k, v)),
                               causal=True, block_q=64, block_k=64)
    assert got.dtype == torch.float32
    want = np.asarray(jflash.ref_attention(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), causal=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want_i = np.asarray(jplan(
        "flash_attention", (), causal=True, block_q=64, block_k=64,
        backend="interpret").execute(*(jnp.asarray(t, jd)
                                       for t in (q, k, v))),
        dtype=np.float32)
    np.testing.assert_allclose(got.numpy(), want_i, rtol=tol, atol=tol)


def test_flash_contract_and_guards():
    q = np.zeros((2, 96, 32), np.float32)
    with pytest.raises(ValueError, match="must divide by"):
        plan("flash_attention", (), block_q=64, device=CPU).execute(q, q, q)
    with pytest.raises(ValueError, match="one shape"):
        plan("flash_attention", (), block_q=32, block_k=32,
             device=CPU).execute(q, q[:, :64], q)
    with pytest.raises(ValueError, match="no planned operands"):
        plan("flash_attention", (q,), device=CPU)


# ------------------------------------------ split TF32 (the kernel's math)

def test_to_tf32_rounds_like_cvt_rna():
    """Ten mantissa bits, to nearest with ties away from zero; the low 13
    bits of the result are zero and non-finite values pass."""
    x = torch.tensor([1.0, 1 + 2**-11, 1 + 3 * 2**-11, -(1 + 2**-11),
                      1 + 2**-12, -0.0, float("inf"), float("nan")])
    got = to_tf32(x)
    want = [1.0, 1 + 2**-10, 1 + 2**-9, -(1 + 2**-10), 1.0, -0.0,
            float("inf")]
    assert got[:7].tolist() == want and bool(got[7].isnan())
    assert bool(torch.signbit(got[5]))
    r = to_tf32(torch.randn(4096, generator=torch.Generator().manual_seed(0)))
    assert not bool((r.view(torch.int32) & 0x1FFF).any())


def test_split_tf32_keeps_about_fp32_precision():
    """hi + lo equals x to about 2^-22 relative, with both parts TF32."""
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(8192) * 1e3,
                        dtype=torch.float32)
    hi, lo = split_tf32(x)
    for part in (hi, lo):
        assert not bool((part.view(torch.int32) & 0x1FFF).any())
    err = ((hi.double() + lo.double()) - x.double()).abs()
    assert bool((err <= x.double().abs() * 2.0**-21).all())
    assert bool(((hi.double() - x.double()).abs() >= err).all())


def _float64_attention(q, k, v):
    q, k, v = q.double(), k.double(), v.double()
    s = q.shape[1]
    scores = q @ k.transpose(1, 2) / q.shape[-1] ** 0.5
    scores = scores.masked_fill(~torch.ones(s, s, dtype=torch.bool).tril(),
                                float("-inf"))
    return torch.softmax(scores, dim=-1) @ v


def _tf32_attention(q, k, v, passes):
    """Causal attention whose two products see their operands as the
    kernel's TF32 tensor cores do: hi.hi (one pass), or lo.hi + hi.lo +
    hi.hi (three); the products and sums in float64, so that only the
    operand rounding shows."""
    def product(a, b):
        (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)
        ah, al, bh, bl = (t.double() for t in (ah, al, bh, bl))
        return ah @ bh if passes == 1 else al @ bh + ah @ bl + ah @ bh
    s = q.shape[1]
    scores = product(q, k.transpose(1, 2)) / q.shape[-1] ** 0.5
    scores = scores.masked_fill(~torch.ones(s, s, dtype=torch.bool).tril(),
                                float("-inf"))
    return product(torch.softmax(scores, dim=-1).float(), v)


@pytest.mark.parametrize("magnitude", [1.0, 8.0])
def test_three_tf32_passes_keep_the_tolerance_one_misses(magnitude):
    """Why the kernel splits: at (2, 256, 128), causal, single-pass TF32
    misses 1e-4 * max|ref| against float64, three passes keep it. q and k
    scaled by 8 put the scores near +-60, the online rescale's case."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.as_tensor(rng.standard_normal((2, 256, 128)),
                               dtype=torch.float32) for _ in range(3))
    q, k = q * magnitude, k * magnitude
    ref = _float64_attention(q, k, v)
    scale = float(ref.abs().max())
    one, three = (float((_tf32_attention(q, k, v, p) - ref).abs().max())
                  / scale for p in (1, 3))
    assert one > 1e-4 > three
    assert three < 1e-5


# ------------------------------------------------------- registry, decode

def test_registry_lists_six_ops():
    assert list_ops() == ("flash_attention", "moe_gmm", "spadd", "spgemm",
                          "spmm", "spmv")
    assert get_op("moe_gmm").layouts == ("ell",)
    assert get_op("flash_attention").layouts == ("ell",)
    with pytest.raises(ValueError, match="layouts"):
        plan("moe_gmm", (np.zeros(2, np.int32),),
             schedule=Schedule("bsr", 16, 1.0, layout="sell",
                               slice_height=4), device=CPU)


@pytest.fixture(scope="module")
def serve_lm():
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        import serve_lm
    finally:
        sys.path.remove(str(ROOT / "examples"))
    return serve_lm


def test_decode_loop_matches_jax(serve_lm):
    """The JAX decode loop and the port's at d_model=256, d_ff=512: the
    same tile choices, cache and prepared-store hit rates and entries, and
    each tick's output within 2e-4 of the JAX facade's ``jnp`` plan on the
    same routed inputs."""
    n_ticks = 6
    want = serve_lm.decode_moe_ticks(n_ticks, d_model=256, d_ff=512)
    reset_counters()
    got = decode_moe_ticks(n_ticks, d_model=256, d_ff=512, platform=V5E,
                           device=CPU)
    assert launch_count("moe_gmm") == n_ticks
    assert got["ticks"] == want["ticks"]
    for key in ("cache_hit_rate", "cache_entries", "prep_hit_rate",
                "prep_entries"):
        assert got[key] == want[key], key
    assert got["cache_hit_rate"] > 0 and got["prep_hit_rate"] > 0
    w = np.random.default_rng(0).standard_normal((8, 256, 512)).astype(
        np.float32)
    for (x, te), (tm, _), out in zip(got["routed"], got["ticks"],
                                     got["outputs"]):
        ref = np.asarray(jplan("moe_gmm", (te,), tile_m=tm,
                               backend="jnp").execute(x, w))
        np.testing.assert_allclose(out.numpy(), ref, rtol=TOL, atol=TOL)


def test_decode_loop_uses_given_weights():
    w = torch.zeros((8, 128, 128))
    res = decode_moe_ticks(2, d_model=128, d_ff=128, w=w, device=CPU)
    assert all(float(o.abs().max()) == 0.0 for o in res["outputs"])
    assert [tm for tm, _ in res["ticks"]] == [
        r[0].shape[0] // 8 for r in res["routed"]]


def test_cuda_is_the_default_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    te = np.zeros(2, np.int32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        plan("moe_gmm", (te,), tile_m=32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        plan("flash_attention", ())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decode_moe_ticks(1, d_model=128, d_ff=128)
    q = torch.zeros((1, 128, 32))
    with pytest.raises(ValueError, match="one CUDA device"):
        flash_attention_cuda(q, q.to("meta"), q)
