"""The port's plan/execute facade (``repro_torch.sparse``) held against the
JAX package's (``repro.sparse``, ``backend="jnp"``): containers leaf for
leaf, plan outputs over ell/sell/dense, one launch per bucket, the
prepared-store warm path, the converter from JAX leaves, and the device
guards (the card is the default and nothing falls back to the CPU)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import CSR as JCSR
from repro.core.autotune import Schedule as JSchedule
from repro.core.synthetic import GENERATORS as JGENERATORS
from repro.sparse import LAYOUT_FIELDS as JLAYOUT_FIELDS
from repro.sparse import SparseTensor as JSparseTensor
from repro.sparse import plan as jplan
from repro.sparse import plan_bucket as jplan_bucket
from repro_torch import convert
from repro_torch.core import CSR, GENERATORS, Schedule, gen_zipf, spmv_oracle
from repro_torch.obs import Tracer, default_registry, install_tracer
from repro_torch.sparse import (PreparedStore, SparseTensor, content_key,
                                launch_count, plan, plan_bucket,
                                reset_counters)

CPU = "cpu"


def _pair(csr: CSR) -> JCSR:
    """The same matrix as the JAX package's CSR."""
    return JCSR(csr.row_ptrs, csr.col_idxs, csr.nnz_vals, csr.shape)


def _schedules(layout, bs=32):
    if layout == "dense":
        return Schedule("dense", bs, 1.0), JSchedule("dense", bs, 1.0)
    kw = dict(layout="sell", slice_height=4) if layout == "sell" else {}
    return Schedule("bsr", bs, 1.0, **kw), JSchedule("bsr", bs, 1.0, **kw)


def _tol(layout):
    return 1e-4 if layout == "sell" else 2e-5


def test_generators_are_the_reference_generators():
    for name in ("spatial", "exponential"):
        a, b = GENERATORS[name](300, seed=4), JGENERATORS[name](300, seed=4)
        for f in ("row_ptrs", "col_idxs", "nnz_vals"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("layout", ["ell", "sell"])
@pytest.mark.parametrize("shape_bucket", [False, True])
def test_from_csr_leaves_equal_jax_container(layout, shape_bucket):
    A = gen_zipf(300, seed=3)
    lay = None if layout == "ell" else "sell"
    st = SparseTensor.from_csr(A, block_size=32, layout=lay, slice_height=4,
                               shape_bucket=shape_bucket, device=CPU)
    jst = JSparseTensor.from_csr(_pair(A), block_size=32, layout=lay,
                                 slice_height=4, shape_bucket=shape_bucket)
    for name in JLAYOUT_FIELDS[layout]:
        got, want = st.arrays[name].numpy(), np.asarray(jst.arrays[name])
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    for f in ("layout", "shape", "block_size", "n_block_rows",
              "slice_height", "sigma"):
        assert getattr(st.meta, f) == getattr(jst.meta, f), f
    assert st.true_shape == jst.true_shape
    assert st._zero_idx == jst._zero_idx
    if layout == "sell":
        ptr = st.arrays["cell_ptr"].numpy()
        live = SparseTensor.build_container(A, st.meta.schedule).n_cells
        assert ptr[0] == 0 and ptr[-1] == live
        assert (np.diff(ptr) >= 0).all()


@pytest.mark.parametrize("gen", ["zipf", "spatial"])
@pytest.mark.parametrize("layout", ["ell", "sell", "dense"])
@pytest.mark.parametrize("op", ["spmv", "spmm"])
def test_plan_matches_jax_plan(gen, layout, op):
    A = gen_zipf(256, seed=1) if gen == "zipf" else GENERATORS[gen](256, 2)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((256, 5) if op == "spmm" else 256).astype(
        np.float32)
    s, js = _schedules(layout)
    y = plan(op, (A,), schedule=s, device=CPU).execute(x).numpy()
    jy = np.asarray(jplan(op, (_pair(A),), schedule=js,
                          backend="jnp").execute(jnp.asarray(x)))
    assert y.shape == jy.shape
    np.testing.assert_allclose(y, jy, rtol=_tol(layout), atol=_tol(layout))


@pytest.mark.parametrize("layout", ["ell", "sell"])
@pytest.mark.parametrize("keyed", [False, True])
@pytest.mark.parametrize("op", ["spmv", "spmm"])
def test_bucket_of_3_is_one_launch(layout, keyed, op):
    """Three distinct members, one launch (the member on the grid), outputs
    equal to the JAX bucket's and to per-member plans. ``keyed`` takes the
    store's resident-stacking path, else the host stacking path."""
    mats = [gen_zipf(192 + 32 * i, seed=20 + i) for i in range(3)]
    rng = np.random.default_rng(6)
    xs = [rng.standard_normal((m.shape[1], 3) if op == "spmm"
                              else m.shape[1]).astype(np.float32)
          for m in mats]
    s, js = _schedules(layout)
    singles = [plan(op, (m,), schedule=s, device=CPU).execute(x).numpy()
               for m, x in zip(mats, xs)]
    kw = (dict(store=PreparedStore(), member_keys=[content_key(m)
                                                   for m in mats])
          if keyed else {})
    reset_counters()
    bucket = plan_bucket(op, mats, s, device=CPU, **kw)
    assert bucket.n_members == 3
    ys = bucket.execute(xs)
    assert launch_count(op) == 1
    jys = jplan_bucket(op, [_pair(m) for m in mats], js,
                       backend="jnp").execute(xs)
    for y, y1, jy in zip(ys, singles, jys):
        np.testing.assert_allclose(y.numpy(), y1, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy),
                                   rtol=_tol(layout), atol=_tol(layout))
    bucket.execute(xs)
    assert launch_count(op) == 2


def test_content_pure_bucket_is_one_multi_rhs_launch():
    """Four requests on one matrix: one launch of the single-request
    container (warm from the solo plan: no second build)."""
    A = gen_zipf(300, seed=8)
    ck = content_key(A)
    store = PreparedStore()
    s, _ = _schedules("sell")
    rng = np.random.default_rng(7)
    xs = [rng.standard_normal(300).astype(np.float32) for _ in range(4)]
    solo = plan("spmv", (A,), schedule=s, store=store, device=CPU)
    puts = store.puts
    reset_counters()
    bucket = plan_bucket("spmv", [A] * 4, s, store=store, device=CPU,
                         member_keys=[ck] * 4)
    ys = bucket.execute(xs)
    assert launch_count("spmv") == 1
    assert store.puts == puts                     # reused the solo container
    assert bucket.operands[0] is solo.operands[0]
    for y, x in zip(ys, xs):
        np.testing.assert_allclose(y.numpy(), spmv_oracle(A, x), rtol=1e-4,
                                   atol=1e-4)


def test_bucket_rejects_mixed_rhs_and_layouts():
    mats = [gen_zipf(128, seed=50), gen_zipf(128, seed=51)]
    s, _ = _schedules("ell")
    bucket = plan_bucket("spmv", mats, s, device=CPU)
    with pytest.raises(ValueError, match="homogeneous runtime inputs"):
        bucket.execute([np.zeros(128, np.float32),
                        np.zeros((128, 3), np.float32)])
    sell = SparseTensor.from_csr(mats[0], layout="sell", block_size=32,
                                 device=CPU)
    with pytest.raises(ValueError, match="bucket member 0"):
        plan_bucket("spmv", [sell, mats[1]], s, device=CPU)


def test_store_warm_hit_skips_prep(monkeypatch):
    A = gen_zipf(256, seed=9)
    builds = []
    real = SparseTensor.build_container

    def counting(*a, **k):
        builds.append(1)
        return real(*a, **k)

    monkeypatch.setattr(SparseTensor, "build_container",
                        staticmethod(counting))
    store = PreparedStore()
    s, _ = _schedules("ell")
    x = np.ones(256, np.float32)
    y1 = plan("spmv", (A,), schedule=s, store=store, device=CPU).execute(x)
    assert len(builds) == 1 and store.misses == 1
    y2 = plan("spmv", (A,), schedule=s, store=store, device=CPU).execute(x)
    assert len(builds) == 1 and store.hits == 1   # warm: no host prep
    torch.testing.assert_close(y1, y2)


def test_store_budget_and_index_persistence(tmp_path):
    store = PreparedStore(byte_budget=3000)
    store.put(("a",), torch.zeros(250))           # 1000 B
    store.put(("b",), torch.zeros(250))
    assert not store.put(("huge",), torch.zeros(1000))
    store.put(("c",), torch.zeros(500))           # 2000 B: evicts "a"
    tel = store.telemetry()
    assert tel["rejected"] == 1 and tel["evictions"] == 1
    assert ("a",) not in store and ("c",) in store
    assert store.bytes_in_use == 3000
    path = str(tmp_path / "index.json")
    assert store.save(path)
    fresh = PreparedStore()
    prior = fresh.load(path)
    assert len(prior["entries"]) == 2
    assert fresh.telemetry()["prior_entries"] == 2.0
    text = open(path).read().replace('"nbytes": 1000', '"nbytes": 1001')
    open(path, "w").write(text)
    assert len(PreparedStore().load(path)["entries"]) == 1   # crc caught it


@pytest.mark.parametrize("layout", ["ell", "sell"])
def test_convert_from_jax_leaves_gives_jax_output(layout):
    A = gen_zipf(320, seed=11)
    lay = None if layout == "ell" else "sell"
    jst = JSparseTensor.from_csr(_pair(A), block_size=32, layout=lay,
                                 slice_height=4, shape_bucket=True)
    meta = dataclasses.asdict(jst.meta)
    meta["true_shape"] = jst.true_shape
    arrays = {k: np.asarray(v) for k, v in jst.arrays.items()}
    st = convert.sparse_tensor_from_arrays(layout, meta, arrays, device=CPU)
    assert st.meta.schedule == st.schedule and st.true_shape == (320, 320)
    x = np.random.default_rng(2).standard_normal(320).astype(np.float32)
    y = plan("spmv", (st,), device=CPU).execute(x).numpy()
    jy = np.asarray(jplan("spmv", (jst,), backend="jnp").execute(x))
    np.testing.assert_allclose(y, jy, rtol=_tol(layout), atol=_tol(layout))
    csr = convert.csr_from_arrays(A.row_ptrs, A.col_idxs, A.nnz_vals,
                                  A.shape)
    assert content_key(csr) == content_key(A)


def test_launch_is_timed_and_traced():
    reg = default_registry()
    before = reg.histogram("launch_ms.spmm")
    n0 = before.count if before is not None else 0
    tracer = install_tracer(Tracer())
    try:
        p = plan("spmm", (gen_zipf(128, seed=1),),
                 schedule=_schedules("ell")[0], device=CPU)
        p.execute(np.ones((128, 2), np.float32))
    finally:
        install_tracer(None)
    assert reg.histogram("launch_ms.spmm").count == n0 + 1
    assert p.last_measured_s is not None and p.last_measured_s >= 0
    counts = tracer.counts()
    assert counts.get("prep") == 1 and counts.get("launch") == 1
    launch = [e for e in tracer.events() if e["type"] == "launch"][0]
    assert launch["args"]["backend"] == "torch"
    assert launch["args"]["layout"] == "ell"


# -------------------------------------------------------------- guards

def test_card_is_the_default_device():
    """Without ``device=`` every entry point asks for the card; with no
    card it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    A = gen_zipf(64, seed=0)
    s, _ = _schedules("ell")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        plan("spmv", (A,), schedule=s)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        plan_bucket("spmv", [A, A], s)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SparseTensor.from_csr(A)


def test_cuda_backend_on_cpu_tensors_raises():
    A = gen_zipf(64, seed=0)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        plan("spmv", (A,), backend="cuda", device=CPU)
    st = SparseTensor.from_csr(A, block_size=32, device=CPU)
    p = plan("spmv", (st,), backend="torch", device=CPU)
    assert p.backend == "torch"
