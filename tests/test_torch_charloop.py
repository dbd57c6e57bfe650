"""The port's characterization loop (``repro_torch.core.charloop``), its
calibration report (``repro_torch.obs.report``) and its examples, held
against the JAX package's.

Parity: the corpus gives the same CSRs; ``build_slice`` the same features,
``X`` and targets (rtol 1e-12); ``characterize_slice`` the same CV scores
(rtol 1e-9) and the same importances in the same order; ``compare_platforms``
and ``grouped_importance`` the same answers over the JAX package's TPU
records carried across as ``Platform(**asdict(...))``, and over the port's
three NVIDIA records carried the other way (the tests import both
packages, the port does not): ``characterize_all`` over the port's
``PLATFORMS`` equals the reference's over the same three records. Then the
twins of ``tests/test_charloop.py`` on ``H100_SXM`` (the cross-platform
ones on the converted TPU records and on the port's three), the twin of
``test_system::test_charloop_reproduces_paper_findings``, the
architecture-induced split on that corpus, the report on traces written
by either package, and the examples on the CPU.
"""
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.core as J
from repro.core import charloop as jcharloop
from repro.obs import Tracer as JTracer
from repro.obs import install_tracer as jinstall_tracer
from repro.obs import report as jreport
from repro.sparse import plan as jplan
from repro.sparse import resilience as jres
from repro_torch import core as T
from repro_torch.core import (A100_SXM, H100_SXM, L40S, PLATFORMS,
                              Schedule, ScheduleTuner, build_slice,
                              characterize_all,
                              characterize_slice, compare_platforms, corpus,
                              grouped_importance, run_spadd_model,
                              run_spgemm_model, run_spmv_model,
                              select_moe_block_size, top_feature)
from repro_torch.obs import Tracer, install_tracer
from repro_torch.obs import report
from repro_torch.obs.report import load_launches, summarize
from repro_torch.sparse import plan, reset_resilience

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
KERNELS = ("spmv", "spgemm", "spadd")
# the JAX package's TPU records, carried across as data
V4 = T.Platform(**dataclasses.asdict(J.TPU_V4))
V5E = T.Platform(**dataclasses.asdict(J.TPU_V5E))
V5P = T.Platform(**dataclasses.asdict(J.TPU_V5P))
# the port's NVIDIA records, carried across to the reference as data
JH100 = J.Platform(**dataclasses.asdict(H100_SXM))
JA100 = J.Platform(**dataclasses.asdict(A100_SXM))
JL40S = J.Platform(**dataclasses.asdict(L40S))
JPLATFORMS = {n: J.Platform(**dataclasses.asdict(p))
              for n, p in PLATFORMS.items()}
SMALL = dict(n_matrices=18, n_min=256, n_max=512, seed=7)
MATS = corpus(**SMALL)
JMATS = J.corpus(**SMALL)


@pytest.fixture(autouse=True)
def _fresh_resilience():
    reset_resilience()
    jres.reset_resilience()
    yield
    reset_resilience()
    jres.reset_resilience()


def _pair(name):
    """(port platform, JAX platform) of one record."""
    return {"h100": (H100_SXM, JH100), "a100": (A100_SXM, JA100),
            "l40s": (L40S, JL40S), "v4": (V4, J.TPU_V4),
            "v5e": (V5E, J.TPU_V5E)}[name]


# ------------------------------------------------------------------ parity

def test_corpus_like_jax():
    assert len(MATS) == len(JMATS)
    for (n, d, A), (jn, jd, JA) in zip(MATS, JMATS):
        assert (n, d, A.shape) == (jn, jd, JA.shape)
        for f in ("row_ptrs", "col_idxs", "nnz_vals"):
            a, b = getattr(A, f), getattr(JA, f)
            assert a.dtype == b.dtype, (n, f)
            np.testing.assert_array_equal(a, b, err_msg=f"{n} {f}")


@pytest.mark.parametrize("platform", ["h100", "v5e", "a100", "l40s"])
@pytest.mark.parametrize("kernel", KERNELS)
def test_build_slice_like_jax(kernel, platform):
    p, jp = _pair(platform)
    got = build_slice(kernel, MATS, p)
    want = J.build_slice(kernel, JMATS, jp)
    assert got.feature_names == want.feature_names
    assert (got.kernel, got.platform, got.names, got.domains) == \
        (want.kernel, want.platform, want.names, want.domains)
    np.testing.assert_allclose(got.X, want.X, rtol=1e-12, atol=0)
    assert set(got.y) == set(want.y)
    for t in got.y:
        np.testing.assert_allclose(got.y[t], want.y[t], rtol=1e-12, atol=0)


def _assert_result_like_jax(got, want):
    """One slice's CV scores (rtol 1e-9) and importances, in order."""
    assert (got.kernel, got.platform, got.target) == \
        (want.kernel, want.platform, want.target)
    assert set(got.cv) == set(want.cv)
    for k in got.cv:
        assert got.cv[k] == pytest.approx(want.cv[k], rel=1e-9, abs=1e-12)
    assert [n for n, _ in got.importances] == \
        [n for n, _ in want.importances]
    np.testing.assert_allclose([v for _, v in got.importances],
                               [v for _, v in want.importances],
                               rtol=1e-9, atol=1e-12)
    assert top_feature(got) == jcharloop.top_feature(want)


@pytest.mark.parametrize("target", ["gflops", "bandwidth_gbps"])
@pytest.mark.parametrize("kernel", KERNELS)
def test_characterize_slice_like_jax(kernel, target):
    _assert_result_like_jax(
        characterize_slice(build_slice(kernel, MATS, H100_SXM), target, k=5),
        J.characterize_slice(J.build_slice(kernel, JMATS, JH100), target,
                             k=5))


@pytest.mark.parametrize("platform", ["a100", "l40s"])
@pytest.mark.parametrize("target", ["gflops", "bandwidth_gbps"])
@pytest.mark.parametrize("kernel", KERNELS)
def test_characterize_slice_on_the_other_records_like_jax(kernel, target,
                                                          platform):
    p, jp = _pair(platform)
    _assert_result_like_jax(
        characterize_slice(build_slice(kernel, MATS, p), target, k=5),
        J.characterize_slice(J.build_slice(kernel, JMATS, jp), target, k=5))


def test_compare_platforms_and_groups_like_jax():
    results, jresults = [], []
    for kern in KERNELS:
        for p, jp in ((V4, J.TPU_V4), (V5E, J.TPU_V5E)):
            results.append(characterize_slice(
                build_slice(kern, MATS, p), "gflops", k=4))
            jresults.append(J.characterize_slice(
                J.build_slice(kern, JMATS, jp), "gflops", k=4))
    for top in (3, 5):
        assert compare_platforms(results, top=top) == \
            J.compare_platforms(jresults, top=top)
    for r, jr in zip(results, jresults):
        g, jg = grouped_importance(r), J.grouped_importance(jr)
        assert set(g) == set(jg)
        for k in g:
            assert g[k] == pytest.approx(jg[k], rel=1e-9, abs=1e-12)


def test_characterize_all_defaults_to_the_port_platforms():
    """``characterize_all`` runs over the port's three records, in order,
    and equals the reference's ``characterize_all`` over the same three:
    every slice's CV and importances, then the split at top 3 and 5."""
    res = characterize_all(MATS, k=3)
    want = J.characterize_all(JMATS, platforms=JPLATFORMS, k=3)
    assert [(r.kernel, r.platform) for r in res] == [
        (kern, name) for kern in KERNELS
        for name in ("a100_sxm", "h100_sxm", "l40s")]
    assert len(res) == len(want)
    for got, w in zip(res, want):
        _assert_result_like_jax(got, w)
    for top in (3, 5):
        assert compare_platforms(res, top=top) == \
            J.compare_platforms(want, top=top)


# ------------------------------------------- twins of tests/test_charloop.py

def test_build_slice_shapes():
    data = build_slice("spmv", MATS, H100_SXM)
    assert data.X.shape[0] == len(MATS)
    assert data.X.shape[1] == len(data.feature_names)
    assert set(data.y) == {"gflops", "bandwidth_gbps", "throughput_miters"}
    assert np.isfinite(data.X).all()


def test_characterize_slice_outputs():
    data = build_slice("spadd", MATS, H100_SXM)
    res = characterize_slice(data, "gflops", k=5)
    assert 0 <= res.cv["mape"]
    assert res.importances, "importances must be non-empty"
    total = sum(v for _, v in res.importances)
    assert abs(total - 1.0) < 1e-6


def test_compare_platforms_structure():
    results = []
    for kern in ("spmv", "spadd"):
        for plat in (V4, V5E):
            data = build_slice(kern, MATS, plat)
            results.append(characterize_slice(data, "gflops", k=4))
    cmp = compare_platforms(results, top=5)
    assert set(cmp) == {"spmv", "spadd"}
    for kern in cmp.values():
        assert set(kern) == {"algorithm_intrinsic", "architecture_induced"}


def test_grouped_importance_buckets():
    data = build_slice("spmv", MATS, H100_SXM)
    res = characterize_slice(data, "gflops", k=4)
    g = grouped_importance(res)
    assert set(g) == {"locality", "branch/irregularity", "imbalance", "size"}
    assert all(v >= 0 for v in g.values())


def test_perfmodel_targets_positive():
    _, _, A = MATS[0]
    c, t, tg = run_spmv_model(A, H100_SXM)
    assert t["t_total"] > 0
    assert tg["gflops"] > 0
    c, t, tg = run_spgemm_model(A, A, H100_SXM)
    assert tg["gflops"] > 0
    c, t, tg = run_spadd_model(A, A.transpose(), H100_SXM)
    assert tg["gflops"] > 0


def test_platform_ordering_on_streaming_kernel():
    """SpADD is bandwidth-bound (paper §4.3.3): the platform with the
    highest HBM bandwidth must never be slower (the TPU records carried
    across, and the H100's 3.35 TB/s against both)."""
    _, _, A = MATS[1]
    B = A.transpose()
    t_v4 = run_spadd_model(A, B, V4)[1]["t_total"]
    t_v5p = run_spadd_model(A, B, V5P)[1]["t_total"]
    assert t_v5p <= t_v4
    assert H100_SXM.hbm_bw > V5P.hbm_bw
    assert run_spadd_model(A, B, H100_SXM)[1]["t_total"] <= t_v5p
    # fig17 on the port's records: bandwidth H100 > A100 > L40S, so the
    # time never falls and the median GFLOPS never rises down that order
    order = (H100_SXM, A100_SXM, L40S)
    assert order[0].hbm_bw > order[1].hbm_bw > order[2].hbm_bw
    t = [run_spadd_model(A, B, p)[1]["t_total"] for p in order]
    assert t[0] <= t[1] <= t[2]
    med = [np.median([run_spadd_model(M, M.transpose(), p)[2]["gflops"]
                      for _, _, M in MATS]) for p in order]
    assert med[0] >= med[1] >= med[2]


def test_autotuner_selects_and_verifies():
    tuner = ScheduleTuner("spmv", H100_SXM).fit(MATS, max_mats=10)
    _, _, A = MATS[2]
    sched, info = tuner.select(A)
    assert isinstance(sched, Schedule)
    assert sched.backend in ("bsr", "dense")
    assert info["verified_time_s"] > 0


def test_autotuner_pruned_fit_cuts_simulations():
    from repro_torch.core.autotune import candidate_schedules
    n_cand = len(candidate_schedules())
    full = ScheduleTuner("spmv", H100_SXM).fit(MATS, max_mats=10)
    assert full.fit_simulations_ == 10 * n_cand
    k, boot = 3, 4
    pruned = ScheduleTuner("spmv", H100_SXM).fit(
        MATS, max_mats=10, prune_top_k=k, bootstrap_mats=boot)
    assert pruned.fit_simulations_ == boot * n_cand + (10 - boot) * k
    _, _, A = MATS[2]
    sched, info = pruned.select(A)
    assert isinstance(sched, Schedule)
    assert info["verified_time_s"] > 0


def test_moe_block_size_heuristic():
    balanced = np.full(16, 100.0)
    skewed = np.array([1500.0] + [10.0] * 15)
    for p, jp in ((H100_SXM, JH100), (V5E, J.TPU_V5E)):
        assert select_moe_block_size(balanced, 512, p) == \
            J.select_moe_block_size(balanced, 512, jp)
    assert select_moe_block_size(balanced, 512, V5E) == 256
    assert select_moe_block_size(skewed, 512, H100_SXM) <= 128
    assert select_moe_block_size(skewed, 512, V5E) <= 128


# ------------------------------------------------ the paper's §4.3 findings

@pytest.fixture(scope="module")
def findings_corpus():
    return corpus(n_matrices=36, n_min=256, n_max=1024, seed=11)


def test_charloop_reproduces_paper_findings(findings_corpus):
    """Paper §4.3 headline on the JAX package's TPU v4 record: SpADD's
    tree is dominated by branch/irregularity features; SpMV's by
    locality+size structure (not pure branch)."""
    mats = findings_corpus
    spadd = characterize_slice(build_slice("spadd", mats, V4), "gflops", k=4)
    g_spadd = grouped_importance(spadd)
    assert g_spadd["branch/irregularity"] > g_spadd["locality"]
    spmv = characterize_slice(build_slice("spmv", mats, V4), "gflops", k=4)
    g_spmv = grouped_importance(spmv)
    assert g_spmv["locality"] + g_spmv["size"] + \
        g_spmv["branch/irregularity"] > 0.5


def test_charloop_findings_on_h100(findings_corpus):
    """The same corpus on ``H100_SXM``: SpADD's tree still puts more weight
    on branch/irregularity than on locality, and SpMV's on locality, size
    and branch together; size leads SpMV's groups."""
    mats = findings_corpus
    g_spadd = grouped_importance(characterize_slice(
        build_slice("spadd", mats, H100_SXM), "gflops", k=4))
    assert g_spadd["branch/irregularity"] > g_spadd["locality"]
    g_spmv = grouped_importance(characterize_slice(
        build_slice("spmv", mats, H100_SXM), "gflops", k=4))
    assert g_spmv["locality"] + g_spmv["size"] + \
        g_spmv["branch/irregularity"] > 0.5
    assert max(g_spmv, key=g_spmv.get) == "size"


def test_architecture_induced_split_on_findings_corpus(findings_corpus):
    """Over the port's three records the split is not degenerate: SpGEMM
    and SpADD each have features only some records rank (a record's L2,
    bandwidth and queue depth move which counters matter), and every
    algorithm-intrinsic feature is in every record's top 5."""
    res = characterize_all(findings_corpus, k=4)
    cmp = compare_platforms(res, top=5)
    for kern in ("spgemm", "spadd"):
        assert cmp[kern]["architecture_induced"], kern
    for kern, split in cmp.items():
        tops = [{n for n, _ in r.importances[:5]} for r in res
                if r.kernel == kern]
        assert len(tops) == len(PLATFORMS)
        assert set(split["algorithm_intrinsic"]) == set.intersection(*tops)
        assert set(split["architecture_induced"]) == \
            set.union(*tops) - set.intersection(*tops)


# ----------------------------------------------------------------- report

def _trace(pkg: str, path: Path) -> int:
    """Write a JSONL trace of tuner-picked SpMV plans (modeled and
    measured times on every launch) from one package; returns its
    launches."""
    n = 0
    if pkg == "port":
        tuner = ScheduleTuner("spmv", H100_SXM).fit(MATS, max_mats=6)
        tr = install_tracer(Tracer())
        try:
            for _, _, A in MATS[:4]:
                p = plan("spmv", (A,), selector=tuner, device=CPU)
                for _ in range(3):
                    p.execute(np.ones(A.shape[1], np.float32))
                    n += 1
        finally:
            install_tracer(None)
    else:
        tuner = J.ScheduleTuner("spmv", JH100).fit(JMATS, max_mats=6)
        tr = jinstall_tracer(JTracer())
        try:
            for _, _, A in JMATS[:4]:
                p = jplan("spmv", (A,), selector=tuner, backend="jnp")
                for _ in range(3):
                    p.execute(np.ones(A.shape[1], np.float32))
                    n += 1
        finally:
            jinstall_tracer(None)
    tr.write_jsonl(str(path))
    return n


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_report_reads_either_package_trace(tmp_path, writer):
    path = tmp_path / f"{writer}.jsonl"
    n = _trace(writer, path)
    launches = load_launches([str(path)])
    jlaunches = jreport.load_launches([str(path)])
    assert launches == jlaunches and len(launches) == n
    rep, jrep = summarize(launches), jreport.summarize(jlaunches)
    assert rep == jrep and rep
    for key, row in rep.items():
        assert key.startswith("spmv/")
        assert row["launches"] > 0 and row["measured_gm_ms"] > 0
        assert row["modeled_gm_ms"] > 0
    # the CLI entry: the same report, also written as JSON
    out = tmp_path / "report.json"
    assert report.main([str(path), "--json", str(out)]) == rep
    assert json.loads(out.read_text()) == json.loads(json.dumps(rep))


def test_report_skips_torn_lines(tmp_path):
    path = tmp_path / "torn.jsonl"
    good = json.dumps({"type": "launch", "op": "spmv", "layout": "ell",
                       "backend": "torch", "measured_ms": 2.0,
                       "modeled_ms": 1.0})
    path.write_text("{not json\n" + good + "\n"
                    + json.dumps({"type": "launch", "measured_ms": -1.0,
                                  "modeled_ms": 1.0}) + "\n")
    launches = load_launches([str(path)])
    assert len(launches) == 1
    rep = summarize(launches)
    assert rep["spmv/ell/torch"]["residual_log10"] == \
        pytest.approx(np.log10(2.0))


def test_report_cli_on_the_cpu(tmp_path):
    path = tmp_path / "t.jsonl"
    _trace("port", path)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.report", str(path)],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert "op/layout/backend" in out.stdout and "spmv/" in out.stdout


# --------------------------------------------------------------- examples

def test_characterize_example_on_the_cpu():
    from repro_torch.examples import characterize as ex
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys; from repro_torch.examples.characterize import main; "
         "main(sys.argv[1:]); "
         "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.')) "
         "for m in sys.modules)",
         "--category", "uniform", "--n", "256", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert "matrix: uniform n=256" in out.stdout
    for name in PLATFORMS:
        assert f"{name:9s} -> plan[spmv]" in out.stdout
        assert f"spadd    {name:9s}" in out.stdout
    assert ex.serve_mode.__defaults__ == ("h100_sxm", "cuda")
