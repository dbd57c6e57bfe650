"""Whole runs on the CPU at a size a test can hold: the harness's look for a
card is skipped, the rest of a run is driven. A sound run is correct; the
control and each fault the cells can have, planted under the timed path,
come out not correct; the last line carries the keys the contract names."""
import json
import os
import subprocess
import sys

import pytest
import torch

from spbench import harness, manifest, readings, run
from repro_torch.sparse.plan import Plan

SIZES = {"spatial_131k.spmv_chain": 2048, "social_100k.spmm_k64": 1500}
SEED = 2 ** 31 + 11


def _cell(workload):
    """The cell at a CPU test's size. A busy test machine may finish few
    products in a short window, so one kept product is enough here;
    ``test_too_few_products_is_not_correct`` covers the minimum."""
    cell = manifest.resolve(workload)
    cell.config["matrix"]["n_rows"] = SIZES[workload]
    cell.limits = dict(cell.limits, min_products=1)
    return cell


def _run(workload, trace=False, seconds=0.3):
    return harness.run_cell(_cell(workload), SEED, seconds, trace,
                            device="cpu", log=lambda *a, **k: None)


@pytest.mark.parametrize("workload", sorted(SIZES))
def test_a_sound_run_is_correct_and_its_line_keeps_the_contract(workload):
    out = _run(workload)
    assert out.correct, out.checks
    assert out.pick["source"] == "selector-tree"
    device = {"platform": "gpu", "kind": "test", "count": 1,
              "power_limit": None}
    line = run.result_line(out, device, traced=False)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["attempted"] == out.context.window.ops > 0
    cell = manifest.resolve(workload)
    on_cpu = {"device_peak_gib"}        # no card: nothing to read
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end} \
        - on_cpu
    for m in line["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(line)


def test_too_few_products_is_not_correct():
    from spbench import reference
    mat = harness.generate(_cell("spatial_131k.spmv_chain"), 1)
    ref = reference.Reference(mat, "cpu")
    x = torch.randn(mat["shape"][1])
    y = ref.product(x)[0].float()
    limits = {"prod_gap": 2e-5, "min_products": 8}
    assert reference.judge(ref, [(x, y)] * 8, limits, 8, 0)[0]
    assert not reference.judge(ref, [(x, y)] * 7, limits, 8, 0)[0]
    assert not reference.judge(ref, [(x, y)] * 8, limits, 8, 1)[0]


def test_a_traced_run_reads_the_per_layer_metrics_it_can_on_the_cpu():
    out = _run("spatial_131k.spmv_chain", trace=True)
    assert out.correct
    # the device trace has no kernel on the CPU: its readers read nothing
    assert set(out.metrics) == {"plan_build_s", "prepared_gib",
                                "pick_residual_log10.spmv"}
    assert out.context.spans
    assert 0 < out.context.window.traced_ops <= out.context.window.ops


def test_a_banned_module_loaded_by_the_end_stops_the_result():
    """The look for JAX comes after the readers and the reference: a
    module loaded as late as that still withholds the result. In a fresh
    process, since a test process may hold the JAX package already."""
    code = (
        "import contextlib, io, json, sys, types\n"
        "from spbench import run\n"
        "run.set_environment()\n"
        "from spbench import harness, manifest\n"
        "cell = manifest.resolve('social_100k.spmm_k64')\n"
        "cell.config['matrix']['n_rows'] = 800\n"
        "cell.limits = dict(cell.limits, min_products=1)\n"
        "out = harness.run_cell(cell, 5, 0.2, False, device='cpu',\n"
        "                       log=lambda *a, **k: None)\n"
        "dev = {'platform': 'gpu', 'kind': 'test', 'count': 1}\n"
        "def emit():\n"
        "    buf = io.StringIO()\n"
        "    with contextlib.redirect_stdout(buf):\n"
        "        rc = run.emit(out, dev, False)\n"
        "    return rc, buf.getvalue()\n"
        "clean = emit()\n"
        "sys.modules['jax'] = types.ModuleType('jax')\n"
        "print(json.dumps([clean, emit()]))\n")
    env = dict(os.environ, PYTHONPATH=str(manifest.ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=manifest.ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    (rc, line), (rc_jax, line_jax) = json.loads(
        proc.stdout.strip().splitlines()[-1])
    assert rc == 0 and json.loads(line)["correct"]
    assert rc_jax == 3 and line_jax == ""
    assert "JAX or the JAX package was loaded: jax" in proc.stderr


def _unchanged(x, y):
    return x.clone()


def _half_left_out(x, y):
    y = y.clone()
    if y.dim() == 1:
        y[y.shape[0] // 2:] = 0.0
    else:
        y[:, y.shape[1] // 2:] = 0.0
    return y


def _one_answer_altered(x, y):
    y = y.clone()
    y.view(-1)[y.numel() // 3] += 1.0
    return y


@pytest.mark.parametrize("fault", [_unchanged, _half_left_out,
                                   _one_answer_altered])
@pytest.mark.parametrize("workload", sorted(SIZES))
def test_a_fault_under_the_timed_path_is_not_correct(monkeypatch, workload,
                                                     fault):
    execute = Plan.execute

    def broken(self, *runtime):
        return fault(runtime[0], execute(self, *runtime))

    monkeypatch.setattr(Plan, "execute", broken)
    out = _run(workload)
    assert not out.correct
    assert out.checks["prod_gap"]["value"] > out.checks["prod_gap"]["limit"]


@pytest.mark.parametrize("workload", sorted(SIZES))
def test_the_tf32_control_is_not_correct(workload):
    cell = _cell(workload)
    (row,) = readings.readings(cell, [SEED], 0.3, "cpu",
                               log=lambda *a, **k: None)
    limit = cell.limits["prod_gap"]
    assert row["program"]["prod_gap"] <= limit < row["control"]["prod_gap"]


def test_without_a_card_no_result_and_a_nonzero_exit():
    if torch.cuda.is_available():
        pytest.skip("a card is present: this is the run without one")
    env = dict(os.environ, PYTHONPATH=str(manifest.ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "spbench.run", "--workload",
         "spatial_131k.spmv_chain", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=manifest.ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(SIZES))
def test_a_cell_on_the_card(workload):
    """The command as the benchmark runs it, for a short window that runs
    on past its traced part: the first 5 s are traced, and stopping the
    profiler after the chain's thousands of traced ops takes ~4 s of the
    window, so 20 s leave the readers of the untraced ops some 10 s."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run(
        [sys.executable, "-m", "spbench.run", "--workload", workload,
         "--seed", str(SEED), "--seconds", "20", "--trace", "1"],
        cwd=manifest.ROOT, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    cell = manifest.resolve(workload)
    assert set(line["metrics"]) == {m["name"] for m in cell.per_layer}
