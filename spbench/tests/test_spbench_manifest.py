"""The manifest and the files it names: every cell resolves by name, the
manifest keeps the benchmark's contract, and a cell, mix, limit, metric or
driver added as new files is found without editing one."""
import json
import re
import shutil

import pytest

from spbench import manifest

MAN = manifest.load_manifest()
CELLS = [w["name"] for w in MAN["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("workload", CELLS)
def test_cell_resolves_to_its_files(workload):
    cell = manifest.resolve(workload)
    pkg = manifest.PACKAGE
    if "driver" in cell.config:     # a model cell: its driver runs it
        assert callable(manifest.driver(pkg, cell.config["driver"]).run_cell)
    else:
        assert (pkg / "gen" / f"{cell.config['generator']}.py").is_file()
        assert cell.traffic["op"] in ("spmv", "spmm")
    assert (pkg / "limits" / f"{workload}.json").is_file()
    for m in cell.end_to_end + cell.per_layer:
        assert callable(manifest.reader(pkg, m["name"]).read)
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer


def test_manifest_keeps_the_contract():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["spbench"]
    assert 1 <= MAN["run_seconds"] <= 51
    names = [c["name"] for c in MAN["configs"]] + CELLS + [
        m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("spbench/")
        cfg = json.loads((manifest.ROOT / c["file"]).read_text())
        sizes = cfg["model"] if "driver" in cfg else cfg["matrix"]
        assert set(c["reduced"]) <= set(sizes)
        assert cfg["reduced"] == c["reduced"]
    for w in MAN["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(CELLS)


def test_a_new_cell_is_found_without_editing_a_file(tmp_path):
    """A throwaway configuration, mix, limit and per-layer metric, added as
    new files beside copies of the package's, resolve by name."""
    pkg = tmp_path / "spbench"
    shutil.copytree(manifest.PACKAGE, pkg,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    man = json.loads(json.dumps(MAN))
    cfg = json.loads((manifest.ROOT / MAN["configs"][0]["file"]).read_text())
    cfg["matrix"]["n_rows"] = 512
    (pkg / "configs" / "tiny.json").write_text(json.dumps(cfg))
    (pkg / "traffic" / "burst.json").write_text(json.dumps(
        {"op": "spmv", "n_rhs": 1, "inputs": 2, "chain": None,
         "warmup_ops": 1, "sample_slots": 4}))
    (pkg / "limits" / "tiny.burst.json").write_text(json.dumps(
        {"prod_gap": 2e-5, "min_products": 1}))
    (pkg / "metrics" / "ops.per_window.py").write_text(
        "def read(ctx):\n    return ctx.window.ops\n")
    man["configs"].append({"name": "tiny", "source": "a test",
                           "file": "spbench/configs/tiny.json",
                           "reduced": ["n_rows"], "why": "a test"})
    man["workloads"].append({"name": "tiny.burst", "config": "tiny",
                             "traffic": "burst", "chips": 1, "why": "a test"})
    man["per_layer"].append({"name": "ops.per_window", "unit": "ops",
                             "better": "higher", "source": "host_clock",
                             "layer": "facade", "moves": "setup_s",
                             "workloads": ["tiny.burst"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))

    cell = manifest.resolve("tiny.burst", root=tmp_path, package=pkg)
    assert cell.config["matrix"]["n_rows"] == 512
    assert cell.traffic["inputs"] == 2
    assert [m["name"] for m in cell.per_layer] == ["ops.per_window"]
    # the cell reports setup_s and no end-to-end metric listed elsewhere
    assert [m["name"] for m in cell.end_to_end] == ["setup_s"]
    reader = manifest.reader(pkg, "ops.per_window")

    class Ctx:
        class window:
            ops = 7
    assert reader.read(Ctx) == 7
    # a qualified name with no file of its own reads as its base name does
    split = manifest.reader(pkg, "useful_gflop_s.tiny")
    assert split.__file__.endswith("useful_gflop_s.py")
    with pytest.raises(KeyError):
        manifest.resolve("tiny.nothing", root=tmp_path, package=pkg)


def _echo_package(tmp_path):
    """A copy of the package with a configuration run by the new driver
    file ``drivers/echo.py`` and its cell ``echoed.once``, whose one
    compared number is ``echo_gap``."""
    pkg = tmp_path / "spbench"
    shutil.copytree(manifest.PACKAGE, pkg,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    (pkg / "drivers" / "echo.py").write_text(
        "def run_cell(cell, seed, seconds, trace, device='cuda', t0=None,\n"
        "             log=print):\n"
        "    return ('echo', cell.name, seed)\n"
        "\n"
        "def readings(cell, seeds, seconds, device='cuda', log=print):\n"
        "    return [{'seed': s, 'program': {'echo_gap': s / 100},\n"
        "             'control': {'echo_gap': s}} for s in seeds]\n")
    (pkg / "configs" / "echoed.json").write_text(json.dumps(
        {"name": "echoed", "driver": "echo", "model": {}, "reduced": []}))
    (pkg / "traffic" / "once.json").write_text(json.dumps({"batch": 1}))
    (pkg / "limits" / "echoed.once.json").write_text(
        json.dumps({"echo_gap": 0.5}))
    man = json.loads(json.dumps(MAN))
    man["configs"].append({"name": "echoed", "source": "a test",
                           "file": "spbench/configs/echoed.json",
                           "reduced": [], "why": "a test"})
    man["workloads"].append({"name": "echoed.once", "config": "echoed",
                             "traffic": "once", "chips": 1, "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    return pkg


def test_a_driver_is_found_by_the_name_its_configuration_gives(tmp_path):
    """A configuration naming ``"driver": "<name>"`` is run by
    ``drivers/<name>.py``, added as a new file; one without is run by the
    sparse harness."""
    from spbench import harness
    pkg = _echo_package(tmp_path)
    cell = manifest.resolve("echoed.once", root=tmp_path, package=pkg)
    assert manifest.runner(cell)(cell, 9, 1.0, False) == \
        ("echo", "echoed.once", 9)
    sparse = manifest.resolve(CELLS[0], root=tmp_path, package=pkg)
    assert manifest.runner(sparse) is harness.run_cell


def test_readings_print_the_numbers_a_driver_names(tmp_path, monkeypatch,
                                                   capsys):
    """``python -m spbench.readings`` summarises whatever numbers a new
    driver's rows carry, each beside its limit, with no edit to a file."""
    from spbench import readings
    pkg = _echo_package(tmp_path)
    resolve = manifest.resolve
    monkeypatch.setattr(manifest, "resolve", lambda w: resolve(
        w, root=tmp_path, package=pkg))
    assert readings.main(["--workload", "echoed.once", "--seeds", "3,7",
                          "--device", "cpu"]) == 0
    (summary,) = [json.loads(line) for line in
                  capsys.readouterr().out.strip().splitlines()]
    assert summary == {"workload": "echoed.once", "number": "echo_gap",
                       "program_max": 0.07, "control_min": 3,
                       "limit": 0.5}
