"""Nothing the benchmark runs imports JAX, jaxlib, flax, the JAX package
``repro`` or the JAX benchmarks ``benchmarks``, compared by whole
top-level names (``repro_torch`` begins with ``repro`` and is allowed)."""
import ast
import os
import subprocess
import sys

from spbench import harness, manifest


def test_the_banned_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    monkeypatch.setitem(sys.modules, "reprox.core", sys)
    assert "repro_torch_like" not in harness.banned_modules()
    assert "reprox.core" not in harness.banned_modules()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert {"repro.core", "jaxlib"} <= set(harness.banned_modules())


def test_no_file_of_the_benchmark_imports_a_banned_name():
    for path in manifest.PACKAGE.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in harness.BANNED, (path, n)


def test_a_run_loads_no_banned_module():
    """A whole run on the CPU in a fresh process, then its modules."""
    code = (
        "import sys\n"
        "from spbench import run\n"
        "run.set_environment()\n"
        "from spbench import harness, manifest\n"
        "cell = manifest.resolve('social_100k.spmm_k64')\n"
        "cell.config['matrix']['n_rows'] = 800\n"
        "cell.limits = dict(cell.limits, min_products=1)\n"
        "out = harness.run_cell(cell, 5, 0.2, True, device='cpu',\n"
        "                       log=lambda *a, **k: None)\n"
        "assert out.correct, out.checks\n"
        "run.result_line(out, {}, True)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
        "print(harness.banned_modules())\n")
    env = dict(os.environ, PYTHONPATH=str(manifest.ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=manifest.ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    tops, banned = proc.stdout.strip().splitlines()[-2:]
    assert banned == "[]"
    assert "'repro_torch'" in tops and "'torch'" in tops
