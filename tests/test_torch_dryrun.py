"""The port's dry run (``repro_torch.launch.dryrun``) held against the JAX
package's on the CPU.

Every arch at its reduced config on fake 2 x 2 and 2 x 2 x 2 meshes, at
reduced shapes of each kind (train and prefill 8 x 64, decode 8 x 64,
long 1 x 128): each applicable cell reports ``ok`` with the reference's
report keys, its parameter counts equal the reference's; ``--all``'s cell
list and skips equal the reference's; a cell made to fail is written down
as ``FAILED`` with its traceback, and no process group outlives a cell.
The full-size cells run on the card's host (``chip_smoke.py``); the
2 x 2 x 2 cells are in ``test_torch_dryrun_pods.py``.
"""
import dataclasses
import json

import pytest
import torch.distributed as dist

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs import list_archs as jlist_archs
from repro.configs import shape_applicable as jshape_applicable
from repro.models import Model as JModel
from repro.models.model import count_active_params as jcount_active
from repro.models.model import count_params as jcount_params
from repro_torch.configs import SHAPES, get_config, list_archs, shape_applicable
from repro_torch.launch import dryrun
from repro_torch.models import Model, count_active_params, count_params
from torch_dryrun_cells import MESHES, REDUCED_SHAPES, check_reduced_cells

@pytest.mark.parametrize("arch", list_archs())
def test_reduced_cells_report_ok(arch, tmp_path):
    check_reduced_cells(arch, "2x2", tmp_path)


def test_all_cells_and_skips_equal_the_reference():
    cells = dryrun.cells(None, None, True)
    assert cells == [(a, s) for a in jlist_archs() for s in JSHAPES]
    assert list_archs() == jlist_archs() and list(SHAPES) == list(JSHAPES)
    skipped = 0
    for arch, shape in cells:
        applicable = shape_applicable(get_config(arch), SHAPES[shape])
        assert applicable == jshape_applicable(jget_config(arch),
                                               JSHAPES[shape])
        if not applicable:
            skipped += 1
            for multi_pod in (False, True):
                out = dryrun.build_cell(arch, shape, multi_pod)
                assert out == {
                    "arch": arch, "shape": shape,
                    "mesh": "2x16x16" if multi_pod else "16x16",
                    "status": "skipped(full-attention long-context)"}
    assert skipped == 6      # the full-attention archs at long_500k
    with pytest.raises(SystemExit):
        dryrun.cells("llama3.2-3b", None, False)


@pytest.mark.parametrize("arch", list_archs())
def test_full_size_param_counts_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    model = Model(cfg, device="meta")
    jparams = JModel(jcfg).abstract_params()
    assert count_params(model) == jcount_params(jparams)
    assert count_active_params(cfg, model) == jcount_active(jcfg, jparams)


def test_failed_cell_is_written_with_its_traceback(tmp_path):
    cfg = get_config("llama3.2-3b", reduced=True)
    out = dryrun.run_cell("llama3.2-3b", "train_4k", False,
                          report_dir=tmp_path, cfg=cfg,
                          shape=REDUCED_SHAPES["train_4k"],
                          mesh_override=MESHES["2x2"], remat="no-such")
    assert out["status"].startswith("FAILED: ValueError: unknown remat")
    assert "Traceback" in out["traceback"]
    written = json.loads(
        (tmp_path / "llama3.2-3b__train_4k__2x2.json").read_text())
    assert written == out
    assert not dist.is_initialized()


def test_cli_writes_a_skipped_cell(tmp_path, capsys):
    outs = dryrun.main(["--arch", "llama3.2-3b", "--shape", "long_500k",
                        "--both-meshes", "--out", str(tmp_path)])
    assert [o["mesh"] for o in outs] == ["16x16", "2x16x16"]
    assert all(o["status"].startswith("skipped") for o in outs)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "llama3.2-3b__long_500k__16x16.json",
        "llama3.2-3b__long_500k__2x16x16.json"]
    assert "skipped" in capsys.readouterr().out


def test_context_parallel_cell_counts_less_attention(tmp_path):
    """llama3.2-3b at 3 heads, which the model axis of 2 does not divide:
    ``attn_q_seq`` splits the queries' sequence, and the counted rank (the
    last of the model axis) computes its half of the rows against the
    keys, fewer FLOPs than the same cell with the rule off."""
    cfg = dataclasses.replace(get_config("llama3.2-3b", reduced=True),
                              n_heads=3, n_kv_heads=1)
    outs = [dryrun.run_cell("llama3.2-3b", "train_4k", False,
                            report_dir=tmp_path, cfg=cfg,
                            shape=REDUCED_SHAPES["train_4k"],
                            mesh_override=MESHES["2x2"], attn_chunk=32,
                            extra_rules=extra)
            for extra in (None, {"attn_q_seq": None})]
    assert [o["status"] for o in outs] == ["ok", "ok"], outs
    cp, whole = outs
    assert cp["hlo_flops_per_chip"] < whole["hlo_flops_per_chip"]
    assert cp["hlo_bytes_per_chip"] < whole["hlo_bytes_per_chip"]
