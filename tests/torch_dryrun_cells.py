"""The dry-run cells of the port's tests at reduced configs and shapes
(``test_torch_dryrun.py``, ``test_torch_dryrun_pods.py``): each held to
the reference's report keys and parameter counts."""
import json

import torch.distributed as dist

from repro.configs import get_config as jget_config
from repro.models import Model as JModel
from repro.models.model import count_active_params as jcount_active
from repro.models.model import count_params as jcount_params
from repro_torch.configs import ShapeConfig, get_config, shape_applicable
from repro_torch.launch import dryrun

REDUCED_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 64, 8, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 64, 8, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 64, 8, "decode"),
    "long_500k": ShapeConfig("long_500k", 128, 1, "decode"),
}
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
# the reference's report keys (src/repro/launch/dryrun.py), without its
# cost_analysis, with the port's collective_count, placed_mesh and
# deviations
REPORT_KEYS = {
    "arch", "shape", "mesh", "status", "n_chips", "compile_seconds",
    "param_count", "active_param_count", "model_flops_global",
    "model_bytes_global", "memory", "hlo_flops_per_chip",
    "hlo_bytes_per_chip", "collective_bytes_per_chip",
    "collective_breakdown", "collective_count", "terms", "bottleneck",
    "useful_ratio", "roofline_fraction", "placed_mesh", "deviations"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes",
               "alias_bytes", "per_device_total"}



def check_reduced_cells(arch, mesh, tmp_path):
    """Every reduced shape of ``arch`` on the fake ``mesh``: ok (or
    skipped where the reference skips) with the reference's keys and
    parameter counts."""
    cfg = get_config(arch, reduced=True)
    jcfg = jget_config(arch, reduced=True)
    jparams = JModel(jcfg).abstract_params()
    n_chips = 8 if mesh == "2x2x2" else 4
    for name, shape in REDUCED_SHAPES.items():
        out = dryrun.run_cell(arch, name, False, report_dir=tmp_path,
                              cfg=cfg, shape=shape,
                              mesh_override=MESHES[mesh], attn_chunk=64)
        assert not dist.is_initialized()
        written = json.loads(
            (tmp_path / f"{arch}__{name}__{mesh}.json").read_text())
        assert written["status"] == out["status"]
        if not shape_applicable(cfg, shape):
            assert out["status"].startswith("skipped"), out["status"]
            continue
        assert out["status"] == "ok", out.get("traceback")
        assert set(out) == REPORT_KEYS
        assert set(out["memory"]) == MEMORY_KEYS
        assert out["mesh"] == mesh and out["n_chips"] == n_chips
        # a 2x2x2 cell is placed on 4x2, its pod axis merged into data
        assert out["placed_mesh"] == ("4x2" if mesh == "2x2x2" else "2x2")
        assert any("pod merged" in d for d in out["deviations"]) == (
            mesh == "2x2x2")
        assert out["param_count"] == jcount_params(jparams)
        assert out["active_param_count"] == jcount_active(jcfg, jparams)
        assert out["hlo_flops_per_chip"] > 0 and out["hlo_bytes_per_chip"] > 0
        assert out["collective_bytes_per_chip"] == sum(
            out["collective_breakdown"].values())
        assert all(v > 0 for v in out["terms"].values()), out["terms"]
        assert out["useful_ratio"] > 0 and out["roofline_fraction"] > 0
        mem = out["memory"]
        assert mem["argument_bytes"] > 0 and mem["temp_bytes"] > 0
        assert mem["per_device_total"] == (
            mem["argument_bytes"] + mem["output_bytes"]
            - mem["alias_bytes"] + mem["temp_bytes"])
        if shape.kind == "prefill":
            assert mem["alias_bytes"] == 0
        else:    # train donates params and AdamW state, decode its cache
            assert mem["alias_bytes"] > 0
