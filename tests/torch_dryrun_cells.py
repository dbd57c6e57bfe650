"""The dry-run cells of the port's tests at reduced configs and shapes
(``test_torch_dryrun.py``, ``test_torch_dryrun_pods.py``): each held to
the reference's report keys and parameter counts, and a 2 x 2 x 2 cell to
its 2 x 2 twin: the same parameter bytes a device (the parameters are
replicated over the pods) and, in training, an all-reduce of every
gradient over the pods that the twin lacks."""
import json

import torch.distributed as dist

from repro.configs import get_config as jget_config
from repro.models import Model as JModel
from repro.models.model import count_active_params as jcount_active
from repro.models.model import count_params as jcount_params
from repro_torch.configs import ShapeConfig, get_config, shape_applicable
from repro_torch.launch import dryrun
from repro_torch.launch import specs
from repro_torch.models import Model

REDUCED_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 64, 8, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 64, 8, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 64, 8, "decode"),
    "long_500k": ShapeConfig("long_500k", 128, 1, "decode"),
}
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
# the reference's report keys (src/repro/launch/dryrun.py), without its
# cost_analysis, with the port's collective_count
REPORT_KEYS = {
    "arch", "shape", "mesh", "status", "n_chips", "compile_seconds",
    "param_count", "active_param_count", "model_flops_global",
    "model_bytes_global", "memory", "hlo_flops_per_chip",
    "hlo_bytes_per_chip", "collective_bytes_per_chip",
    "collective_breakdown", "collective_count", "terms", "bottleneck",
    "useful_ratio", "roofline_fraction"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes",
               "alias_bytes", "per_device_total"}



def param_argument_bytes(out: dict, cfg, shape) -> int:
    """A report's argument bytes less those of its batch (the decode
    cache and token): the parameters' (and in training AdamW's moments')
    shard bytes a device."""
    mem = out["memory"]
    n, dp = shape.global_batch, 4 if out["mesh"] == "2x2x2" else 2
    split = dp if n % dp == 0 else 1
    if shape.kind == "decode":
        rest = mem["alias_bytes"] + n * 8 // split     # the cache, int64 ids
    else:
        rest = sum(t.numel() * t.element_size() for t in
                   specs.batch_abstract(cfg, shape).values()) // split
    return mem["argument_bytes"] - rest


def check_reduced_cells(arch, mesh, tmp_path) -> dict:
    """Every reduced shape of ``arch`` on the fake ``mesh``: ok (or
    skipped where the reference skips) with the reference's keys and
    parameter counts. Returns {shape name: report} of the ok cells."""
    cfg = get_config(arch, reduced=True)
    jcfg = jget_config(arch, reduced=True)
    jparams = JModel(jcfg).abstract_params()
    n_chips = 8 if mesh == "2x2x2" else 4
    outs = {}
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
        outs[name] = out
    return outs


def check_pod_cells(arch, tmp_path) -> None:
    """``arch``'s reduced cells on 2 x 2 x 2 against their 2 x 2 twins:
    the same parameter bytes a device, and in a train cell one all-reduce
    more for each gradient (over the pods)."""
    cfg = get_config(arch, reduced=True)
    twins = check_reduced_cells(arch, "2x2", tmp_path)
    pods = check_reduced_cells(arch, "2x2x2", tmp_path)
    assert pods.keys() == twins.keys()
    for name, out in pods.items():
        shape, twin = REDUCED_SHAPES[name], twins[name]
        assert param_argument_bytes(out, cfg, shape) == \
            param_argument_bytes(twin, cfg, shape), name
        if shape.kind == "train":
            assert out["memory"]["alias_bytes"] == \
                twin["memory"]["alias_bytes"]
            n_params = len(list(Model(cfg, device="meta").parameters()))
            assert (out["collective_count"]["all-reduce"]
                    - twin["collective_count"]["all-reduce"]) >= n_params
