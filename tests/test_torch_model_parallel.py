"""The port's hand-partitioned model code run with values on a real mesh.

Four gloo ranks on a (data=2, model=2) mesh each hold ``param_specs``'s
shards of a reduced config's parameters as DTensors, take their rows of
the batch and run ``Model.loss`` and its backward with the dry run's
logical rules installed: the attention, SSD and RG-LRU cores, the MoE
layer (expert parallelism: dbrx-132b, mixtral-8x22b at 4 experts; its
hidden dim split instead: mixtral-8x22b at 3 experts, which the model
axis does not divide) and the vocab-parallel lookup and target pick run
on local shards through ``models.partitioning.local_apply``. The loss,
the MoE metrics and every gradient, gathered whole, are held against the
plain one-process port on the same weights and tokens at float32 compute:
within 1e-5 of the leaf's largest magnitude."""
import json
import socket

import pytest
import torch.multiprocessing as mp

from repro_torch.configs import list_archs
from torch_mesh_ranks import mesh_rank

WORLD, DATA = 4, 2
CASES = [(a, {}) for a in list_archs()] + [("mixtral-8x22b",
                                            {"n_experts": 3})]
TOL = 1e-5


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def mesh_report(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh") / "report.json"
    mp.spawn(mesh_rank, args=(WORLD, _free_port(), DATA, CASES, str(out)),
             nprocs=WORLD)
    return json.loads(out.read_text())


@pytest.mark.parametrize("arch,over", CASES,
                         ids=[a + ("-3experts" if o else "")
                              for a, o in CASES])
def test_mesh_loss_and_grads_equal_the_plain_port(mesh_report, arch, over):
    rep = mesh_report[f"{arch}{over or ''}"]
    assert rep["sharded_params"] > 0
    bad = {k: v for k, v in rep["errs"].items() if not v <= TOL}
    assert not bad, bad
    assert any(k.startswith("grad/") for k in rep["errs"])
    if arch in ("dbrx-132b", "mixtral-8x22b"):
        assert {"metric/load_balance_loss", "metric/expert_imbalance",
                "metric/dropped_fraction"} <= set(rep["errs"])
        # expert parallelism, or the experts' hidden dim over the model axis
        assert (rep["experts"], rep["moe_ffn"]) == (
            (None, "model") if over else ("model", None))
