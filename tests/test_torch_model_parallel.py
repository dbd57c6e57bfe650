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
within 1e-5 of the leaf's largest magnitude.

Context parallelism: llama3.2-3b (causal, GQA), gemma2-9b (sliding
window, softcap) and whisper-large-v3 (bidirectional encoder,
cross-attention with ``kv_valid``) at 3 heads, which the model axis does
not divide, so that ``attn_q_seq`` splits the queries' sequence: with
``SEQ`` 64 and ``CHUNK`` 32 rank 0's half skips the chunk above its
diagonal and rank 1's does not, so a wrong offset shows. The pod axis: a
second spawn on a (pod=2, data=2, model=1) mesh, the batch over (pod,
data) and the parameters replicated over the pods. And llama3.2-3b at 6
heads and 3 KV heads: the query heads split over the model axis, the KV
heads whole."""
import json
import socket

import pytest
import torch.multiprocessing as mp

from repro_torch.configs import list_archs
from torch_mesh_ranks import mesh_rank

WORLD = 4
MESH = ((2, 2), ("data", "model"))
POD_MESH = ((2, 2, 1), ("pod", "data", "model"))
CASES = [(a, {}) for a in list_archs()] + [("mixtral-8x22b",
                                            {"n_experts": 3})]
CP_CASES = [("llama3.2-3b", {"n_heads": 3, "n_kv_heads": 1}),
            ("gemma2-9b", {"n_heads": 3, "n_kv_heads": 1}),
            ("whisper-large-v3", {"n_heads": 3, "n_kv_heads": 3})]
# the 6 heads split over the model axis, the 3 KV heads whole: each rank
# takes the KV heads of its query heads
GQA_CASES = [("llama3.2-3b", {"n_heads": 6, "n_kv_heads": 3})]
POD_CASES = [(a, {}) for a in ("llama3.2-3b", "mixtral-8x22b",
                                "whisper-large-v3")]
TOL = 1e-5


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(tmp_path_factory, mesh, batch_size, cases) -> dict:
    out = tmp_path_factory.mktemp("mesh") / "report.json"
    mp.spawn(mesh_rank, args=(WORLD, _free_port(), *mesh, batch_size, cases,
                              str(out)), nprocs=WORLD)
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def mesh_report(tmp_path_factory):
    return _spawn(tmp_path_factory, MESH, 2, CASES + CP_CASES + GQA_CASES)


@pytest.fixture(scope="module")
def pod_report(tmp_path_factory):
    return _spawn(tmp_path_factory, POD_MESH, 4, POD_CASES)


def _check(rep) -> None:
    bad = {k: v for k, v in rep["errs"].items() if not v <= TOL}
    assert not bad, bad
    assert any(k.startswith("grad/") for k in rep["errs"])


@pytest.mark.parametrize("arch,over", CASES,
                         ids=[a + ("-3experts" if o else "")
                              for a, o in CASES])
def test_mesh_loss_and_grads_equal_the_plain_port(mesh_report, arch, over):
    rep = mesh_report[f"{arch}{over or ''}"]
    assert rep["sharded_params"] > 0
    _check(rep)
    if arch in ("dbrx-132b", "mixtral-8x22b"):
        assert {"metric/load_balance_loss", "metric/expert_imbalance",
                "metric/dropped_fraction"} <= set(rep["errs"])
        # expert parallelism, or the experts' hidden dim over the model axis
        assert (rep["experts"], rep["moe_ffn"]) == (
            (None, "model") if over else ("model", None))


@pytest.mark.parametrize("arch,over", CP_CASES, ids=[a for a, _ in CP_CASES])
def test_context_parallel_loss_and_grads_equal_the_plain_port(
        mesh_report, arch, over):
    rep = mesh_report[f"{arch}{over}"]
    assert rep["attn_q_seq"] == "model"
    _check(rep)


@pytest.mark.parametrize("arch,over", GQA_CASES, ids=[a for a, _ in GQA_CASES])
def test_split_heads_with_whole_kv_heads_equal_the_plain_port(
        mesh_report, arch, over):
    rep = mesh_report[f"{arch}{over}"]
    assert (rep["heads"], rep["kv_heads"]) == ("model", None)
    _check(rep)


@pytest.mark.parametrize("arch,over", POD_CASES, ids=[a for a, _ in POD_CASES])
def test_pod_mesh_loss_and_grads_equal_the_plain_port(pod_report, arch,
                                                      over):
    rep = pod_report[arch]
    assert rep["batch"] == ["pod", "data"]
    assert rep["sharded_params"] > 0
    _check(rep)
