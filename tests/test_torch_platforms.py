"""The port's platform records (``repro_torch.core.platforms``): the three
NVIDIA generations of the characterization loop's machine axis, held
against the reference's ``Platform`` record and the public figures they
are built from, and the CLIs that take them by name."""
import dataclasses
import inspect

import pytest

import repro.core as J
from repro_torch import core as T
from repro_torch.core import platforms as P
from repro_torch.roofline import analysis

RECORDS = {"a100_sxm": P.A100_SXM, "h100_sxm": P.H100_SXM, "l40s": P.L40S}


@pytest.mark.parametrize("name", sorted(RECORDS))
def test_features_have_the_reference_keys_and_values(name):
    rec = RECORDS[name]
    assert rec.name == name
    assert list(rec.features()) == list(J.TPU_V5E.features())
    assert rec.features() == J.Platform(**dataclasses.asdict(rec)).features()
    assert [f.name for f in dataclasses.fields(P.Platform)] == \
        [f.name for f in dataclasses.fields(J.Platform)]


def test_platforms_are_the_three_in_order():
    assert list(P.PLATFORMS.items()) == list(RECORDS.items())
    assert T.PLATFORMS is P.PLATFORMS
    assert (T.A100_SXM, T.H100_SXM, T.L40S) == \
        (P.A100_SXM, P.H100_SXM, P.L40S)
    assert P.ROOFLINE_PLATFORM is P.H100_SXM
    assert T.ROOFLINE_PLATFORM is P.H100_SXM
    default = inspect.signature(analysis.roofline_terms).parameters[
        "platform"].default
    assert default is P.H100_SXM


def test_h100_record_is_unchanged():
    assert dataclasses.asdict(P.H100_SXM) == {
        "name": "h100_sxm", "peak_flops_bf16": 989e12, "hbm_bw": 3.35e12,
        "hbm_latency_s": 600e-9, "vmem_bytes": 50 * 2**20,
        "dma_queue_depth": 32, "ici_bw_per_link": 50e9, "ici_links": 18,
        "mxu_dim": 64}


def test_datasheet_figures_and_their_ordering():
    a, h, l = P.A100_SXM, P.H100_SXM, P.L40S
    assert (a.peak_flops_bf16, a.hbm_bw, a.vmem_bytes, a.ici_bw_per_link,
            a.ici_links) == (312e12, 2.039e12, 40 * 2**20, 50e9, 12)
    assert (l.peak_flops_bf16, l.hbm_bw, l.vmem_bytes, l.ici_bw_per_link,
            l.ici_links) == (362.05e12, 864e9, 96 * 2**20, 64e9, 1)
    # bandwidth: HBM3 > HBM2e > GDDR6; peak: Hopper > Ada > Ampere
    assert h.hbm_bw > a.hbm_bw > l.hbm_bw
    assert h.peak_flops_bf16 > l.peak_flops_bf16 > a.peak_flops_bf16
    # the L2: the A100's is the smallest, the L40S's the largest
    assert l.vmem_bytes > h.vmem_bytes > a.vmem_bytes
    # the L40S plays the low-latency, small-bandwidth part; the queue
    # depth follows each card's bandwidth x latency product
    assert l.hbm_latency_s < h.hbm_latency_s < a.hbm_latency_s
    assert h.dma_queue_depth > a.dma_queue_depth > l.dma_queue_depth
    # mma.sync's 16-row tiles on Ampere and Ada, wgmma's 64 on Hopper
    assert (a.mxu_dim, h.mxu_dim, l.mxu_dim) == (16, 64, 16)


@pytest.mark.parametrize("name", sorted(RECORDS))
def test_no_record_holds_a_tpu_figure(name):
    rec = RECORDS[name]
    for tpu in J.PLATFORMS.values():
        for field in ("peak_flops_bf16", "hbm_bw", "vmem_bytes"):
            assert getattr(rec, field) != getattr(tpu, field), \
                (name, tpu.name, field)


@pytest.mark.parametrize("module", ["repro_torch.selector.serve",
                                    "repro_torch.serving.serve"])
def test_clis_take_every_record_and_refuse_others(module, capsys):
    import importlib
    main = importlib.import_module(module).main
    with pytest.raises(SystemExit):
        main(["--help"])
    out = capsys.readouterr().out
    assert "{a100_sxm,h100_sxm,l40s}" in out
    with pytest.raises(SystemExit):
        main(["--platform", "tpu_v5e", "--device", "cpu"])
    assert "invalid choice: 'tpu_v5e'" in capsys.readouterr().err


@pytest.mark.parametrize("name", sorted(RECORDS))
def test_selector_serve_runs_under_each_record(name, capsys):
    from repro_torch.selector.serve import main
    tel = main(["--platform", name, "--device", "cpu", "--execute",
                "--requests", "6", "--train-mats", "6", "--serve-mats", "3",
                "--n-max", "320", "--batch", "3"])
    out = capsys.readouterr().out
    assert "6 checked, 0 mismatches" in out
    assert tel["requests"] == 6
