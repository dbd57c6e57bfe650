"""The traffic loop and the generators: latencies from due times, the
chain, the seeded sample of kept products, the traced first part of a
window; the frozen generators' shapes and their seeding."""
import numpy as np
import pytest
import torch

from spbench import manifest
from spbench import drive
from spbench.drive import Loop, make_inputs

CHAIN = {"op": "spmv", "n_rhs": 1, "inputs": 1, "chain": "max_abs",
         "warmup_ops": 2, "sample_slots": 4}


def test_inputs_are_drawn_from_the_seed():
    mix = dict(CHAIN, n_rhs=3, inputs=2)
    a = make_inputs(mix, 10, 2 ** 31 + 5, "cpu")
    b = make_inputs(mix, 10, 2 ** 31 + 5, "cpu")
    c = make_inputs(mix, 10, 7, "cpu")
    assert [t.shape for t in a] == [(10, 3), (10, 3)]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])


def test_the_chain_feeds_each_result_back_normalised():
    seen = []

    def step(x):
        seen.append(x.clone())
        return 2 * x + 1

    x0 = torch.tensor([1.0, -3.0])
    d = Loop(CHAIN, step, [x0], seed=1, device="cpu")
    d.warm()
    win = d.window(0.05)
    assert win.ops >= 3 and win.failed == 0
    first = seen[2]                       # the window restarts the chain
    assert torch.equal(first, x0)
    y = 2 * x0 + 1
    assert torch.allclose(seen[3], y / y.abs().max())
    # closed loop: the latencies tile the window
    assert sum(win.latencies_s) == pytest.approx(win.wall_s, rel=1e-6)
    # every kept product is the step of its own input
    assert 1 <= len(win.samples) <= 4
    for x, yk in win.samples:
        assert torch.allclose(yk, 2 * x + 1)


def test_the_kept_sample_is_seeded_and_uniform():
    mix = dict(CHAIN, chain=None, inputs=1, sample_slots=8)

    def kept(seed, n=400):
        d = Loop(mix, lambda x: x.clone(), [torch.zeros(1)], seed, "cpu")
        d._slots = [torch.empty(1) for _ in range(8)]
        out = []
        for i in range(n):
            d._keep(i, torch.full((1,), float(i)), torch.zeros(1), out)
        return sorted(int(x) for _, x in out)

    assert kept(3) == kept(3) and kept(3) != kept(4)
    picks = np.concatenate([kept(s) for s in range(200)])
    # each op is kept with probability 8/400: halves of the window alike
    assert abs((picks < 200).mean() - 0.5) < 0.05


def test_a_failing_step_stops_the_window_and_counts():
    calls = []

    def step(x):
        calls.append(1)
        if len(calls) > 3:
            raise RuntimeError("launch failed")
        return x + 1

    d = Loop(dict(CHAIN, chain=None), step, [torch.ones(2)], 1, "cpu")
    d.warm()
    win = d.window(1.0)
    assert win.failed == 1 and "launch failed" in win.error
    assert win.ops == 1


def test_only_the_first_part_of_a_traced_window_is_annotated(monkeypatch):
    monkeypatch.setattr(drive, "TRACE_SECONDS", 0.05)
    mix = dict(CHAIN, chain=None)
    annotated, stops = [], []

    def step(x):
        annotated.append(d.annotate)
        return x + 1

    d = Loop(mix, step, [torch.ones(2)], 1, "cpu")
    d.warm()
    annotated.clear()
    win = d.window(0.2, stop_trace=lambda: stops.append(len(annotated)))
    assert stops == [win.traced_ops] and 0 < win.traced_ops < win.ops
    assert annotated == [True] * win.traced_ops \
        + [False] * (win.ops - win.traced_ops)
    assert sum(win.execute_s[:win.traced_ops]) < 0.05 + 0.02
    assert win.wall_s >= 0.2 and not d.annotate
    assert 0 < win.untraced_s <= win.wall_s - 0.05
    assert d.window(0.05).traced_ops == 0


@pytest.mark.parametrize("n", [300, 1024])
def test_the_spatial_generator(n):
    gen = manifest.generator(manifest.PACKAGE, "spatial")
    m = gen.generate({"n_rows": n, "cluster": 10}, seed=2 ** 31 + 3)
    assert m["shape"] == (n, n) and m["row_ptrs"][-1] == 10 * n
    cols = m["col_idxs"].astype(np.int64).reshape(n, 10)
    assert (np.diff(cols, axis=1) == 1).all() and cols.max() < n
    again = gen.generate({"n_rows": n, "cluster": 10}, seed=2 ** 31 + 3)
    assert np.array_equal(again["col_idxs"], m["col_idxs"])
    assert np.array_equal(again["vals"], m["vals"])


def test_the_spatial_generator_is_the_frozen_draw_order():
    """A fixed seed's first rows and values, as gen_spatial drew them when
    the benchmark was written."""
    gen = manifest.generator(manifest.PACKAGE, "spatial")
    m = gen.generate({"n_rows": 64, "cluster": 10}, seed=0)
    rng = np.random.default_rng(0)
    starts = [int(rng.integers(0, 54)) for _ in range(64)]
    assert m["col_idxs"][::10].tolist() == starts
    assert np.array_equal(
        m["vals"],
        np.random.default_rng(1).standard_normal(640).astype(np.float32))


def test_the_power_law_generator_keeps_its_rows_across_seeds():
    gen = manifest.generator(manifest.PACKAGE, "power_law")
    params = {"n_rows": 2000, "alpha": 2.1, "mean_deg": 8,
              "structure_seed": 500200}
    a = gen.generate(params, seed=1)
    b = gen.generate(params, seed=2 ** 31 + 1)
    la, lb = np.diff(a["row_ptrs"]), np.diff(b["row_ptrs"])
    # the same degrees (hubs first); only duplicates merged differ
    assert la[0] >= la[-1] and abs(int(la.sum()) - int(lb.sum())) \
        < 0.01 * la.sum()
    assert np.abs(la - lb).max() <= 0.05 * la.max() + 2
    assert not np.array_equal(a["col_idxs"][:50], b["col_idxs"][:50])
    for m in (a, b):
        rows = np.repeat(np.arange(2000), np.diff(m["row_ptrs"]))
        key = rows * 2000 + m["col_idxs"].astype(np.int64)
        assert (np.diff(key) > 0).all()       # sorted, duplicates merged
