"""Reading the profiler's Chrome trace: kernels tied to the step and the
operator that launched them, busy time, idle gaps by host activity, and
the readers built on it."""
import pytest

from spbench import timeline
from spbench.metrics import (device_idle_pct, execute_host_ms,
                             guard_check_ms)


def _x(cat, name, ts, dur, tid=1, pid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": pid, "tid": tid, "args": args}


def _trace():
    """A 100 us window, two steps. Step 1 (10-40): a fill (staging), the
    product kernel, a check reduction. Step 2 (50-80): the product kernel
    alone. One harness kernel outside the steps."""
    ev = [
        _x("user_annotation", "spbench.window", 0, 100),
        _x("user_annotation", "spbench.execute", 10, 30),
        _x("user_annotation", "spbench.execute", 50, 30),
        _x("cpu_op", "aten::fill_", 11, 2, **{"External id": 1}),
        _x("cuda_runtime", "cudaLaunchKernel", 11.5, 1, correlation=101),
        _x("cuda_runtime", "cudaLaunchKernel", 14, 1, correlation=102),
        _x("cpu_op", "aten::aminmax", 16, 2, **{"External id": 3}),
        _x("cuda_runtime", "cudaLaunchKernel", 16.5, 1, correlation=103),
        _x("cuda_runtime", "cudaStreamSynchronize", 18, 20),
        _x("cuda_runtime", "cudaLaunchKernel", 52, 1, correlation=104),
        _x("cpu_op", "aten::div", 85, 2, **{"External id": 5}),
        _x("cuda_runtime", "cudaLaunchKernel", 85.5, 1, correlation=105),
        _x("kernel", "fill_kernel", 12, 1, pid=0, tid=7, correlation=101,
           **{"External id": 1}),
        _x("kernel", "void bsr_spmv_counted_kernel<false>", 15, 15, pid=0,
           tid=7, correlation=102, **{"External id": 2}),
        _x("kernel", "reduce_kernel", 30, 2, pid=0, tid=7, correlation=103,
           **{"External id": 3}),
        _x("kernel", "void bsr_spmv_counted_kernel<false>", 53, 20, pid=0,
           tid=7, correlation=104, **{"External id": 4}),
        _x("kernel", "div_kernel", 86, 1, pid=0, tid=7, correlation=105,
           **{"External id": 5}),
    ]
    return {"traceEvents": ev}


def test_kernels_are_tied_to_steps_and_launchers():
    tl = timeline.parse(_trace())
    assert tl.n_execute == 2 and tl.window == (0.0, 100.0)
    by = {e.name: e for e in tl.events}
    assert by["fill_kernel"].in_execute
    assert by["fill_kernel"].launcher == "aten::fill_"
    assert by["reduce_kernel"].launcher == "aten::aminmax"
    assert not by["div_kernel"].in_execute
    assert len(tl.execute_events()) == 4


def test_busy_time_gaps_and_breakdown():
    tl = timeline.parse(_trace())
    # busy: 12-13, 15-30, 30-32, 53-73, 86-87 -> 1 + 17 + 20 + 1 us
    assert tl.busy_s() == pytest.approx(39e-6)
    gaps = tl.gaps()
    assert gaps[0] == (0.0, 12.0) and gaps[-1] == (87.0, 100.0)
    bd = tl.breakdown()
    assert bd["device_ops"][0] == ["void bsr_spmv_counted_kernel<false>",
                                   pytest.approx(35e-6)]
    idle = dict(bd["idle_gaps"])
    # 0-12, 32-53 and 87-100 (12 + 21 + 13 us): mids outside every
    # traced host event
    assert idle["host: no traced event"] == pytest.approx(46e-6)
    # 13-15: the product's launch (14-15) is under way at 14
    assert idle["cudaLaunchKernel"] == pytest.approx(2e-6)
    assert idle["spbench.execute"] == pytest.approx(13e-6)


def test_readers_on_the_timeline():
    tl = timeline.parse(_trace())

    class Win:
        ops = 4
        traced_ops = 2
        execute_s = [40e-6, 30e-6, 50e-6, 70e-6]   # the last two untraced
        untraced_s = 130e-6

    class Ctx:
        timeline = tl
        window = Win

    assert 1 - tl.busy_s() / tl.window_s == pytest.approx(0.61)
    # busy 39 us over the 2 traced steps, against 65 us a step untraced
    assert device_idle_pct.read(Ctx) == pytest.approx(100 * (1 - 19.5 / 65))
    # check: the reduction alone (the fill stages, the products are bsr_)
    assert guard_check_ms.read(Ctx) == pytest.approx(2e-3 / 2)
    # host: 60 us a step untraced less (1 + 15 + 2 + 20) / 2 us on the card
    assert execute_host_ms.read(Ctx) == pytest.approx(41e-3)
    # a window traced to its end has nothing untraced to read
    Win.traced_ops, Win.untraced_s = 4, 0.0
    assert device_idle_pct.read(Ctx) is None
    assert execute_host_ms.read(Ctx) is None


def test_no_window_or_no_device_event_is_no_timeline():
    assert timeline.parse({"traceEvents": []}) is None
    only_host = {"traceEvents": [_x("user_annotation", "spbench.window",
                                    0, 10)]}
    assert timeline.parse(only_host) is None
