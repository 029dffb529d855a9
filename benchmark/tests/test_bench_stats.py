"""The host-clock arithmetic and the trace reduction."""

import pytest

from benchmark.harness.stats import latencies_ms, percentile, window_rate
from benchmark.harness.trace import breakdown, reduce_events, union_intervals


def closed_loop(service, stall_at=None, stall=0.0):
    t, spans = 0.0, []
    for i, s in enumerate(service):
        d = s + (stall if i == stall_at else 0.0)
        spans.append((t, t + d))
        t += d
    return spans


def test_a_stall_lowers_the_rate_and_raises_the_tail():
    service = [0.01] * 200
    work = [1.0] * 200
    calm = closed_loop(service)
    stalled = closed_loop(service, stall_at=100, stall=0.5)
    assert window_rate(calm, work, 0.0) == pytest.approx(100.0)
    # 200 requests in 2.0 s, or in 2.5 s with the stall
    assert window_rate(stalled, work, 0.0) == pytest.approx(80.0)
    assert percentile(latencies_ms(stalled), 95) == pytest.approx(10.0)
    assert max(latencies_ms(stalled)) == pytest.approx(510.0)
    p95_calm = percentile(latencies_ms(calm), 95)
    assert p95_calm == pytest.approx(10.0)
    slow = closed_loop(service, stall_at=None)
    for i in range(0, 200, 10):          # 20 stalled requests: 10 % of them
        slow[i] = (slow[i][0], slow[i][1] + 0.2)
    assert percentile(latencies_ms(slow), 95) > 100.0


def test_percentile_interpolates_as_numpy():
    np = pytest.importorskip("numpy")
    xs = [5.0, 1.0, 9.0, 3.0, 7.0, 2.0]
    for q in (0, 10, 50, 95, 100):
        assert percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)))


def test_idle_share_of_a_synthetic_trace():
    events = [
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 50, "dur": 100},
        {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 400,
         "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 900, "dur": 100},
        {"ph": "X", "cat": "cpu_op", "name": "aten::conv1d", "ts": 160,
         "dur": 200},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 600,
         "dur": 250},
    ]
    s = reduce_events(events, window_s=0.002)
    assert s["busy_s"] == pytest.approx(350e-6)        # 0-150, 400-500, 900-1000
    assert s["kernels"]["k1"] == pytest.approx(200e-6)
    assert s["gaps"]["aten::conv1d"] == pytest.approx(250e-6)
    assert s["gaps"]["aten::copy_"] == pytest.approx(400e-6)
    brk = breakdown(s)
    assert brk["device_ops"][0][0] == "k1"
    assert brk["idle_gaps"][0] == ["aten::copy_", pytest.approx(400e-6)]
    assert union_intervals([(0, 2), (1, 3), (5, 6)]) == [(0, 3), (5, 6)]
