"""The interval union and the trace's reductions on made-up events."""

import pytest

from perfbench.trace import Trace, merged, union_length


@pytest.mark.parametrize("intervals,want", [
    ([], 0),
    ([(0, 10)], 10),
    ([(0, 10), (5, 15)], 15),            # overlap counts once
    ([(0, 10), (2, 3), (20, 25)], 15),   # nested, then apart
    ([(20, 25), (0, 10), (10, 12)], 17),  # touching, unsorted
])
def test_union_length(intervals, want):
    assert union_length(intervals) == want


def test_merged():
    assert merged([(5, 6), (0, 2), (1, 3)]) == [(0, 3), (5, 6)]


def trace():
    device = [("k1", 10, 20), ("k2", 20, 20), ("copy", 60, 10),
              ("k1", 90, 5), ("outside", 200, 50)]
    host = [("step", 0, 100), ("wait", 45, 10), ("aten::mm", 46, 2)]
    return Trace(device, host, (0, 100))


def test_busy_and_window():
    t = trace()
    # [10, 40) u [60, 70) u [90, 95) = 45 of 100 ns
    assert t.busy_s() == pytest.approx(45e-9)
    assert t.window_s == pytest.approx(100e-9)
    assert t.kernel_s(lambda n: n == "k1") == pytest.approx(25e-9)


def test_top_ops_and_gaps():
    t = trace()
    assert t.top_ops(2) == [["k1", 25e-9], ["k2", 20e-9]]
    gaps = t.idle_gaps(3)
    # the gaps [0, 10), [40, 60), [70, 90), [95, 100); at 40 the host is
    # in "step" alone ("wait" begins at 45)
    assert gaps[0] == ["step", pytest.approx(20e-9)]
    assert [g[1] for g in gaps] == pytest.approx([20e-9, 20e-9, 10e-9])
    assert t.host_at(47) == "aten::mm"
    assert t.host_at(150) == "idle host"
