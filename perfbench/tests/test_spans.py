"""The readers of the program's spans (perfbench/spans.py and the
metrics that use it) on a scripted traced window, and in a CPU rehearsal
of each training mix."""

import pytest

from perfbench import spec
from perfbench.kinds.train import Context, Record
from perfbench.trace import Trace

MS = 10 ** 6    # ns
SPAN_METRICS = ["train.host_fwd_ms", "train.host_bwd_ms",
                "train.host_update_ms", "train.sync_wait_ms",
                "train.loader_wait_ms", "train.feed_ms"]
DEVICE_METRICS = ["train.launches_per_update", "train.idle_unspanned_ms"]


def events(spans=True):
    """Two updates in a window of 1,000 ms: (host, device) events, each
    (name, start, duration) in ns."""
    host = [("openeat.loader.wait", 0, 50), ("openeat.feed", 50, 50),
            ("openeat.step", 100, 400), ("openeat.step.forward", 110, 90),
            ("aten::mm", 120, 5), ("openeat.step.backward", 200, 100),
            ("openeat.step.update", 300, 100), ("openeat.step.sync", 350, 30),
            ("openeat.loader.wait", 500, 60), ("openeat.feed", 560, 40),
            # the stepping thread in no span over [600, 620); an op of the
            # autograd thread covers it
            ("autograd::engine::evaluate_function: MmBackward0", 400, 300),
            ("openeat.step", 620, 370), ("openeat.step.forward", 630, 70),
            ("openeat.step.backward", 700, 100),
            ("openeat.step.update", 800, 100), ("openeat.step.sync", 850, 20),
            ("cudaLaunchKernel", 995, 1),
            # after the window
            ("openeat.step.forward", 1005, 10)]
    device = [("Memcpy HtoD (Pageable -> Device)", 60, 20), ("k1", 120, 50),
              ("k2", 210, 60), ("k1", 620, 100), ("k3", 995, 20),
              ("k3", 1010, 5)]
    if not spans:
        host = [h for h in host if not h[0].startswith("openeat.")]
    scale = [(n, s * MS, d * MS) for n, s, d in host]
    return scale, [(n, s * MS, d * MS) for n, s, d in device]


def context(trace=None, updates=2):
    return Context("train", Record(updates=10), 5.0, trace,
                   Record(updates=updates))


def read(name, ctx):
    return spec.metric_reader(name)(ctx)


def test_span_metrics_on_a_scripted_window():
    host, device = events()
    ctx = context(Trace(device, host, (0, 1000 * MS)))
    got = {m: read(m, ctx) for m in SPAN_METRICS + DEVICE_METRICS}
    assert got == pytest.approx({
        "train.host_fwd_ms": (90 + 70) / 2,
        "train.host_bwd_ms": (100 + 100) / 2,
        # the update's self time: less the sync inside it
        "train.host_update_ms": (100 - 30 + 100 - 20) / 2,
        "train.sync_wait_ms": (30 + 20) / 2,
        "train.loader_wait_ms": (50 + 60) / 2,
        "train.feed_ms": (50 + 40) / 2,
        # five device operations start in the window
        "train.launches_per_update": 5 / 2,
        # idle and in no span of the stepping thread: [600, 620), where
        # only the autograd thread's op runs, and [990, 995)
        "train.idle_unspanned_ms": (20 + 5) / 2})


def test_another_threads_event_never_claims_a_gap():
    host, device = events()
    ctx = context(Trace(device, host, (0, 1000 * MS)))
    before = read("train.idle_unspanned_ms", ctx)
    # an autograd-thread op covering the whole window changes nothing
    host = host + [("autograd::engine::evaluate_function: AddBackward0",
                    0, 1000 * MS)]
    ctx = context(Trace(device, host, (0, 1000 * MS)))
    assert read("train.idle_unspanned_ms", ctx) == before == 12.5


def test_no_spans_no_span_readings():
    """A program that opens no span (the parent of the spans) and an
    untraced run read nothing; a trace without device events (the CPU)
    gives the spans but no device reading."""
    host, device = events(spans=False)
    ctx = context(Trace(device, host, (0, 1000 * MS)))
    for m in SPAN_METRICS + ["train.idle_unspanned_ms"]:
        assert read(m, ctx) is None, m
    assert read("train.launches_per_update", ctx) == 2.5
    host, _ = events()
    cpu = context(Trace([], host, (0, 1000 * MS)))
    assert all(read(m, cpu) is not None for m in SPAN_METRICS)
    assert all(read(m, cpu) is None for m in DEVICE_METRICS)
    for m in SPAN_METRICS + DEVICE_METRICS:
        assert read(m, context()) is None, m
        assert read(m, context(Trace(device, host, (0, 1000 * MS)),
                               updates=0)) is None, m


def test_every_cell_lists_the_span_metrics():
    bench = spec.load_benchmark()
    for cell in ("aishell_train_bf16", "librispeech_train_bf16"):
        _, layer = spec.cell_metrics(bench, cell)
        assert set(SPAN_METRICS + DEVICE_METRICS) <= {m["name"]
                                                      for m in layer}


@pytest.mark.parametrize("mix", ["aishell_train", "librispeech_train"])
def test_traced_rehearsal_reads_every_span(mix, tmp_path):
    from perfbench.tests.test_rehearsal import rehearse
    _, res = rehearse(mix, 2 ** 31 + 7, tracing=True, cache=tmp_path)
    got = res["metrics"]
    assert set(SPAN_METRICS) <= set(got), sorted(got)
    assert all(got[m]["value"] > 0 for m in SPAN_METRICS
               if m != "train.sync_wait_ms")
    assert got["train.sync_wait_ms"]["value"] >= 0
    # the CPU runs no device operation
    assert not set(DEVICE_METRICS) & set(got)
