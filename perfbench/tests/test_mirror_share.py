"""train.mirror_share on a scripted traced window: the share of updates
whose clip + Adam launch wrote the weight mirror, and no reading from a
program without the mirror's kernels."""

import pytest

from perfbench import spec
from perfbench.kinds.train import Context, Record
from perfbench.trace import Trace

MS = 10 ** 6    # ns


def window(updates: int, wrote: list[bool], kernels: bool = True):
    """A traced window of `updates` updates of 100 ms, the i-th writing
    the mirror where wrote[i] (a skipped update does not)."""
    host = []
    for i in range(updates):
        t = i * 100 * MS
        host += [("openeat.step", t, 90 * MS),
                 ("openeat.step.update", t + 50 * MS, 30 * MS),
                 ("openeat.step.sync", t + 52 * MS, MS)]
        if kernels:
            host.append(("openeat_mt_norm", t + 51 * MS, MS // 10))
        if wrote[i]:
            host.append(("openeat.step.mirror", t + 60 * MS, MS))
    # a mirror span after the window is not the window's
    host.append(("openeat.step.mirror", updates * 100 * MS + MS, MS))
    device = [("k", i * 100 * MS, MS) for i in range(updates)]
    trace = Trace(device, host, (0, updates * 100 * MS))
    return Context("train", Record(updates=40), 5.0, trace,
                   Record(updates=updates))


def read(ctx):
    return spec.metric_reader("train.mirror_share")(ctx)


@pytest.mark.parametrize("wrote, share", [
    ([True] * 4, 100.0),
    ([True, False, True, True], 75.0),
    ([False] * 4, 0.0)])
def test_share_of_updates_that_wrote_the_mirror(wrote, share):
    assert read(window(4, wrote)) == pytest.approx(share)


def test_no_reading_without_the_mirrors_kernels():
    # the parent's program: spans of the update, none of the mirror's
    assert read(window(4, [False] * 4, kernels=False)) is None


def test_no_reading_without_a_traced_window():
    ctx = window(4, [True] * 4)
    assert read(Context("train", ctx.record, 5.0)) is None
    assert read(Context("train", ctx.record, 5.0, ctx.trace,
                        Record(updates=0))) is None


def test_the_metric_is_declared_for_both_training_cells():
    bench = spec.load_benchmark()
    m, = [m for m in bench["per_layer"] if m["name"] == "train.mirror_share"]
    assert m["moves"] == "train_audio_s_per_s"
    assert m["workloads"] == ["aishell_train_bf16", "librispeech_train_bf16"]
    for cell in m["workloads"]:
        names = [x["name"] for x in spec.load_cell(cell).per_layer]
        assert "train.mirror_share" in names
