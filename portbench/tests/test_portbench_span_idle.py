"""Idle device time inside one span name's intervals
(``portbench/span_idle.py``) and the four readers built on it, on slices
made by hand (a profiler trace exists only on the card)."""
import pytest

from portbench.tests import tiny
from portbench import harness, span_idle
from portbench.devtrace import Slice


def _slice(spans):
    """A 10 s slice busy over [1, 3] and [6, 8]: idle [0, 1], [3, 6] and
    [8, 10]."""
    sl = Slice()
    sl.t0, sl.t1 = 0.0, 10.0
    sl.kernels = [("gemm", 1.0, 2.0), ("copy", 6.0, 1.5), ("add", 7.0, 1.0)]
    sl.spans = list(spans)
    return sl


@pytest.mark.parametrize("spans, want", [
    # a gap split across the span's edge counts only its inside part
    ([("a", 2.0, 4.0)], 1.0),
    # nested and overlapping spans of one name count once: [2, 5]
    ([("a", 2.0, 4.0), ("a", 2.5, 3.5), ("a", 3.5, 5.0)], 2.0),
    # two gaps, and a span busy throughout that adds nothing
    ([("a", 0.5, 1.5), ("a", 5.0, 9.0), ("a", 6.5, 7.5)], 2.5),
    # clipped to the slice; other names ignored
    ([("a", -5.0, 0.5), ("a", 9.5, 12.0), ("b", 0.0, 10.0)], 1.0),
    ([("b", 0.0, 10.0)], 0.0),
])
def test_idle_inside_a_span_name(spans, want):
    sl = _slice(spans)
    assert sl.busy_intervals() == [[1.0, 3.0], [6.0, 8.0]]
    assert span_idle.idle_seconds(sl, "a") == pytest.approx(want)


def test_union_and_overlap():
    assert span_idle.union([(3, 4), (1, 2), (1.5, 3), (5, 5)]) == \
        [[1, 4]]
    assert span_idle.overlap([[0, 2], [4, 6]], [[1, 5]]) == 2
    assert span_idle.overlap([], [[1, 5]]) == 0.0


READERS = {
    "retire_idle_share.serve": (tiny.CHAT, "serve.retire_pass"),
    "dispatch_idle_share.serve": (tiny.CHAT, "model.forward"),
    "optimizer_idle_share.train": (tiny.PRETRAIN, "train.optimizer"),
    "dispatch_idle_share.train": (tiny.PRETRAIN, "model.forward"),
}


def _ctx(cell, sl):
    ctx = harness.make_context(cell, 1, "cpu", tiny.workload(cell),
                               tiny.config())
    ctx.slice = sl
    return ctx


@pytest.mark.parametrize("name", sorted(READERS))
def test_each_reader_reads_its_span(name):
    cell, span = READERS[name]
    read = harness.load_metric(name)
    bench = harness.load_benchmark()
    _, layer = harness.cell_metrics(bench, cell)
    assert name in {m["name"] for m in layer}
    # idle inside the span: [3, 4] and [8, 9.5], 2.5 s of 10
    sl = _slice([(span, 2.0, 4.0), (span, 8.0, 9.5), ("other", 0.0, 10.0),
                 ("bench.burst", 0.0, 10.0)])
    got = read(_ctx(cell, sl))
    assert got == pytest.approx(25.0)
    assert got <= harness.load_metric(
        "idle_share." + name.split(".")[-1])(_ctx(cell, sl))
    # the span never opened: nothing idle inside it
    assert read(_ctx(cell, _slice([("other", 0.0, 10.0)]))) == 0.0
    # no slice, or a slice without kernels: nothing to read
    assert read(_ctx(cell, None)) is None
    bare = _slice([(span, 0.0, 10.0)])
    bare.kernels = []
    assert read(_ctx(cell, bare)) is None
