"""The traced slice's reductions and every per-layer metric reader, on a
slice made by hand (a profiler trace exists only on the card)."""
import pytest

from portbench.tests import tiny
from portbench import harness
from portbench.devtrace import Slice
from portbench.work import dense_gqa as work


def _slice():
    sl = Slice()
    sl.t0, sl.t1 = 10.0, 20.0
    sl.kernels = [("marker", 10.0, 0.5), ("ksplit_gemm_kernel<8>", 11.0, 2.0),
                  ("copy", 12.0, 2.0), ("ksplit_gemm_kernel<8>", 16.0, 1.0)]
    sl.spans = [("serve.decode", 10.0, 20.0), ("serve.prefill", 14.0, 16.0),
                ("bench.burst", 9.0, 21.0)]
    return sl


def test_busy_union_top_ops_and_idle_gaps():
    sl = _slice()
    assert sl.busy_intervals() == [[10.0, 10.5], [11.0, 14.0], [16.0, 17.0]]
    assert sl.busy_s == pytest.approx(4.5)
    assert sl.window_s == 10.0
    assert sl.device_seconds("ksplit") == 3.0
    assert sl.top_ops() == [["ksplit_gemm_kernel<8>", 3.0], ["copy", 2.0],
                            ["marker", 0.5]]
    # gaps: 10.5-11 and 17-20 inside decode alone, 14-16 inside prefill
    assert sl.idle_gaps() == [["serve.decode", pytest.approx(3.5)],
                              ["serve.prefill", 2.0]]


def _ctx(cell, facts):
    ctx = harness.make_context(cell, 1, "cpu", tiny.workload(cell),
                               tiny.config())
    ctx.facts, ctx.slice = facts, _slice()
    return ctx


def test_every_reader_reads_its_cell_and_nothing_elsewhere():
    bench = harness.load_benchmark()
    rows = [(20, 5), (9, 3)]
    serve = {"kind": "serve", "batch": 4, "slice_rows": rows,
             "slice_pad": 32, "peak_window_bytes": 2 ** 31,
             "window_stats": ({"tokens": {"prompt": 0, "padded": 0}},
                              {"tokens": {"prompt": 29, "padded": 35}})}
    train = {"kind": "train", "batch": 2, "seq": 16, "steps": 9,
             "slice_steps": 2, "peak_window_bytes": 2 ** 30}
    for cell, facts in ((tiny.CHAT, serve), (tiny.PRETRAIN, train)):
        ctx = _ctx(cell, facts)
        _, layer = harness.cell_metrics(bench, cell)
        got = {m["name"]: harness.load_metric(m["name"])(ctx)
               for m in layer}
        assert all(v is not None and v >= 0 for v in got.values()), got
        for m in layer:
            if m["unit"] == "%" and "waste" not in m["name"] \
                    and "idle" not in m["name"]:
                assert got[m["name"]] <= 100.0, (m["name"], got)
    c = tiny.config()
    ctx = _ctx(tiny.CHAT, serve)
    assert harness.load_metric("padding_waste.serve")(ctx) == \
        pytest.approx(100 * 35 / 64)
    assert harness.load_metric("idle_share.serve")(ctx) == \
        pytest.approx(55.0)
    assert harness.load_metric("peak_mem_gib.serve")(ctx) == 2.0
    steps = 32 + 5 - 1
    assert harness.load_metric("ksplit_roofline.serve")(ctx) == \
        pytest.approx(100 * steps * work.ksplit_seconds(c, 4) / 3.0)
    ctx.slice = None
    assert harness.load_metric("mfu.serve")(ctx) is None
    assert harness.load_metric("mfu.train")(_ctx(tiny.PRETRAIN,
                                                 serve)) is None
