"""The per-layer metrics that read the serving engine's spans
(``queue_wait_p95_s``, ``prefill_idle_ms_per_batch``,
``decode_sample_ms_per_step``): hand-built spans and a trace of hand-placed
device operations give the values worked by hand, and a run with nothing
to read (no spans, as a program without them; no trace) gives None."""
import json
from types import SimpleNamespace

import pytest

from bench_tiny import make_root, run_cell
from benchlib import registry
from benchlib.trace import Trace

MS = 1_000_000  # ns


def _read(name, **run):
    return registry.load_module("metrics", name).read(SimpleNamespace(**run))


def _span(name, start_ms, end_ms, sid=0, parent=None, **attrs):
    return (name, int(start_ms * MS), int(end_ms * MS), sid, parent, attrs)


def test_bench_queue_wait_p95_over_the_queue_spans():
    spans = [_span("serve.queue", 0, i, sid=i, rid=i) for i in range(1, 21)]
    spans += [_span("serve.prefill", 0, 500, sid=99), _span("decode.sample", 0, 900, sid=98)]
    # linear between order statistics: 19 + 0.05 x (20 - 19) ms
    assert _read("queue_wait_p95_s", engine={"spans": spans}) == pytest.approx(0.01905)
    assert _read("queue_wait_p95_s", engine={"spans": spans[-2:]}) is None
    assert _read("queue_wait_p95_s", engine={"rows": 3}) is None  # a program with no spans
    assert _read("queue_wait_p95_s", engine=None) is None


def _trace(ops_ms, h0_ms=0, h1_ms=100):
    t = Trace([], h0_ms * MS, h1_ms * MS)
    t.ops = [("k", s * MS, e * MS, 7, i) for i, (s, e) in enumerate(ops_ms)]
    return t


def test_bench_prefill_idle_inside_prefill_spans_over_the_batches_there():
    # busy [3, 10], [30, 60] (two operations overlapping), [80, 100]:
    # idle [0, 3], [10, 30], [60, 80]
    t = _trace([(3, 10), (30, 50), (45, 60), (80, 100)])
    spans = [
        _span("serve.prefill", -20, 2, rows=1),    # straddles the stretch's start: 2 ms idle, no batch
        _span("serve.prefill", 5, 20, rows=1),     # a gap opens inside it: 10 ms idle
        _span("serve.prefill", 55, 70, rows=1),    # 10 ms idle
        _span("serve.prefill", 95, 130, rows=1),   # starts inside, busy there: a batch, no idle
        _span("serve.prefill", 150, 160, rows=1),  # after the stretch: nothing
        _span("serve.decode", 60, 80, B=4),        # idle under a decode step: not the prefill's
        _span("prefill.forward", 11, 19),          # a part: its parent already holds its time
    ]
    got = _read("prefill_idle_ms_per_batch", trace=t, engine={"spans": spans})
    assert got == pytest.approx((2 + 10 + 10) / 3)


def test_bench_prefill_idle_reads_nothing_without_spans_or_trace():
    t = _trace([(0, 50)])
    inside = {"spans": [_span("serve.prefill", 10, 20)]}
    assert _read("prefill_idle_ms_per_batch", trace=t, engine=inside) == 0.0  # busy throughout
    assert _read("prefill_idle_ms_per_batch", trace=None, engine=inside) is None
    assert _read("prefill_idle_ms_per_batch", trace=t, engine={"rows": 3}) is None
    assert _read("prefill_idle_ms_per_batch", trace=t, engine=None) is None
    before = {"spans": [_span("serve.prefill", -10, 5)]}  # no batch starts in the stretch
    assert _read("prefill_idle_ms_per_batch", trace=t, engine=before) is None


def test_bench_decode_sample_over_the_steps_that_ran():
    spans = [
        _span("decode.sample", 1, 3, sid=11, parent=1),
        _span("serve.decode", 0, 5, sid=1, B=3, W=4, lens=[7, 8, 9]),
        _span("serve.decode", 5, 7, sid=2, B=0),                # found no row ready
        _span("decode.sample", 8, 12, sid=31, parent=3),
        _span("serve.decode", 7, 13, sid=3, B=2, W=2, lens=[5, 6]),
        _span("decode.sample", 14, 114, sid=91, parent=9),      # its step was still open
    ]
    assert _read("decode_sample_ms_per_step", engine={"spans": spans}) == pytest.approx(3.0)
    assert _read("decode_sample_ms_per_step", engine={"spans": spans[2:3]}) is None
    assert _read("decode_sample_ms_per_step", engine={"rows": 3}) is None
    assert _read("decode_sample_ms_per_step", engine=None) is None


def test_bench_span_metrics_are_declared_for_the_serving_cells():
    bench = registry.load_benchmark()
    by = {m["name"]: m for m in bench["per_layer"]}
    assert by["queue_wait_p95_s"]["workloads"] == ["olmo-1b.chat", "olmo-1b.code"]
    assert by["prefill_idle_ms_per_batch"]["workloads"] == ["olmo-1b.chat", "olmo-1b.code"]
    assert by["decode_sample_ms_per_step"]["workloads"] == ["olmo-1b.chat"]
    for name in ("queue_wait_p95_s", "prefill_idle_ms_per_batch", "decode_sample_ms_per_step"):
        assert by[name]["source"] in ("program_span", "device_trace")


def test_bench_span_metrics_reach_a_traced_run_under_a_profiler(tmp_path):
    """A tiny traced serving run on the CPU under a profiler keeps the
    engine's spans, and the two host-side readers find them; without a
    card there is no device trace, so the idle reader reads nothing."""
    from torch.profiler import ProfilerActivity, profile

    root = make_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    names = ("queue_wait_p95_s", "prefill_idle_ms_per_batch", "decode_sample_ms_per_step")
    for m in bench["per_layer"]:
        if m["name"] in names:
            m["workloads"].append("olmo-tiny.chat-tiny")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    with profile(activities=[ProfilerActivity.CPU]):
        rc, res, err = run_cell(root, "olmo-tiny.chat-tiny", trace=1)
    assert rc == 0, err
    assert res["metrics"]["queue_wait_p95_s"]["value"] >= 0
    assert res["metrics"]["decode_sample_ms_per_step"]["value"] > 0
    assert "prefill_idle_ms_per_batch" not in res["metrics"]
    rc, res, err = run_cell(root, "olmo-tiny.chat-tiny", trace=1)  # no profiler: no spans
    assert rc == 0, err
    assert not set(names) & set(res["metrics"])
