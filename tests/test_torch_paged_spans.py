"""The spans ``PagedServeEngine`` keeps while a ``torch.profiler`` session
records (``SERVE_SPANS``): the olmo-1b smoke config on the CPU device,
served under ``torch.profiler.profile(activities=[CPU])``.

* every request has one ``serve.queue`` span carrying its ``rid``;
* every span with a parent lies inside it, and no parent's children sum
  past it (non-negative self time); prefill parts sit under
  ``serve.prefill``, decode parts under ``serve.decode``;
* a prefill batch's ``rows``/``tokens`` and a decode step's resident
  lengths equal what wraps around ``prefill_fn`` and the lane's
  ``_prepare`` (as the benchmark's serving driver takes them) stamp in the
  same run;
* with no profiler nothing is kept (and the latency lists taken out of
  ``metrics()`` stay out); ``reset_metrics`` clears the buffer; a full
  buffer counts what it drops.
"""
import threading
from collections import Counter

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from repro_torch import configs as tcfg
from repro_torch.core import get_all_devices
from repro_torch.serving import PagedServeEngine
from repro_torch.serving.paged import SERVE_SPANS, _Spans

# lengths 5 and 14 twice each: equal lengths may share a prefill batch
PROMPTS = (5, 14, 17, 5, 14)
MAX_NEW = 5
REMOVED = ("token_latency_p50_s", "token_latency_p99_s", "seq_latency_p99_s", "seqs_per_s",
           "elapsed_s")


@pytest.fixture(scope="module")
def device():
    return get_all_devices(platform="cpu").get()[0]


@pytest.fixture(scope="module")
def cfg():
    return tcfg.smoke(tcfg.get_config("olmo-1b"))


def _engine(cfg, device):
    return PagedServeEngine.from_config(cfg, devices=[device], seed=0, max_seq_len=64,
                                        pool_pages=64, name="spans")


def _serve(eng, prompts=PROMPTS):
    futs = [eng.submit(np.arange(n, dtype=np.int32) % 50, MAX_NEW) for n in prompts]
    return [f.get(timeout=120) for f in futs]


def _wrap(eng, device):
    """The serving driver's stamps: each prefill's (rows, tokens) around
    ``prefill_fn``, each decode step's real rows' lengths around the lane's
    ``_prepare``."""
    prefills, steps = [], []
    pre = eng.prefill_fn

    def prefill(tokens, extras):
        prefills.append((int(tokens.shape[0]), int(tokens.shape[1])))
        return pre(tokens, extras)

    eng.prefill_fn = prefill
    lane = eng._lane_for(device)
    prep = lane._prepare

    def prepare(batch):
        out = prep(batch)
        if out is not None:
            ready, (W, _, lens, _, _) = out
            steps.append(list(lens[:len(ready)]))
        return out

    lane._prepare = prepare
    return prefills, steps


@pytest.fixture(scope="module")
def traced(cfg, device):
    """One run under the profiler, the engine closed before its metrics
    are read (so every span has closed), with the driver's wraps."""
    eng = _engine(cfg, device)
    prefills, steps = _wrap(eng, device)
    _serve(eng, (3,))  # a first request before the window, as the driver warms
    eng.reset_metrics()
    prefills.clear()
    steps.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        outs = _serve(eng)
        eng.close()
    return eng.metrics(), outs, prefills, steps


def test_names_are_the_engines(traced):
    m, outs, _, _ = traced
    names = Counter(s[0] for s in m["spans"])
    assert set(names) <= set(SERVE_SPANS)
    # every span but a capture's (the CPU has no step graphs)
    assert set(names) == set(SERVE_SPANS) - {"decode.capture"}
    assert m["spans_dropped"] == 0
    assert len(outs) == len(PROMPTS)


def test_every_request_waits_once_in_the_queue(traced):
    m, _, _, _ = traced
    queued = [s for s in m["spans"] if s[0] == "serve.queue"]
    assert sorted(s[5]["rid"] for s in queued) == list(range(1, 1 + len(PROMPTS)))
    for name, start, end, _, parent, _ in queued:
        assert parent is None and end >= start
    # a request leaves the queue before its prefill batch ends
    batches = [s for s in m["spans"] if s[0] == "serve.prefill"]
    for q in queued:
        (b,) = [b for b in batches if q[5]["rid"] in b[5]["rids"]]
        assert q[2] <= b[2]


def test_children_inside_parents(traced):
    m, _, _, _ = traced
    by_id = {s[3]: s for s in m["spans"]}
    assert len(by_id) == len(m["spans"])
    children = Counter()
    for name, start, end, sid, parent, _ in m["spans"]:
        assert end >= start
        if parent is None:
            assert name.startswith("serve."), name
            continue
        p = by_id[parent]
        assert p[1] <= start and end <= p[2], (name, p[0])
        assert p[0] == ("serve.prefill" if name.startswith("prefill.") else "serve.decode")
        children[parent] += end - start
    for parent, inside in children.items():
        p = by_id[parent]
        assert p[2] - p[1] - inside >= 0, p[0]


def test_decode_step_parts(traced):
    """A step that ran has each part once, in the order they run."""
    m, _, _, _ = traced
    kids = {}
    for s in m["spans"]:
        kids.setdefault(s[4], []).append(s)
    order = ["decode.locks", "decode.prepare", "decode.launch", "decode.logits", "decode.sample"]
    ran = [s for s in m["spans"] if s[0] == "serve.decode" and s[5]["B"] > 0]
    assert ran
    for s in ran:
        parts = sorted(kids[s[3]], key=lambda k: k[1])
        assert [k[0] for k in parts] == order
        (launch,) = [k for k in parts if k[0] == "decode.launch"]
        assert launch[5] == {"replayed": False}
        assert s[5]["W"] >= s[5]["B"] == len(s[5]["lens"])


def test_attributes_equal_the_drivers_stamps(traced):
    m, _, prefills, steps = traced
    got = sorted((s[5]["rows"], s[5]["tokens"]) for s in m["spans"] if s[0] == "serve.prefill")
    assert got == sorted(prefills)
    assert sum(r for r, _ in got) == len(PROMPTS)
    ran = sorted((s for s in m["spans"] if s[0] == "serve.decode" and s[5]["B"] > 0),
                 key=lambda s: s[1])
    assert [s[5]["lens"] for s in ran] == steps
    assert [s[5]["step"] for s in ran] == sorted({s[5]["step"] for s in ran})
    assert m["decode_steps"] == len(ran)


def test_no_profiler_keeps_nothing(cfg, device):
    with _engine(cfg, device) as eng:
        _serve(eng)
        m = eng.metrics()
    assert m["spans"] == [] and m["spans_dropped"] == 0
    assert m["requests_completed"] == len(PROMPTS)
    assert not set(REMOVED) & set(m)


def test_reset_metrics_clears_the_spans(cfg, device):
    with _engine(cfg, device) as eng:
        with profile(activities=[ProfilerActivity.CPU]):
            _serve(eng, PROMPTS[:2])
            eng.drain()
            assert eng.metrics()["spans"]
            eng.reset_metrics()
            m = eng.metrics()
    # a step still open at the reset may close after it, nothing before it
    assert len(m["spans"]) <= len(SERVE_SPANS) and m["spans_dropped"] == 0


def test_full_buffer_counts_what_it_drops(cfg, device):
    with _engine(cfg, device) as eng:
        eng._spans.cap = 7
        with profile(activities=[ProfilerActivity.CPU]):
            _serve(eng, PROMPTS[:2])
            eng.close()
        m = eng.metrics()
    assert len(m["spans"]) == 7
    # two queue waits, two prefill batches of five spans, a step of six each token
    assert m["spans_dropped"] >= 2 + 2 * 5 + 6 * (MAX_NEW - 1) - 7


def test_spans_parents_by_thread():
    log = _Spans(cap=4)
    with log.span("serve.decode") as off:
        pass
    assert off is None and log.snapshot() == ([], 0)
    with profile(activities=[ProfilerActivity.CPU]):
        with log.span("serve.decode") as top:
            top.attrs["B"] = 1
            with log.span("decode.locks"):
                pass

            def other():
                with log.span("serve.prefill"):
                    pass

            t = threading.Thread(target=other)
            t.start()
            t.join()
        with log.span("decode.sample"):
            pass
        log.add("serve.queue", 1, 2, rid=7)
    kept, dropped = log.snapshot()
    assert [s[0] for s in kept] == ["decode.locks", "serve.prefill", "serve.decode",
                                    "decode.sample"]
    assert dropped == 1
    locks, prefill, decode, sample = kept
    assert locks[4] == decode[3] and decode[5] == {"B": 1}
    assert prefill[4] is None and decode[4] is None and sample[4] is None
    log.clear()
    assert log.snapshot() == ([], 0)


def test_spans_from_many_threads_lose_none():
    """More threads than cores opening nested spans at once, switching
    every microsecond: every span is kept or counted dropped, and each
    child's parent is the span its own thread had open."""
    import sys

    threads, each = 12, 200
    log = _Spans(cap=threads * each)  # the nested half overflows
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for i in range(each):
                with log.span("serve.decode") as top:
                    top.attrs["t"] = k
                    with log.span("decode.sample") as kid:
                        kid.attrs["t"] = k

        with profile(activities=[ProfilerActivity.CPU]):
            ts = [threading.Thread(target=work, args=(k,)) for k in range(threads)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    kept, dropped = log.snapshot()
    assert len(kept) == threads * each and dropped == threads * each
    assert len({s[3] for s in kept}) == len(kept)
    by_id = {s[3]: s for s in kept}
    for s in kept:
        if s[0] == "decode.sample" and s[4] in by_id:
            assert by_id[s[4]][5]["t"] == s[5]["t"] and by_id[s[4]][0] == "serve.decode"
        elif s[0] == "serve.decode":
            assert s[4] is None
