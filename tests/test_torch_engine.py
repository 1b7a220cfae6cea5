"""The port's continuous-batching ``RequestEngine`` and the rest of
``serve_step`` (``repro_torch.serving``), on the CPU: the port of
``tests/test_engine.py`` (admission, backpressure, cancellation, buckets,
broadcast leaves, the graph route on an engine stream, placement), of the
lane tests of ``tests/test_paged.py`` and of ``route_batches`` in
``tests/test_scheduler.py``; then the port held against the JAX package on
the same seeded numpy inputs: ``make_serve_engine`` on ``smoke(olmo-1b)``
and ``smoke(mamba2-130m)`` (weights carried across by
``params_from_numpy``; ``next`` equal, ``logits`` and ``cache`` within the
reference test's 2e-5), ``cache_to_rows``/``rows_to_cache`` (bit-equal, f32
and bf16), ``make_serve_fanout`` and ``route_batches``.

Parcels (loopback localities, the 2-process cluster, ``apply_batched``,
kernel names) wait for ROADMAP.md Queue 1 item 10: those reference tests
stand here skipped, each beside a test of the port's refusal.  Every
``get`` has a timeout and every engine is closed in a ``finally``.
"""
import os
import subprocess
import sys
import textwrap
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfg
import repro.serving as jserving
from repro.core import Scheduler as JaxScheduler
from repro.core import get_all_devices as jax_get_all_devices
from repro.models import get_model as jax_get_model
from repro_torch import configs as tcfg
from repro_torch.core import QueueLoad, Scheduler, capture, get_all_devices
from repro_torch.models import get_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import (EngineClosed, LanePolicy, QueueFull, RequestEngine,
                                 cache_to_rows, make_serve_engine, make_serve_fanout,
                                 rows_to_cache, route_batches)
from repro_torch.serving.engine import tree_flatten, tree_unflatten
from repro_torch.serving.serve_step import make_serve_step

T = 60  # seconds any get may wait
TOL = dict(rtol=2e-5, atol=2e-5)  # tests/test_engine.py:434-438


# Linear elementwise step: batched and per-request execution give the same
# bits, so one reference covers every route.
def _linear_step(x):
    return x * 2.0 + 1.0


def _linear_ref(p):
    return np.asarray(p, np.float32) * 2.0 + 1.0


@pytest.fixture(scope="module")
def device():
    return get_all_devices(platform="cpu").get(timeout=T)[0]


@pytest.fixture()
def engine(device):
    eng = RequestEngine(_linear_step, max_batch=4, max_delay_s=0.005,
                        scheduler=Scheduler([device], policy="least_loaded"), name="t-linear")
    try:
        yield eng
    finally:
        eng.close()


# ---------------------------------------------------------------------------
# admission surface
# ---------------------------------------------------------------------------


def test_torch_submit_rejects_rowless_and_ragged_payloads(engine):
    with pytest.raises(ValueError, match="leading row axis"):
        engine.submit(np.float32(3.0))
    with pytest.raises(ValueError, match="disagree"):
        engine.submit({"a": np.ones((1, 4), np.float32), "b": np.ones((2, 4), np.float32)})
    with pytest.raises(KeyError, match="no kind"):
        engine.submit(np.ones((1, 2), np.float32), kind="nope")
    with pytest.raises(ValueError, match="max_batch"):
        engine.submit(np.ones((5, 4), np.float32))  # engine max_batch=4


def test_torch_requests_batch_and_resolve_bit_equal_slices(engine):
    rng = np.random.default_rng(0)
    payloads = [rng.normal(size=(1, 16)).astype(np.float32) for _ in range(10)]
    futs = [engine.submit(p) for p in payloads]
    for p, f in zip(payloads, futs):
        got = f.get(timeout=T)
        want = _linear_ref(p)
        assert isinstance(got, np.ndarray) and got.shape == p.shape
        assert got.dtype == want.dtype and np.array_equal(got, want)
    m = engine.metrics()
    assert m["requests_completed"] >= 10
    assert m["batches"] < 10  # continuous batching actually batched
    assert m["mean_batch_rows"] > 1.0


def test_torch_multi_row_requests_slice_correctly(engine):
    rng = np.random.default_rng(1)
    p2 = rng.normal(size=(2, 16)).astype(np.float32)
    p3 = rng.normal(size=(3, 16)).astype(np.float32)
    f2, f3 = engine.submit(p2), engine.submit(p3)
    assert np.array_equal(f2.get(timeout=T), _linear_ref(p2))
    assert np.array_equal(f3.get(timeout=T), _linear_ref(p3))


def test_torch_broadcast_leaves_gate_batch_compatibility(device):
    eng = RequestEngine(lambda b: {"y": b["x"] * b["scale"]}, max_batch=8, max_delay_s=0.02,
                        scheduler=Scheduler([device], policy="least_loaded"), name="t-bcast")
    try:
        futs = [eng.submit({"x": np.full((1, 4), float(i), np.float32),
                            "scale": np.float32(2.0 if i % 2 == 0 else 3.0)})
                for i in range(6)]
        for i, f in enumerate(futs):
            scale = 2.0 if i % 2 == 0 else 3.0
            np.testing.assert_array_equal(f.get(timeout=T)["y"],
                                          np.full((1, 4), scale * i, np.float32))
        # two distinct broadcast values can never share a micro-batch
        assert eng.metrics()["batches"] >= 2
    finally:
        eng.close()


def test_torch_backpressure_queue_full_and_cancellation(device):
    # The cap (4 rows) is above the three queued rows and the deadline is far
    # off, so no group can fill or time out while the test submits: the queue
    # holds all three when the fourth arrives.  The warm-up fills the cap and
    # dispatches at once.
    eng = RequestEngine(_linear_step, max_batch=4, max_delay_s=10.0, max_queue=3,
                        scheduler=Scheduler([device], policy="least_loaded"), name="t-bp")
    try:
        eng.submit(np.ones((4, 4), np.float32)).get(timeout=T)  # warm the route
        time.sleep(0.05)
        futs = [eng.submit(np.ones((1, 4), np.float32)) for _ in range(3)]
        with pytest.raises(QueueFull, match="backpressure"):
            eng.submit(np.ones((1, 4), np.float32))
        assert futs[2].cancel()  # pending: cancellable
        assert futs[2].cancelled()
    finally:
        eng.close()  # drains the two live requests
    assert np.array_equal(futs[0].get(timeout=T), _linear_ref(np.ones((1, 4), np.float32)))
    assert np.array_equal(futs[1].get(timeout=T), _linear_ref(np.ones((1, 4), np.float32)))
    assert eng.metrics()["requests_cancelled"] == 1


def test_torch_close_cancel_pending_fails_fast(device):
    eng = RequestEngine(_linear_step, max_batch=8, max_delay_s=10.0,
                        scheduler=Scheduler([device], policy="least_loaded"), name="t-close")
    try:
        f = eng.submit(np.ones((1, 4), np.float32))
    finally:
        eng.close(cancel_pending=True)
    with pytest.raises(EngineClosed):
        f.get(timeout=10)
    with pytest.raises(EngineClosed):
        eng.submit(np.ones((1, 4), np.float32))


def test_torch_failing_step_fails_every_member_future_and_the_batcher_lives(device):
    def boom(x):
        if bool((x == 1.0).any()):  # every batch holding a row of ones
            raise RuntimeError("step exploded")
        return x + 1.0

    eng = RequestEngine(boom, max_batch=4, max_delay_s=0.005,
                        scheduler=Scheduler([device], policy="least_loaded"), name="t-boom")
    try:
        futs = [eng.submit(np.ones((1, 2), np.float32)) for _ in range(3)]
        for f in futs:
            with pytest.raises(RuntimeError, match="step exploded"):
                f.get(timeout=T)
        assert eng.metrics()["requests_failed"] == 3
        # the batcher survived: the next requests are served
        futs = [eng.submit(np.zeros((1, 2), np.float32)) for _ in range(3)]
        for f in futs:
            np.testing.assert_array_equal(f.get(timeout=T), np.ones((1, 2), np.float32))
        m = eng.metrics()
        assert m["requests_failed"] == 3 and m["batches"] >= 2
    finally:
        eng.close()


def test_torch_metrics_latency_and_throughput(engine):
    futs = [engine.submit(np.ones((1, 8), np.float32)) for _ in range(6)]
    for f in futs:
        f.get(timeout=T)
    engine.drain()
    m = engine.metrics()
    assert m["requests_completed"] >= 6
    assert 0.0 < m["latency_p50_s"] <= m["latency_p99_s"]
    assert m["requests_per_s"] > 0.0
    assert m["queue_high_water"] >= 1
    assert "RequestEngine(t-linear:" in repr(engine)


def test_torch_concurrent_submitters_lose_no_request_or_count(device):
    """16 threads (more than the cores) submit at once under a short
    switch interval: every request resolves to its own rows and the
    counters add up, which a lost update would break."""
    import threading

    n_threads, per = 16, 12
    eng = RequestEngine(_linear_step, max_batch=8, max_delay_s=0.002,
                        scheduler=Scheduler([device], policy="least_loaded"), name="t-stress")
    errors = []

    def client(t):
        try:
            for i in range(per):
                p = np.full((1, 4), float(t * per + i), np.float32)
                np.testing.assert_array_equal(eng.submit(p).get(timeout=T), _linear_ref(p))
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client, args=(t,)) for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=T)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
        eng.close()
    assert not errors, errors[0]
    m = eng.metrics()
    total = n_threads * per
    assert m["requests_submitted"] == m["requests_completed"] == m["rows"] == total
    assert m["requests_failed"] == 0 and m["inflight_batches"] == 0 and m["queue_depth"] == 0

# ---------------------------------------------------------------------------
# padding buckets and broadcast values: a handful of routes
# ---------------------------------------------------------------------------


def test_torch_bucketed_padding_reuses_compiled_routes(device):
    eng = RequestEngine(_linear_step, max_batch=8, max_delay_s=0.004,
                        scheduler=Scheduler([device], policy="least_loaded"), name="t-bucket")
    try:
        rng = np.random.default_rng(3)
        payloads = [rng.normal(size=(1, 8)).astype(np.float32) for _ in range(30)]
        futs = [eng.submit(p) for p in payloads]
        for p, f in zip(payloads, futs):
            assert np.array_equal(f.get(timeout=T), _linear_ref(p))
        buckets = {k[2] for k in eng._graphs}
        assert buckets.issubset({1, 2, 4, 8})
        m = eng.metrics()
        assert m["padded_rows"] >= 0 and m["rows"] == 30
    finally:
        eng.close()


def test_torch_broadcast_values_share_one_compiled_route(device):
    """A decode ``pos`` that changes every step REUSES the captured route
    (fed at replay): six values, one route key, six right results."""
    eng = RequestEngine(lambda b: {"y": b["x"] + b["pos"].to(torch.float32)}, max_batch=2,
                        max_delay_s=0.002, scheduler=Scheduler([device], policy="least_loaded"),
                        name="t-routekey")
    try:
        for pos in range(6):  # six distinct broadcast values, same shapes
            got = eng.submit({"x": np.zeros((1, 4), np.float32),
                              "pos": np.int32(pos)}).get(timeout=T)
            np.testing.assert_array_equal(got["y"], np.full((1, 4), float(pos), np.float32))
        routes = [k for k, v in eng._graphs.items() if v is not None]
        assert routes, "graph route was never built"
        assert len({k[1] for k in routes}) == 1  # ONE route key across all pos
        assert len(routes) <= 2  # at most one per bucket actually used
    finally:
        eng.close()


def test_torch_back_to_back_batches_on_one_route_keep_their_values(device):
    """The next micro-batch may replay the same route before the previous
    one's join has read its outputs: each still resolves to its own."""
    # a long deadline: every pair fills its batch and dispatches at once
    eng = RequestEngine(_linear_step, max_batch=2, max_delay_s=5.0,
                        scheduler=Scheduler([device], policy="least_loaded"), name="t-b2b")
    try:
        eng.submit(np.zeros((2, 8), np.float32)).get(timeout=T)  # build the bucket-2 route
        payloads = [np.full((1, 8), float(i), np.float32) for i in range(8)]
        futs = [eng.submit(p) for p in payloads]
        for p, f in zip(payloads, futs):
            np.testing.assert_array_equal(f.get(timeout=T), _linear_ref(p))
        assert [k[2] for k, v in eng._graphs.items() if v is not None] == [2]
    finally:
        eng.close()


# ---------------------------------------------------------------------------
# graph replay route: engine stream + replay-with-feeds
# ---------------------------------------------------------------------------


def test_torch_engine_uses_graph_replay_on_engine_stream(engine, device):
    futs = [engine.submit(np.ones((1, 16), np.float32)) for _ in range(4)]
    for f in futs:
        f.get(timeout=T)
    assert engine._graphs, "no captured graph route was built"
    entry = next(iter(engine._graphs.values()))
    assert entry is not None and not entry.exe._fanout
    s = engine._streams[device.key]
    assert s.device is device and s is not device.default_stream
    assert entry.exe._last_replay_queue is s.lane  # replays rode the engine's lane


def test_torch_graph_disabled_falls_back_to_direct(device):
    eng = RequestEngine(_linear_step, max_batch=4, max_delay_s=0.005, graph=False,
                        scheduler=Scheduler([device], policy="least_loaded"), name="t-direct")
    try:
        p = np.random.default_rng(4).normal(size=(1, 8)).astype(np.float32)
        assert np.array_equal(eng.submit(p).get(timeout=T), _linear_ref(p))
        assert not eng._graphs
    finally:
        eng.close()


def test_torch_uncapturable_step_takes_the_direct_route(device):
    """A step whose output is not a tensor cannot be captured: its route is
    remembered as None and every batch runs direct, with right results."""
    eng = RequestEngine(lambda b: {"y": b * 3.0, "n": 7}, max_batch=2, max_delay_s=0.005,
                        scheduler=Scheduler([device], policy="least_loaded"), name="t-uncap")
    try:
        for i in range(3):
            got = eng.submit(np.full((1, 4), float(i), np.float32)).get(timeout=T)
            np.testing.assert_array_equal(got["y"], np.full((1, 4), 3.0 * i, np.float32))
            assert int(got["n"]) == 7
        assert set(eng._graphs.values()) == {None}
    finally:
        eng.close()


def test_torch_replay_stream_override_matches_default_lane(device):
    """GraphExec.replay(stream=...), the engine's feed path, equals a
    default-lane replay, and fan-out plans refuse the override."""
    prog = device.create_program({"k": _linear_step}, "rp").get(timeout=T)
    buf = device.create_buffer((4,), np.float32).get(timeout=T)
    with capture("stream-replay") as g:
        w = buf.enqueue_write(0, np.zeros(4, np.float32))
        node = prog.run([buf], "k")
    exe = g.instantiate()
    x = np.arange(4, dtype=np.float32)
    base = exe.replay(feeds={w: x}).get(timeout=T)[node]
    s = device.create_stream("replay-override")
    alt = s.replay(exe, feeds={w: x})
    with s._lock:
        assert alt in s._completions
    s.record().wait(timeout=T)
    assert alt.done()
    np.testing.assert_array_equal(np.asarray(alt.get(timeout=T)[node]), np.asarray(base))

    b2 = device.create_buffer((4,), np.float32).get(timeout=T)
    o1 = device.create_buffer((4,), np.float32).get(timeout=T)
    o2 = device.create_buffer((4,), np.float32).get(timeout=T)
    with capture("fan") as g2:
        w2 = b2.enqueue_write(0, x)
        prog.run([b2], "k", out=[o1])  # independent chains -> fan-out
        prog.run([b2], "k", out=[o2])
    exe2 = g2.instantiate()
    assert exe2._fanout
    with pytest.raises(ValueError, match="fan-out"):
        exe2.replay(feeds={w2: x}, stream=s)


# ---------------------------------------------------------------------------
# pytrees and leaves: dict order, bf16, tensors
# ---------------------------------------------------------------------------


def test_torch_pytree_sorts_dict_keys_and_round_trips():
    a = {"b": [1, (2, None)], "a": np.ones(2)}
    b = {"a": np.ones(2), "b": [1, (2, None)]}
    la, ta = tree_flatten(a)
    lb, tb = tree_flatten(b)
    assert ta == tb and hash(ta) == hash(tb) and len(la) == 3
    assert tree_flatten([1, 2])[1] != tree_flatten((1, 2))[1]
    back = tree_unflatten(ta, la)
    assert list(back) == ["a", "b"] and back["b"][1] == (2, None)


def test_torch_dicts_built_in_other_orders_share_a_batch(device):
    eng = RequestEngine(lambda b: b["x"] + b["y"], max_batch=2, max_delay_s=0.5,
                        scheduler=Scheduler([device], policy="least_loaded"), name="t-order")
    try:
        f1 = eng.submit({"x": np.ones((1, 3), np.float32), "y": np.full((1, 3), 2.0, np.float32)})
        f2 = eng.submit({"y": np.full((1, 3), 5.0, np.float32), "x": np.ones((1, 3), np.float32)})
        np.testing.assert_array_equal(f1.get(timeout=T), np.full((1, 3), 3.0, np.float32))
        np.testing.assert_array_equal(f2.get(timeout=T), np.full((1, 3), 6.0, np.float32))
        assert eng.metrics()["batches"] == 1
    finally:
        eng.close()


@pytest.mark.parametrize("graph", [True, False])
def test_torch_bf16_and_tensor_leaves_round_trip(device, graph):
    """bf16 rows (a torch tensor and an ml_dtypes numpy array) and a bf16
    0-d broadcast leaf: batched, zero-padded, and handed back as CPU bf16
    tensors, bit-equal to the request run alone."""
    eng = RequestEngine(lambda b: b["x"] * b["s"], max_batch=4, max_delay_s=0.02, graph=graph,
                        scheduler=Scheduler([device], policy="least_loaded"), name="t-bf16")
    try:
        gen = torch.Generator().manual_seed(0)
        xs = [torch.randn(1, 5, generator=gen).to(torch.bfloat16) for _ in range(3)]
        s = torch.tensor(1.5, dtype=torch.bfloat16)
        x1 = np.asarray(jnp.asarray(xs[1].float().numpy(), jnp.bfloat16))  # ml_dtypes bf16
        futs = [eng.submit({"x": x, "s": s}) for x in (xs[0], x1, xs[2])]
        for x, f in zip(xs, futs):
            got = f.get(timeout=T)
            assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16
            assert torch.equal(got, x * s)
        assert eng.metrics()["padded_rows"] == 1  # 3 rows in bucket 4
    finally:
        eng.close()


# ---------------------------------------------------------------------------
# lanes (tests/test_paged.py:381-420)
# ---------------------------------------------------------------------------


def test_torch_lane_token_budget_caps_prefill_batches(device):
    seen = []

    def prefill(batch):  # rows (b, 16): tokens_per_row = 16
        seen.append(batch.shape[0])
        return batch * 1.0

    eng = RequestEngine({"prefill": prefill}, max_batch=8, max_delay_s=0.05,
                        scheduler=Scheduler([device]), graph=False,
                        lanes={"prefill": LanePolicy(token_budget=32)}, name="t-lanes")
    try:
        futs = [eng.submit(np.ones((1, 16), np.float32), kind="prefill") for _ in range(6)]
        for f in futs:
            f.get(timeout=T)
    finally:
        eng.close()
    assert max(seen) <= 2  # token budget bound, not max_batch=8
    with pytest.raises(KeyError, match="unknown kind"):
        RequestEngine({"x": prefill}, lanes={"nope": LanePolicy()})


def test_torch_lane_deadline_overrides_engine_default(device):
    eng = RequestEngine({"decode": lambda b: b + 1.0}, max_batch=8, max_delay_s=0.25,
                        scheduler=Scheduler([device]), graph=False,
                        lanes={"decode": LanePolicy(max_delay_s=0.002)}, name="t-deadline")
    try:
        t0 = time.monotonic()
        eng.submit(np.ones((1, 4), np.float32), kind="decode").get(timeout=T)
        assert time.monotonic() - t0 < 0.2  # dispatched at the lane deadline
    finally:
        eng.close()


# ---------------------------------------------------------------------------
# batch-aware scheduler hook and sticky placement
# ---------------------------------------------------------------------------


class _FakeQueue:
    def __init__(self, depth=0):
        self.depth = depth

    def load(self):
        return QueueLoad(self.depth, 0, 0.0, 0.0, self.depth, 0)


class _FakeDevice:
    def __init__(self, key, depth=0):
        self.key = key
        self.ops_queue = _FakeQueue(depth)


class _FakeBuf:
    def __init__(self, device, nbytes):
        self.device, self.nbytes = device, nbytes


def test_torch_select_batch_scores_the_union_of_member_args():
    d0, d1 = _FakeDevice("cpu:0"), _FakeDevice("cpu:1")
    sched = Scheduler([d0, d1], policy="affinity")
    batch = [[_FakeBuf(d0, 600)], [_FakeBuf(d0, 600)], [_FakeBuf(d1, 1000)]]
    assert sched.select_batch(batch).key == "cpu:0"
    assert sched.stats() == {"cpu:0": 1}  # one decision for the whole batch
    batch2 = [[_FakeBuf(d1, 5000)], [_FakeBuf(d0, 600)]]
    assert sched.select_batch(batch2).key == "cpu:1"


def test_torch_place_batch_sticks_by_route_and_rehomes_on_yield():
    """``_place_batch`` sends the route's home as the ``prefer`` hint on
    every batch after the first; when the scheduler's structural yield
    overrides it, the home follows the device actually picked.  (The
    reference builds this engine from the kernel name
    ``"partition_map_ref"``; the port from the callable.)"""
    from repro_torch.kernels.partition_map.ref import partition_map_ref

    class _Dev:
        def __init__(self, key):
            self.key = key

    class _HintSched:
        def __init__(self):
            self.prefers = []
            self.i = 0
            self.yield_now = False

        def select_batch(self, leaves, prefer=None):
            self.prefers.append(prefer)
            if prefer is not None and not self.yield_now:
                return _Dev(prefer)
            self.i += 1
            return _Dev(f"cpu:{self.i % 4}")

    class _Req:
        key = ("apply", None, ())
        leaves = [np.ones(4, np.float32)]

    eng = RequestEngine(partition_map_ref, name="t-sticky")
    try:
        sched = _HintSched()
        keys = [eng._place_batch(sched, [_Req()]).key for _ in range(12)]
        assert sched.prefers[0] is None
        assert sched.prefers[1:12] == ["cpu:1"] * 11
        assert keys == ["cpu:1"] * 12  # never migrates unprompted
        sched.yield_now = True
        assert eng._place_batch(sched, [_Req()]).key == "cpu:2"
        sched.yield_now = False
        assert eng._place_batch(sched, [_Req()]).key == "cpu:2"
        assert sched.prefers[-1] == "cpu:2"
    finally:
        eng.close()


# ---------------------------------------------------------------------------
# route_batches (tests/test_engine.py:346-394, tests/test_scheduler.py:262)
# ---------------------------------------------------------------------------


class _Port:
    in_process = False


class _Remote:
    is_remote_proxy = True
    key = "L9/cpu:0"
    _port = _Port()
    ops_queue = _FakeQueue()


class _RemoteSched:
    """Duck-typed scheduler that places everything on a remote locality
    (the port's ``Scheduler`` refuses such a fleet outright)."""

    def select(self, args=(), program=None):
        return _Remote()

    def select_batch(self, batch_args=(), program=None, prefer=None):
        return _Remote()


def test_torch_route_batches_closure_on_cross_process_locality_raises():
    with pytest.raises(NotImplementedError, match="item 10"):
        Scheduler([_Remote()], policy="static")
    with pytest.raises(NotImplementedError, match="item 10"):
        route_batches(lambda b: b, [np.ones(4, np.float32)], scheduler=_RemoteSched())


def test_torch_route_batches_percolate_false_skips_device_put(device):
    sched = Scheduler([device], policy="static")
    marker = np.ones(4, np.float32)
    [kept] = route_batches(lambda b: b is marker, [marker], scheduler=sched, percolate=False)
    assert kept.get(timeout=T) is True
    [placed] = route_batches(lambda b: b, [marker], scheduler=sched)
    out = placed.get(timeout=T)
    assert out is not marker and isinstance(out, torch.Tensor) and out.device == device.torch_device


@pytest.mark.skip(reason="ROADMAP Queue 1 item 10")
def test_torch_route_batches_kernel_name_local_matches_loopback():
    from repro_torch.core import LoopbackParcelport

    x = np.random.default_rng(6).normal(size=(64,)).astype(np.float32)
    dev = get_all_devices(platform="cpu").get(timeout=T)[0]
    [local] = route_batches("partition_map_ref", [x], scheduler=Scheduler([dev], policy="static"))
    local_val = np.asarray(local.get(timeout=T))
    port = LoopbackParcelport(n_localities=1)
    try:
        [remote] = route_batches("partition_map_ref", [x],
                                 scheduler=Scheduler(port.devices(), policy="static"))
        remote_val = np.asarray(remote.get(timeout=T))
    finally:
        port.shutdown()
    np.testing.assert_array_equal(remote_val, local_val)


def test_torch_route_batches_refuses_kernel_names_and_clusters(device):
    sched = Scheduler([device], policy="static")
    with pytest.raises(NotImplementedError, match="item 10"):
        route_batches("partition_map_ref", [np.ones(4, np.float32)], scheduler=sched)
    with pytest.raises(NotImplementedError, match="item 10"):
        route_batches(lambda b: b, [np.ones(4, np.float32)], cluster=object())


def test_torch_route_batches_places_every_batch(device):
    sched = Scheduler([device], policy="round_robin")
    batches = [{"x": np.full(4, i, np.float32)} for i in range(3)]
    futs = route_batches(lambda b: b["x"] * 2.0, batches, scheduler=sched)
    vals = [np.asarray(f.get(timeout=T)) for f in futs]
    for i, v in enumerate(vals):
        np.testing.assert_allclose(v, np.full(4, 2.0 * i))
    assert sched.stats() == {device.key: 3}


def test_torch_route_batches_matches_reference(device):
    jdev = jax_get_all_devices(1, 0).get(timeout=T)[0]
    rng = np.random.default_rng(8)
    batches = [{"x": rng.normal(size=(3, 5)).astype(np.float32), "s": np.float32(i + 0.5)}
               for i in range(4)]
    fn = lambda b: b["x"] * b["s"] + 1.0  # noqa: E731
    want = [np.asarray(f.get(timeout=T))
            for f in jserving.route_batches(fn, batches, scheduler=JaxScheduler([jdev]))]
    got = [f.get(timeout=T).numpy()
           for f in route_batches(fn, batches, scheduler=Scheduler([device]))]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# parcels: the reference's loopback / cluster tests wait for item 10
# ---------------------------------------------------------------------------


def test_torch_engine_refuses_kernel_names_clusters_and_remote_placement():
    with pytest.raises(NotImplementedError, match="item 10"):
        RequestEngine("partition_map_ref")
    with pytest.raises(NotImplementedError, match="item 10"):
        RequestEngine({"a": _linear_step, "b": "partition_map_ref"})
    with pytest.raises(NotImplementedError, match="item 10"):
        RequestEngine(_linear_step, cluster=object())
    eng = RequestEngine(_linear_step, max_delay_s=0.001, scheduler=_RemoteSched(), name="t-rem")
    try:
        f = eng.submit(np.ones((1, 4), np.float32))
        with pytest.raises(NotImplementedError, match="item 10"):
            f.get(timeout=T)
        assert eng.metrics()["requests_failed"] == 1
    finally:
        eng.close()


@pytest.mark.skip(reason="ROADMAP Queue 1 item 10")
def test_torch_engine_spreads_micro_batches_over_loopback_localities():
    from repro_torch.core import LoopbackParcelport

    port = LoopbackParcelport(n_localities=2)
    try:
        sched = Scheduler(port.devices(), policy="round_robin")
        eng = RequestEngine(_linear_step, max_batch=2, max_delay_s=0.005, scheduler=sched,
                            name="t-loop")
        try:
            futs = [eng.submit(np.full((1, 8), float(i), np.float32)) for i in range(8)]
            for i, f in enumerate(futs):
                np.testing.assert_array_equal(f.get(timeout=T),
                                              _linear_ref(np.full((1, 8), float(i))))
            assert len(sched.stats()) == 2
        finally:
            eng.close()
    finally:
        port.shutdown()


@pytest.mark.skip(reason="ROADMAP Queue 1 item 10")
def test_torch_apply_batched_action_slices_rows_per_request():
    from repro_torch.core import LoopbackParcelport

    port = LoopbackParcelport(n_localities=1)
    try:
        lid = port.localities()[0].process_index
        batch = np.arange(12, dtype=np.float32).reshape(4, 3)  # 3 real + 1 pad row
        chunks = port.call(lid, "apply_batched",
                           {"kernel": "partition_map_ref", "batch": batch, "rows": [1, 2]}
                           ).get(timeout=T)
        assert [c.shape for c in chunks] == [(1, 3), (2, 3)]
    finally:
        port.shutdown()


@pytest.mark.skip(reason="ROADMAP Queue 1 item 10")
def test_torch_engine_serves_over_2_process_cluster_bit_equal():
    from repro_torch.core import LocalClusterParcelport
    from repro_torch.kernels.partition_map.ref import partition_map_ref

    port = LocalClusterParcelport(n_workers=2, heartbeat_timeout=60.0)
    try:
        sched = Scheduler(port.devices(), policy="round_robin")
        eng = RequestEngine(partition_map_ref, max_batch=4, max_delay_s=0.01, scheduler=sched,
                            name="t-cluster")
        try:
            rng = np.random.default_rng(5)
            payloads = [rng.normal(size=(1, 16)).astype(np.float32) for _ in range(8)]
            futs = [eng.submit(p) for p in payloads]
            for p, f in zip(payloads, futs):
                want = partition_map_ref(torch.from_numpy(p)).numpy()
                assert np.array_equal(f.get(timeout=300), want)
            assert len(sched.stats()) == 2
        finally:
            eng.close()
    finally:
        port.shutdown()


# ---------------------------------------------------------------------------
# 8 logical CPU devices (the reference's forced 8 host devices), in a
# subprocess as the reference runs it
# ---------------------------------------------------------------------------

_CHILD = textwrap.dedent(
    """
    import os
    os.environ["REPRO_LOGICAL_DEVICES"] = "8"
    import numpy as np
    from repro_torch.core import Scheduler, get_all_devices
    from repro_torch.serving import RequestEngine

    devices = get_all_devices(platform="cpu").get(timeout=60)
    assert len(devices) == 8, devices

    sched = Scheduler(devices, policy="least_loaded")
    eng = RequestEngine(lambda x: x * 2.0 + 1.0, max_batch=4, max_delay_s=0.002,
                        scheduler=sched, name="fleet")
    try:
        rng = np.random.default_rng(0)
        payloads = [rng.normal(size=(1, 256)).astype(np.float32) for _ in range(64)]
        futs = [eng.submit(p) for p in payloads]
        for p, f in zip(payloads, futs):
            got = f.get(timeout=60)
            want = p * 2.0 + 1.0
            assert got.dtype == want.dtype and np.array_equal(got, want)
        m = eng.metrics()
        spread = sched.stats()
        print("SPREAD", len(spread), "BATCHES", m["batches"])
        assert m["requests_completed"] == 64
        assert m["batches"] < 64
        # ONE request stream = ONE route: sticky placement pins it to one
        # device instead of spraying the fleet.
        assert len(spread) == 1, spread
    finally:
        eng.close()
    print("OK")
    """
)


def test_torch_engine_integration_8_logical_cpu_devices():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(root, "src") + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _CHILD], capture_output=True, text=True,
                          env=env, cwd=root, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "OK" in proc.stdout, proc.stdout


# ---------------------------------------------------------------------------
# serving: the port against the JAX package on the same inputs
# ---------------------------------------------------------------------------


def _models(arch):
    jc = jcfg.smoke(jcfg.get_config(arch))
    tc = tcfg.smoke(tcfg.get_config(arch))
    jparams = jax_get_model(jc).init(jc, jax.random.key(0))
    tparams = params_from_numpy(tc, jax.tree.map(np.asarray, jparams), device="cpu")
    return jc, tc, jparams, tparams


def _decode_requests(jc, positions, seed=0):
    """Seeded numpy decode requests in request layout: a random cache of 8
    slots (the JAX ``init_cache``'s shapes), one token, ``pos``."""
    rng = np.random.default_rng(seed)
    shapes = jax.tree.map(lambda a: a.shape, jax_get_model(jc).init_cache(jc, 1, 8,
                                                                         dtype=jnp.float32))
    reqs = []
    for pos in positions:
        cache = {k: np.moveaxis(rng.normal(size=s).astype(np.float32), 1, 0)
                 for k, s in shapes.items()}
        tok = rng.integers(0, jc.vocab_size, size=(1, 1)).astype(np.int32)
        reqs.append({"cache": cache, "tokens": tok, "pos": np.int32(pos)})
    return reqs


@pytest.mark.parametrize("arch", ["olmo-1b", "mamba2-130m"])
def test_torch_make_serve_engine_matches_reference_engine(device, arch):
    jc, tc, jparams, tparams = _models(arch)
    reqs = _decode_requests(jc, [3, 3, 5, 3])
    jdev = jax_get_all_devices(1, 0).get(timeout=T)[0]
    jeng = jserving.make_serve_engine(jc, jparams, max_batch=4, max_delay_s=0.02,
                                      scheduler=JaxScheduler([jdev]))
    try:
        want = [f.get(timeout=300) for f in [jeng.submit(r, kind="decode") for r in reqs]]
    finally:
        jeng.close()
    eng = make_serve_engine(tc, tparams, max_batch=4, max_delay_s=0.2,
                            scheduler=Scheduler([device], policy="least_loaded"))
    try:
        got = [f.get(timeout=T) for f in [eng.submit(r, kind="decode") for r in reqs]]
        assert eng.metrics()["batches"] == 2  # pos 3 (three rows) and pos 5
        assert eng.name == f"serve:{tc.name}" and not eng._graphs
    finally:
        eng.close()
    for g, w in zip(got, want):
        assert g["next"].shape == (1, 1) and g["next"].dtype == np.int32
        np.testing.assert_array_equal(g["next"], np.asarray(w["next"]))
        np.testing.assert_allclose(g["logits"], np.asarray(w["logits"]), **TOL)
        for k in w["cache"]:
            np.testing.assert_allclose(g["cache"][k], np.asarray(w["cache"][k]), **TOL)


def test_torch_make_serve_engine_batched_decode_matches_per_request(device):
    """The port's batch of three against each request decoded alone by
    ``make_serve_step`` (tests/test_engine.py:402)."""
    tc = tcfg.smoke(tcfg.get_config("olmo-1b"))
    m = get_model(tc)
    params = m.init(tc, generator=torch.Generator().manual_seed(0), device="cpu")
    step = make_serve_step(tc, params)
    eng = make_serve_engine(tc, params, max_batch=4, max_delay_s=0.02,
                            scheduler=Scheduler([device], policy="least_loaded"))
    try:
        gen = torch.Generator().manual_seed(1)
        reqs = [{"cache": cache_to_rows(m.init_cache(tc, 1, 8, dtype=torch.float32,
                                                     device="cpu")),
                 "tokens": torch.randint(0, tc.vocab_size, (1, 1), generator=gen,
                                         dtype=torch.int32),
                 "pos": np.int32(0)} for _ in range(3)]
        futs = [eng.submit(r, kind="decode") for r in reqs]
        for r, f in zip(reqs, futs):
            got = f.get(timeout=T)
            nxt, logits, cache = step(rows_to_cache(r["cache"]), r["tokens"], 0)
            np.testing.assert_array_equal(got["next"], nxt.numpy())
            np.testing.assert_allclose(got["logits"], logits.numpy(), **TOL)
            for k, v in cache_to_rows(cache).items():
                np.testing.assert_allclose(got["cache"][k], v.numpy(), **TOL)
    finally:
        eng.close()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_cache_rows_round_trip_matches_reference(dtype):
    rng = np.random.default_rng(2)
    bits = rng.normal(size=(3, 2, 5, 4)).astype(np.float32)
    jx = jnp.asarray(bits, dtype)
    tx = torch.from_numpy(bits)
    if dtype == "bfloat16":  # the same bits on both sides
        tx = torch.from_numpy(np.array(jx).view(np.uint16)).view(torch.bfloat16)
    cache = {"k": tx, "v": tx + 1}
    jcache = {"k": jx, "v": jx + 1}
    rows = cache_to_rows(cache)
    jrows = jserving.cache_to_rows(jcache)
    for k in cache:
        assert rows[k].dtype == tx.dtype and rows[k].shape == (2, 3, 5, 4)
        got = rows[k].contiguous().view(torch.int16 if dtype == "bfloat16" else torch.int32)
        want = np.asarray(jrows[k]).view(np.int16 if dtype == "bfloat16" else np.int32)
        np.testing.assert_array_equal(got.numpy(), want)
        assert torch.equal(rows_to_cache(rows)[k], cache[k])


def test_torch_make_serve_fanout_matches_reference(device):
    jc, tc, jparams, tparams = _models("olmo-1b")
    reqs = _decode_requests(jc, [2, 6], seed=3)
    jdev = jax_get_all_devices(1, 0).get(timeout=T)[0]
    jfan = jserving.make_serve_fanout(jc)
    want = [f.get(timeout=300) for f in jfan(
        [(jparams, jserving.rows_to_cache(r["cache"]), r["tokens"], r["pos"]) for r in reqs],
        scheduler=JaxScheduler([jdev]))]
    fan = make_serve_fanout(tc)
    futs = fan([(tparams, rows_to_cache(r["cache"]), r["tokens"], r["pos"]) for r in reqs],
               scheduler=Scheduler([device]))
    for f, (wn, wl, wc) in zip(futs, want):
        nxt, logits, cache = f.get(timeout=T)
        np.testing.assert_array_equal(nxt.numpy(), np.asarray(wn))
        np.testing.assert_allclose(logits.numpy(), np.asarray(wl), **TOL)
        for k in wc:
            np.testing.assert_allclose(cache[k].numpy(), np.asarray(wc[k]), **TOL)


def test_torch_serving_engine_example_runs_on_cpu(capsys):
    import importlib.util

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(root, "examples", "torch_serving_engine.py")
    spec = importlib.util.spec_from_file_location("torch_serving_engine", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    assert example.main(cpu=True) == 0
    assert "results bit-equal" in capsys.readouterr().out

# ---------------------------------------------------------------------------
# the smoke's engine and serve_engine phases, rehearsed on the CPU at smoke
# size (on the card they also hold the CUDA graphs and the kernel counts)
# ---------------------------------------------------------------------------


def test_torch_smoke_engine_phases_rehearsed_on_cpu(device, monkeypatch):
    import importlib.util

    from repro_torch.core import reset_runtime

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    monkeypatch.setattr(smoke, "get_config", lambda a: tcfg.smoke(tcfg.get_config(a)))
    monkeypatch.setattr(smoke, "ENGINE_N", 1024)
    monkeypatch.setattr(smoke, "SERVE_ENGINE_PROMPT", 16)
    monkeypatch.setattr(smoke, "SERVE_ENGINE_BUDGET", 64)
    try:
        e = smoke.phase_engine(device)
        s = smoke.phase_serve_engine(device)
    finally:
        reset_runtime()  # the fan-out split the CPU into logical devices
    assert e["results_bit_equal"] == e["results_bit_equal_plain"] == 128 and e["on_engine_stream"]
    assert set(e["buckets"]) <= {1, 2, 4, 8} and e["engine"]["batches"] < 64
    assert s["prefill"] == {"batches": 1, "mean_batch_rows": 4.0}
    assert s["decode"]["batches"] == 8 and s["decode"]["mean_batch_rows"] == 4.0
    assert s["max_abs_logit_err_vs_alone_plain"] <= 2e-4 and s["fanout"]["tokens_equal"] == 4
    assert len(s["fanout"]["placed"]) == 2
