"""The port's futurization layer (``repro_torch.core.futures``), held to
the reference's contract: every case of ``tests/test_futures.py`` runs
against the port, plus ``Future.from_tensor`` and one DAG evaluated by
both packages on the same inputs."""
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core import (
    Future,
    FutureState,
    Promise,
    async_,
    dataflow,
    get_runtime,
    make_ready_future,
    wait_all,
    when_all,
    when_any,
)


def test_torch_ready_future():
    f = make_ready_future(42)
    assert f.done() and f.is_ready()
    assert f.get() == 42
    assert f.state is FutureState.READY


def test_torch_failed_future_raises_on_get():
    f = Future.failed(ValueError("boom"))
    assert f.state is FutureState.FAILED
    with pytest.raises(ValueError, match="boom"):
        f.get()
    assert isinstance(f.exception(), ValueError)


def test_torch_async_runs_on_pool():
    ident = async_(lambda: threading.current_thread().name).get()
    assert "repro-host" in ident  # the port keeps the pool name


def test_torch_then_chains_and_propagates_values():
    f = async_(lambda: 3).then(lambda v: v + 1).then(lambda v: v * 2)
    assert f.get() == 8


def test_torch_then_propagates_failure_without_calling_fn():
    called = []
    f = Future.failed(RuntimeError("x")).then(lambda v: called.append(v))
    with pytest.raises(RuntimeError):
        f.get()
    assert called == []


def test_torch_promise():
    p = Promise()
    f = p.get_future()
    assert not f.done()
    p.set_value("v")
    assert f.get() == "v"


def test_torch_when_all_collects_in_order():
    fs = [async_(lambda i=i: (time.sleep(0.01 * (3 - i)), i)[1]) for i in range(3)]
    assert when_all(fs).get() == [0, 1, 2]


def test_torch_when_all_empty():
    assert when_all([]).get() == []


def test_torch_when_all_fails_fast():
    fs = [make_ready_future(1), Future.failed(KeyError("k"))]
    with pytest.raises(KeyError):
        when_all(fs).get()


def test_torch_when_any_returns_first():
    slow = async_(lambda: (time.sleep(0.2), "slow")[1])
    fast = make_ready_future("fast")
    idx, val = when_any([slow, fast]).get()
    assert (idx, val) == (1, "fast")


def test_torch_wait_all_blocks_until_done():
    done = []
    fs = [async_(lambda i=i: done.append(i)) for i in range(4)]
    wait_all(fs)
    assert sorted(done) == [0, 1, 2, 3]


def test_torch_dataflow_mixes_futures_and_values():
    a = async_(lambda: 10)
    out = dataflow(lambda x, y, z=0: x + y + z, a, 5, z=async_(lambda: 1))
    assert out.get() == 16


def test_torch_dataflow_chain_builds_graph():
    a = async_(lambda: torch.arange(4.0))
    b = dataflow(torch.sum, a)
    c = dataflow(lambda x, y: x + y, b, 4.0)
    assert float(c.get()) == 10.0


def test_torch_from_tensor_resolves_to_ready_value():
    x = torch.ones((8, 8)) @ torch.ones((8, 8))
    f = Future.from_tensor(x)
    assert not f.done()  # lazy: nothing waited for until asked
    np.testing.assert_allclose(f.get().numpy(), 8.0)


def test_torch_from_tensor_then_continuation():
    x = torch.full((4,), 2.0)
    got = Future.from_tensor(x).then(lambda a: float(torch.sum(a))).get()
    assert got == 8.0


def test_torch_from_tensor_waits_on_the_given_event():
    class _Event:
        def __init__(self):
            self.synced = 0

        def synchronize(self):
            self.synced += 1

    ev = _Event()
    x = torch.zeros(3)
    assert Future.from_tensor([x], event=ev).get()[0] is x
    assert ev.synced == 1


def test_torch_dataflow_dag_matches_reference():
    """The same DAG over the same numpy inputs gives the same values
    through both packages' futures."""
    from repro import core as ref
    from repro_torch import core as port

    rng = np.random.default_rng(3)
    xs = [rng.normal(size=(16,)).astype(np.float32) for _ in range(4)]

    def dag(mod):
        parts = [mod.async_(lambda x=x: x * 2.0) for x in xs]
        total = mod.dataflow(lambda *v: np.sum(v, axis=0), *parts)
        return mod.when_all([total, mod.make_ready_future(1.0)]).then(lambda r: r[0] + r[1]).get()

    np.testing.assert_array_equal(dag(ref), dag(port))


def test_torch_future_exception_inside_dataflow():
    def bad(_):
        raise ZeroDivisionError

    f = dataflow(bad, make_ready_future(1))
    with pytest.raises(ZeroDivisionError):
        f.get()


def test_torch_work_queue_preserves_fifo_order():
    q = get_runtime().queue("test-fifo")
    seen = []
    futs = [q.submit(lambda i=i: seen.append(i)) for i in range(32)]
    wait_all(futs)
    assert seen == list(range(32))


def test_torch_work_queue_survives_task_exception():
    q = get_runtime().queue("test-exc")
    bad = q.submit(lambda: 1 / 0)
    good = q.submit(lambda: "ok")
    with pytest.raises(ZeroDivisionError):
        bad.get()
    assert good.get() == "ok"


# ---------------------------------------------------------------------------
# cancellation (serving-engine backpressure contract)
# ---------------------------------------------------------------------------


def test_torch_cancel_pending_future_and_promise_discards_late_result():
    import concurrent.futures as cf

    p = Promise(name="cancel-me")
    f = p.get_future()
    assert f.cancel() and f.cancelled()
    assert f.cancel()  # idempotent (stdlib semantics: still cancelled)
    with pytest.raises(cf.CancelledError):
        f.get()
    assert isinstance(f.exception(), cf.CancelledError)
    assert f.state is FutureState.FAILED
    p.set_value(42)  # late result is discarded, never raised
    p.set_exception(RuntimeError("late error too"))


def test_torch_cancel_completed_future_returns_false():
    assert not make_ready_future(1).cancel()
    p = Promise()
    p.set_value(2)
    assert not p.get_future().cancel()


def test_torch_then_attached_before_cancel_fails_with_cancelled_error():
    import concurrent.futures as cf

    p = Promise(name="parent")
    f = p.get_future()
    g = f.then(lambda v: v + 1)  # pending path: callback registered
    assert f.cancel()
    with pytest.raises(cf.CancelledError):
        g.get(timeout=10)  # must resolve, not hang forever


def test_torch_cancel_racing_inflight_resolver_discards_result():
    import concurrent.futures as cf

    started = threading.Event()

    def slow_resolver():
        started.set()
        time.sleep(0.2)
        return 42

    f = Future(resolver=slow_resolver, name="slow")
    outcome = []

    def consume():
        try:
            outcome.append(("value", f.get()))
        except cf.CancelledError:
            outcome.append(("cancelled", None))
        except BaseException as e:  # noqa: BLE001
            outcome.append(("error", e))

    t = threading.Thread(target=consume)
    t.start()
    started.wait(10)  # the consumer claimed the resolver and is producing
    assert f.cancel()
    t.join(10)
    # the produced value is discarded; the consumer sees CancelledError,
    # never InvalidStateError
    assert outcome == [("cancelled", None)]


def test_torch_when_all_propagates_cancellation():
    import concurrent.futures as cf

    p1, p2 = Promise(), Promise()
    joined = when_all([p1.get_future(), p2.get_future()])
    p1.get_future().cancel()
    p2.set_value(1)
    assert isinstance(joined.exception(timeout=10), cf.CancelledError)
