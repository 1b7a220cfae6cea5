"""The port's streams & events, held to the CPU-runnable cases of
``tests/test_stream.py``: same-stream FIFO, cross-stream event
happens-before (property-based), real lane concurrency, the
all-streams ``Device.synchronize`` and coalescing.  The graph and remote
cases belong to later slices.  On the CPU device a stream is a host lane
without a CUDA stream; the CUDA half is checked on the card by
``chip_smoke.py``."""
import threading
import time

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ModuleNotFoundError:  # minimal container: seeded fallback sweeps
    from _hypothesis_compat import given, settings, strategies as st

from repro_torch.core import Device, Event, Stream, coalesce, get_all_devices


def _cpu():
    return get_all_devices(platform="cpu").get()[0]


@pytest.fixture(scope="module")
def device():
    return _cpu()


@pytest.fixture()
def prog(device):
    return device.create_program(
        {"double": lambda x: x * 2.0, "inc": lambda x: x + 1.0, "axpy": lambda x, y: x + y},
        name="stream-test",
    ).get()


# ---------------------------------------------------------------------------
# cross-stream write after read
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reader", ["read", "launch"])
def test_torch_write_after_read_on_another_stream_sees_old_data(device, prog, reader):
    """A read or launch dispatched on stream A is not overtaken by a later
    in-place write on stream B: it sees the contents from before the write.
    (On a CUDA device the write waits for A's read on the device; the card
    half of this test is in ``test_torch_cuda.py``.)"""
    a, b = device.create_stream(), device.create_stream()
    old = np.arange(64, dtype=np.float32)
    buf = device.create_buffer_from(old).get()
    out = device.create_buffer(64, np.float32).get()
    if reader == "read":
        fut = a.enqueue_read(buf)
    else:
        fut = a.launch(prog, [buf], "double", out=[out], sync="dispatch")
    a.submit(lambda: None).get()  # stream A's lane has dispatched the reader
    b.enqueue_write(buf, 0, np.zeros(64, np.float32)).get()
    got = fut.get() if reader == "read" else out.enqueue_read_sync()
    np.testing.assert_array_equal(got, old if reader == "read" else old * 2)
    np.testing.assert_array_equal(buf.enqueue_read_sync(), np.zeros(64, np.float32))


# ---------------------------------------------------------------------------
# same-stream FIFO ordering
# ---------------------------------------------------------------------------


def test_torch_default_stream_is_ops_queue(device):
    assert device.default_stream.lane is device.ops_queue
    assert device.default_stream in device.streams()


def test_torch_same_stream_fifo_host_callbacks(device):
    s = device.create_stream()
    seen = []
    futs = [s.submit(lambda i=i: seen.append(i)) for i in range(64)]
    futs[-1].get()
    assert seen == list(range(64))


class _ReadThrough:
    """Write payload that materializes the CURRENT value of another buffer
    when the write task runs — valid only because same-stream FIFO
    guarantees the producing launch already completed."""

    def __init__(self, buf):
        self.buf = buf

    def __array__(self, dtype=None, copy=None):
        return self.buf.array().numpy()


@settings(max_examples=10, deadline=None)
@given(n_ops=st.integers(min_value=1, max_value=12), seed=st.integers(min_value=0, max_value=2**16))
def test_torch_same_stream_fifo_random_op_mix(n_ops, seed):
    """Any random interleave of writes/launches/reads on ONE stream
    observes strict submission order."""
    device = _cpu()
    prog = device.create_program({"inc": lambda x: x + 1.0}, name="fifo-prop").get()
    rng = np.random.default_rng(seed)
    s = device.create_stream()
    n = 32
    buf = device.create_buffer(n, np.float32).get()
    out = device.create_buffer(n, np.float32).get()
    s.enqueue_write(buf, 0, np.zeros(n, np.float32))

    expect = np.zeros(n, np.float32)
    checks = []
    for _ in range(n_ops):
        op = rng.integers(0, 3)
        if op == 0:
            payload = rng.normal(size=(n,)).astype(np.float32)
            s.enqueue_write(buf, 0, payload)
            expect = payload
        elif op == 1:
            s.launch(prog, [buf], "inc", out=[out])
            s.enqueue_write(buf, 0, _ReadThrough(out))
            expect = expect + 1.0
        else:
            checks.append((s.enqueue_read(buf), expect.copy()))
    checks.append((s.enqueue_read(buf), expect.copy()))
    for fut, want in checks:
        np.testing.assert_allclose(fut.get(), want, rtol=1e-6)


# ---------------------------------------------------------------------------
# cross-stream event happens-before
# ---------------------------------------------------------------------------


def test_torch_event_record_wait_query(device):
    s1, s2 = device.create_stream(), device.create_stream()
    gate = threading.Event()
    s1.submit(gate.wait)  # s1 is stuck until we say go
    e = s1.record()
    assert isinstance(e, Event)
    assert not e.query()

    seen = []
    s2.wait_event(e)
    after = s2.submit(lambda: seen.append("after-event"))
    time.sleep(0.05)
    assert seen == []  # s2 must not have run past the gate
    gate.set()
    after.get(timeout=10)
    assert seen == ["after-event"]
    assert e.query()
    e.wait()  # idempotent host wait
    assert e.cuda_event() is None  # a CPU stream records no CUDA event


def test_torch_wait_event_same_stream_is_noop(device):
    s = device.create_stream()
    e = s.record()
    assert s.wait_event(e) is e.future
    s.synchronize()


def test_torch_record_covers_launch_completion(device, prog):
    """An event recorded after a launch fires once the launch's output
    exists: the waiting stream observes it."""
    n = 1 << 12
    s1, s2 = device.create_stream(), device.create_stream()
    a = device.create_buffer(n, np.float32).get()
    out = device.create_buffer(n, np.float32).get()
    host = np.linspace(0.0, 1.0, n).astype(np.float32)
    s1.enqueue_write(a, 0, host)
    s1.launch(prog, [a], "double", out=[out])
    s2.wait_event(s1.record())
    np.testing.assert_allclose(s2.enqueue_read(out).get(), host * 2.0, rtol=1e-6)


def test_torch_record_covers_percolating_launch(device, prog):
    """A launch whose argument lives on another device reaches its lane
    only after the copy; an event recorded right after it still covers it."""
    other = Device(torch.device("cpu"))  # a second device object: a foreign home
    src = other.create_buffer_from(np.full(8, 3.0, np.float32)).get()
    out = device.create_buffer(8, np.float32).get()
    s = device.create_stream()
    prog.run([src], "inc", out=[out], stream=s)
    s.record().wait(timeout=10)
    np.testing.assert_array_equal(out.array().numpy(), np.full(8, 4.0))


@settings(max_examples=8, deadline=None)
@given(
    n_tokens=st.integers(min_value=1, max_value=8),
    delay_ms=st.integers(min_value=0, max_value=20),
)
def test_torch_event_happens_before_property(n_tokens, delay_ms):
    """Everything submitted to s1 before record() is visible to everything
    submitted to s2 after wait_event(), for any producer delay."""
    device = _cpu()
    s1, s2 = device.create_stream(), device.create_stream()
    produced, consumed = [], []

    def produce(i):
        if delay_ms:
            time.sleep(delay_ms / 1000.0)
        produced.append(i)

    for i in range(n_tokens):
        s1.submit(produce, i)
    s2.wait_event(s1.record())
    s2.submit(lambda: consumed.extend(produced)).get(timeout=10)
    assert consumed == list(range(n_tokens))


# ---------------------------------------------------------------------------
# overlap really occurs (concurrent-lane high-water mark)
# ---------------------------------------------------------------------------


def test_torch_streams_overlap_high_water_mark(device):
    s1, s2 = device.create_stream(), device.create_stream()
    device._dispatcher.reset_high_water()
    barrier = threading.Barrier(2, timeout=10)
    f1 = s1.submit(barrier.wait)
    f2 = s2.submit(barrier.wait)
    f1.get(timeout=10)
    f2.get(timeout=10)
    assert device._dispatcher.high_water() >= 2


def test_torch_single_stream_never_overlaps_itself(device):
    s = device.create_stream()
    active, peak = [0], [0]
    lock = threading.Lock()

    def task():
        with lock:
            active[0] += 1
            peak[0] = max(peak[0], active[0])
        time.sleep(0.005)
        with lock:
            active[0] -= 1

    futs = [s.submit(task) for _ in range(16)]
    futs[-1].get(timeout=10)
    assert peak[0] == 1


def test_torch_stream_names_never_share_a_lane(device):
    streams = [device.create_stream("s2"), device.create_stream(),
               device.create_stream("default"), device.create_stream("replay.1")]
    lanes = {id(s.lane) for s in streams} | {id(device.ops_queue)}
    assert len(lanes) == len(streams) + 1


# ---------------------------------------------------------------------------
# Device.synchronize drains ALL streams; misc surface
# ---------------------------------------------------------------------------


def test_torch_device_synchronize_drains_all_streams(device):
    s = device.create_stream()
    done = []
    s.submit(lambda: (time.sleep(0.15), done.append(1)))
    device.synchronize()
    assert done == [1]
    assert s.query()


def test_torch_stream_of_wrong_device_is_refused(device, prog):
    class _OtherDevice:
        key = "not-a-real-device:9"

    bad = Stream(_OtherDevice(), device.ops_queue, name="bad")
    buf = device.create_buffer(8, np.float32).get()
    with pytest.raises(ValueError, match="belongs to device"):
        buf.enqueue_write(0, np.zeros(8, np.float32), stream=bad)
    with pytest.raises(ValueError, match="belongs to device"):
        prog.run([buf], "inc", stream=bad)


def test_torch_program_launch_alias_with_stream(device, prog):
    s = device.create_stream()
    buf = device.create_buffer_from(np.full(16, 2.0, np.float32)).get()
    out = device.create_buffer(16, np.float32).get()
    res = prog.launch([buf], "double", out=[out], stream=s).get()
    np.testing.assert_allclose(res[0].array().numpy(), np.full(16, 4.0))


def test_torch_launch_sync_dispatch_then_same_stream_read(device, prog):
    """``sync="dispatch"`` resolves at submission; a later read on the same
    stream is still ordered behind the launch (fig 3/4's pattern)."""
    buf = device.create_buffer_from(np.arange(8, dtype=np.float32)).get()
    bl = prog.run([buf], "double", out=[buf], sync="dispatch").get()
    assert bl == [buf]
    np.testing.assert_array_equal(buf.enqueue_read().get(), np.arange(8) * 2.0)


def test_torch_device_load_counts_every_lane(device):
    s1, s2 = device.create_stream(), device.create_stream()
    gate = threading.Event()
    f1 = s1.submit(gate.wait)
    f2 = s2.submit(gate.wait)
    time.sleep(0.02)
    try:
        assert device.load().depth >= 2
    finally:
        gate.set()
        f1.get(timeout=10)
        f2.get(timeout=10)


# ---------------------------------------------------------------------------
# submission coalescing across streams
# ---------------------------------------------------------------------------


def test_torch_coalesce_window_over_two_streams_keeps_per_stream_fifo(device):
    s1, s2 = device.create_stream(), device.create_stream()
    seen1, seen2 = [], []
    with coalesce():
        futs = [s1.submit(lambda i=i: seen1.append(i)) for i in range(16)]
        futs += [s2.submit(lambda i=i: seen2.append(i)) for i in range(16)]
    for f in futs:
        f.get(timeout=10)
    assert seen1 == list(range(16))
    assert seen2 == list(range(16))


def test_torch_coalesced_stream_launch_chain_bit_equal(device, prog):
    n = 64
    host = np.random.default_rng(21).normal(size=(n,)).astype(np.float32)
    s = device.create_stream()
    buf = device.create_buffer_from(host).get()
    out = device.create_buffer(n, np.float32).get()
    s.launch(prog, [buf], "double", out=[out])
    want = s.enqueue_read(out).get()

    cout = device.create_buffer(n, np.float32).get()
    with coalesce():
        s.launch(prog, [buf], "double", out=[cout])
        r = s.enqueue_read(cout)
    assert r.get().tobytes() == want.tobytes()


def test_torch_stream_fifo_matches_reference_runtime():
    """The same write/launch/read sequence on one stream gives bit-equal
    results through both packages."""
    import jax.numpy as jnp

    from repro import core as ref

    host = np.random.default_rng(5).normal(size=(128,)).astype(np.float32)

    def run(dev, double):
        prog = dev.create_program({"double": double}, name="fifo-parity").get()
        s = dev.create_stream()
        buf = dev.create_buffer(128, np.float32).get()
        out = dev.create_buffer(128, np.float32).get()
        s.enqueue_write(buf, 0, host)
        s.launch(prog, [buf], "double", out=[out])
        s.enqueue_write(buf, 0, np.zeros(128, np.float32))
        return s.enqueue_read(out).get(), s.enqueue_read(buf).get()

    got = run(_cpu(), lambda x: x * 2.0)
    want = run(ref.get_all_devices().get()[0], lambda x: x * jnp.float32(2.0))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


# ---------------------------------------------------------------------------
# remote streams over the loopback parcel port (tests/test_stream.py:323-380)
# ---------------------------------------------------------------------------


def test_torch_remote_stream_ordering_loopback():
    from repro_torch.core import LoopbackParcelport

    port = LoopbackParcelport(n_localities=1, platform="cpu")
    try:
        rdev = port.localities()[0].devices[0]
        s = rdev.create_stream()
        assert s in rdev.streams() and s is not rdev.default_stream

        n = 128
        buf = rdev.create_buffer(n, np.float32).get()
        # write -> overwrite -> read, all on one channel: FIFO end-to-end
        s.enqueue_write(buf, 0, np.zeros(n, np.float32))
        s.enqueue_write(buf, 0, np.arange(n, dtype=np.float32))
        got = s.enqueue_read(buf).get()
        np.testing.assert_array_equal(got, np.arange(n, dtype=np.float32))

        # launch ordered on the channel behind the write it consumes
        rprog = rdev.create_program(["partition_map_ref"], "stream-loop").get()
        rout = rdev.create_buffer(n, np.float32).get()
        host = np.linspace(0.0, 1.0, n).astype(np.float32)
        s.enqueue_write(buf, 0, host)
        rprog.run([buf], "partition_map_ref", out=[rout], stream=s)
        got = s.enqueue_read(rout).get()
        assert got.shape == (n,)

        # event recorded on a remote stream; another channel waits on it
        s2 = rdev.create_stream()
        s2.wait_event(s.record())
        s2.enqueue_write(buf, 0, np.zeros(n, np.float32))
        assert float(s2.enqueue_read(buf).get().sum()) == 0.0

        rdev.synchronize()  # drains EVERY channel
        assert all(st_.query() for st_ in rdev.streams())
    finally:
        port.shutdown()


@settings(max_examples=5, deadline=None)
@given(n_writes=st.integers(min_value=1, max_value=8), seed=st.integers(min_value=0, max_value=999))
def test_torch_remote_stream_last_write_wins_property(n_writes, seed):
    """Property: N racing writes on ONE remote channel resolve to the
    LAST one — parcel-channel FIFO holds for any count."""
    from repro_torch.core import LoopbackParcelport

    port = LoopbackParcelport(n_localities=1, platform="cpu")
    try:
        rdev = port.localities()[0].devices[0]
        s = rdev.create_stream()
        buf = rdev.create_buffer(16, np.float32).get()
        rng = np.random.default_rng(seed)
        last = None
        for _ in range(n_writes):
            last = rng.normal(size=(16,)).astype(np.float32)
            s.enqueue_write(buf, 0, last)
        np.testing.assert_array_equal(s.enqueue_read(buf).get(), last)
    finally:
        port.shutdown()
