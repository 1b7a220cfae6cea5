"""The port's parcel transport and remote actions (``repro_torch.core.parcel``
and the remote halves of device, program, buffer, stream, scheduler and
graph) on the CPU: the 43 tests of ``tests/test_parcel.py`` aimed at the
port, every port on ``platform="cpu"`` (the workers of a
``LocalClusterParcelport`` are spawned processes that discover the CPU),
module-scoped ports shared as the reference's are.

Then the port against the JAX package: the codec's bytes equal the
reference's for every value the reference encodes, and each side loads the
other's frames; a bfloat16 tensor round trip, bit for bit; stencil,
partition_map and mandelbrot launched by name through a loopback locality
of each package on the same seeded inputs (mandelbrot bit-equal, the other
two at the reference kernel tests' tolerances); the shared-memory guard
taking the inline lane when ``/dev/shm`` has no room (``os.statvfs``
patched); a cluster of CUDA localities refused where there is no card; a
graph plan over this locality and a worker held to the JAX package's two
functions; and a worker's buffer read as a graph's extern input.
"""
import time

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ModuleNotFoundError:  # minimal container: seeded fallback sweeps
    from _hypothesis_compat import given, settings, strategies as st

import repro.core.parcel as jparcel
from repro_torch.core import (
    LocalClusterParcelport,
    LoopbackParcelport,
    Parcel,
    Program,
    QueueLoad,
    RemoteProgram,
    Scheduler,
    get_all_devices,
    get_all_localities,
    locality_of,
    register_kernel,
    registry,
    wait_all,
)
from repro_torch.core import parcel as tparcel
from repro_torch.core.futures import Future
from repro_torch.core.parcel import (
    RemoteError,
    decode_parcel,
    dumps,
    encode_parcel,
    loads,
    resolve_kernel,
)
from repro_torch.core.scheduler import PercolationPolicy, locality_of_key

CPU = "cpu"


def _cpu_device():
    return get_all_devices(platform=CPU).get()[0]


# ---------------------------------------------------------------------------
# codec: unit + property-based round trips
# ---------------------------------------------------------------------------

# every dtype the kernels/ packages touch (float32/int32) plus common wire
# companions; arrays of each must round-trip bit-exactly
_KERNEL_DTYPES = ["<f4", "<i4", "<f8", "<i8", "<f2", "|u1", "|b1"]

_CODEC_VALUES = [
    None, True, False, 0, -1, 2**70, -(2**70), 3.5, float("inf"),
    complex(1.0, -2.0), "héllo", b"\x00\xff", (), [], {},
    [1, "a", (2.0, None)], {"k": [True, {"n": b"x"}], 7: "seven"},
]


def test_torch_codec_scalars_and_containers_roundtrip():
    for v in _CODEC_VALUES:
        assert loads(dumps(v)) == v, v
    # NaN needs its own comparison
    out = loads(dumps(float("nan")))
    assert isinstance(out, float) and np.isnan(out)


def test_torch_codec_numpy_scalars_keep_dtype():
    for v in (np.float32(1.5), np.int32(-7), np.float16(0.25), np.uint8(255)):
        out = loads(dumps(v))
        assert out.dtype == v.dtype and out == v


def test_torch_codec_rejects_object_dtype_and_unknown_types():
    with pytest.raises(ValueError, match="not parcel-encodable"):
        dumps(np.array([object()]))
    with pytest.raises(ValueError, match="not parcel-encodable"):
        dumps(lambda: None)  # no code on the wire, ever


def test_torch_codec_zero_dim_arrays_keep_rank():
    # np.ascontiguousarray silently promotes 0-d to (1,); the codec must
    # not (apply_batched replies carry 0-d output leaves)
    for v in (np.zeros((), np.float32), np.array(7, np.int64)):
        out = loads(dumps(v))
        assert out.shape == () and out.dtype == v.dtype and out == v


def test_torch_codec_noncontiguous_arrays_roundtrip():
    a = np.arange(24, dtype=np.float32).reshape(4, 6)[:, ::2]  # strided view
    np.testing.assert_array_equal(loads(dumps(a)), a)
    f = np.asfortranarray(np.arange(12, dtype=np.int32).reshape(3, 4))
    np.testing.assert_array_equal(loads(dumps(f)), f)


@settings(max_examples=25, deadline=None)
@given(
    descr=st.sampled_from(_KERNEL_DTYPES),
    n=st.integers(min_value=0, max_value=257),
    seed=st.integers(min_value=0, max_value=2**16),
)
def test_torch_codec_array_roundtrip_is_bit_exact(descr, n, seed):
    rng = np.random.default_rng(seed)
    dt = np.dtype(descr)
    if dt.kind == "b":
        arr = rng.integers(0, 2, size=n).astype(dt)
    elif dt.kind in "iu":
        arr = rng.integers(0, 100, size=n).astype(dt)
    else:
        arr = rng.normal(size=n).astype(dt)
    out = loads(dumps(arr))
    assert out.dtype == arr.dtype and out.shape == arr.shape
    assert out.tobytes() == arr.tobytes()  # bit-exact, not just allclose
    # a tensor of the same values encodes to the array's bytes
    assert dumps(torch.from_numpy(arr.copy())) == dumps(arr)


@settings(max_examples=15, deadline=None)
@given(
    name=st.sampled_from(
        ["mandelbrot", "mandelbrot_ref", "partition_map", "stencil", "ssd", "flash_attention"]
    )
)
def test_torch_codec_kernel_name_refs_roundtrip_and_resolve(name):
    blob = dumps({"kernel": name, "args": [("gid", 7), ("val", 1.5)]})
    out = loads(blob)
    assert out["kernel"] == name and out["args"][0] == ("gid", 7)
    assert callable(resolve_kernel(out["kernel"]))
    assert resolve_kernel(name).__module__.startswith("repro_torch.kernels.")


@settings(max_examples=15, deadline=None)
@given(
    exc_i=st.integers(min_value=0, max_value=4),
    msg=st.sampled_from(["boom", "", "unicode-ø", "two words"]),
)
def test_torch_codec_exceptions_roundtrip_by_type(exc_i, msg):
    cls = [KeyError, ValueError, RuntimeError, IndexError, ZeroDivisionError][exc_i]
    out = loads(dumps(cls(msg)))
    assert type(out) is cls and out.args == (msg,)


def test_torch_codec_unknown_exception_degrades_to_remote_error():
    class Private(Exception):  # not importable on a "remote" locality
        pass

    out = loads(dumps(Private("secret")))
    assert isinstance(out, (Private, RemoteError))  # same-process resolves; else carrier


def test_torch_parcel_frame_roundtrip():
    p = Parcel("launch", {"kernel": "k", "args": [("val", np.ones(3, np.float32))]},
               pid=42, locality=3)
    q = decode_parcel(encode_parcel(p))
    assert (q.action, q.pid, q.locality, q.ok) == ("launch", 42, 3, True)
    np.testing.assert_array_equal(q.payload["args"][0][1], np.ones(3, np.float32))
    bad = decode_parcel(encode_parcel(Parcel("reply", {"error": KeyError("gone")}, 1, 2, ok=False)))
    assert not bad.ok and type(bad.payload["error"]) is KeyError


def test_torch_codec_rejects_corrupt_frames():
    with pytest.raises(ValueError, match="corrupt parcel"):
        loads(b"\x7fgarbage")
    with pytest.raises(ValueError, match="trailing"):
        loads(dumps(1) + b"x")


# ---------------------------------------------------------------------------
# percolation policy: the localities × devices grid (duck-typed fakes)
# ---------------------------------------------------------------------------


class _FakeQueue:
    def __init__(self, depth=0):
        self.depth = depth

    def load(self):
        return QueueLoad(depth=self.depth, inflight=0, busy_for=0.0, busy_time=0.0,
                         submitted=self.depth, completed=0)


class _FakeDevice:
    def __init__(self, key, depth=0, alive=True):
        self.key = key
        self.ops_queue = _FakeQueue(depth)
        self._alive = alive

    def alive(self):
        return self._alive


class _FakeBuf:
    def __init__(self, device, nbytes):
        self.device, self.nbytes = device, nbytes


def test_torch_locality_of_key():
    assert locality_of_key("cpu:0") == 0
    assert locality_of_key("L3/cpu:0") == 3
    assert locality_of_key("L12/cuda:5") == 12
    assert locality_of_key(None) == 0


def test_torch_percolation_policy_prefers_the_data_home():
    local = _FakeDevice("cpu:0")
    r1, r2 = _FakeDevice("L1/cpu:0"), _FakeDevice("L2/cpu:0")
    args = [_FakeBuf(r1, 1 << 20)]
    assert PercolationPolicy().select([local, r1, r2], args=args).key == "L1/cpu:0"


def test_torch_percolation_policy_charges_cross_locality_moves_more():
    # candidate L1 pays 200KB * 8 (cross); candidate local pays 1MB * 8
    local = _FakeDevice("cpu:0")
    r1 = _FakeDevice("L1/cpu:0")
    args = [_FakeBuf(r1, 1 << 20), _FakeBuf(local, 200 << 10)]
    assert PercolationPolicy().select([local, r1], args=args).key == "L1/cpu:0"


def test_torch_percolation_policy_falls_back_to_load_without_resident_bytes():
    d0, d1 = _FakeDevice("cpu:0", depth=5), _FakeDevice("L1/cpu:0", depth=0)
    assert PercolationPolicy().select([d0, d1], args=[np.ones(4)]).key == "L1/cpu:0"


def test_torch_scheduler_excludes_dead_localities_and_raises_when_fleet_is_gone():
    ok, dead = _FakeDevice("L1/cpu:0", alive=True), _FakeDevice("L2/cpu:0", alive=False)
    s = Scheduler([dead, ok], policy="round_robin")
    assert all(s.select().key == "L1/cpu:0" for _ in range(3))
    s_all_dead = Scheduler([dead], policy="round_robin")
    with pytest.raises(RuntimeError, match="no live devices"):
        s_all_dead.select()


# ---------------------------------------------------------------------------
# loopback parcelport: full parcel path, zero process machinery
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def loopback():
    port = LoopbackParcelport(n_localities=2, platform=CPU)
    yield port
    port.shutdown()


def test_torch_loopback_discovers_remote_localities(loopback):
    locs = loopback.localities()
    assert len(locs) == 2 and all(not l.is_local for l in locs)
    assert all(len(l) >= 1 for l in locs)
    # cluster-wide discovery appends them to the local groups
    all_locs = get_all_localities(platform=CPU, cluster=loopback).get()
    assert len(all_locs) >= 3
    assert any(l.is_local for l in all_locs)


def test_torch_loopback_buffer_roundtrip_and_free(loopback):
    rdev = loopback.localities()[0].devices[0]
    data = np.arange(16, dtype=np.float32)
    buf = rdev.create_buffer_from(data).get()
    np.testing.assert_array_equal(buf.enqueue_read_sync(), data)
    buf.enqueue_write(0, data * 3).get()
    np.testing.assert_array_equal(buf.enqueue_read_sync(), data * 3)
    buf.free().get()
    with pytest.raises(KeyError, match="not a live parcel-created buffer"):
        buf.enqueue_read_sync()


def test_torch_loopback_launch_by_registered_name_with_remote_out(loopback):
    register_kernel("tp_scale3", lambda x: x * 3.0)
    rdev = loopback.localities()[1].devices[0]
    prog = rdev.create_program("tp_scale3", name="t").get()
    assert isinstance(prog, RemoteProgram)
    src = rdev.create_buffer_from(np.arange(8, dtype=np.float32)).get()
    out = rdev.create_buffer(8, np.float32).get()
    prog.run([src], "tp_scale3", out=[out]).get()  # gid-ref args, results stay remote
    np.testing.assert_allclose(out.enqueue_read_sync(), np.arange(8.0) * 3.0)
    wait_all([src.free(), out.free()])


def test_torch_loopback_unknown_kernel_fails_descriptively(loopback):
    rdev = loopback.localities()[0].devices[0]
    with pytest.raises(KeyError, match="not resolvable"):
        rdev.create_program(["no_such_kernel_anywhere"]).get()


def test_torch_remote_launch_error_travels_as_exception(loopback):
    register_kernel("tp_raiser", lambda x: (_ for _ in ()).throw(ValueError("kernel blew up")))
    rdev = loopback.localities()[0].devices[0]
    prog = rdev.create_program("tp_raiser").get()
    fut = prog.run([np.ones(2, np.float32)], "tp_raiser")
    with pytest.raises(ValueError, match="kernel blew up"):
        fut.get()


def test_torch_local_program_percolates_remote_buffer_arguments(loopback):
    # RemoteBuffer arg to a LOCAL program: explicit transfer (read parcel)
    # then a local launch — the percolation direction remote -> local.
    rdev = loopback.localities()[0].devices[0]
    rbuf = rdev.create_buffer_from(np.full(4, 2.0, np.float32)).get()
    prog = Program(_cpu_device(), {"tp_add1": lambda x: x + 1.0}, "local")
    res = prog.run([rbuf], "tp_add1").get()
    np.testing.assert_allclose(np.asarray(res), np.full(4, 3.0))
    rbuf.free().get()


def test_torch_run_on_any_cluster_routes_to_remote_locality(loopback):
    register_kernel("tp_square", lambda x: x * x)
    prog = Program(_cpu_device(), {"tp_square": lambda x: x * x}, "sq")
    sched = Scheduler(loopback.devices(), policy="least_loaded")
    x = np.arange(6, dtype=np.float32)
    fut = prog.run_on_any([x], "tp_square", scheduler=sched)
    np.testing.assert_allclose(np.asarray(fut.get()[0]), x * x)
    assert all(k.startswith("L") for k in sched.stats())  # placed remotely


def test_torch_route_batches_fans_across_loopback_localities(loopback):
    from repro_torch.serving.serve_step import route_batches

    sched = Scheduler(loopback.devices(), policy="round_robin")
    batches = [np.full(4, i, np.float32) for i in range(4)]
    futs = route_batches("partition_map_ref", batches, scheduler=sched)
    for f in futs:
        np.testing.assert_allclose(np.asarray(f.get()), np.ones(4), rtol=1e-6)
    assert len(sched.stats()) == 2  # both simulated localities took work


def test_torch_remote_buffer_bytes_feed_the_agas_reverse_index():
    # A cluster-style proxy records its remote placement locally; loopback
    # shares this process's registry, so exercise register_proxy directly.
    from repro_torch.core import Placement

    class _Obj:
        pass

    obj = _Obj()
    fake_gid = (77 << 40) | 123  # minted by "locality 77"
    assert locality_of(fake_gid) == 77
    assert registry.register_proxy(obj, fake_gid, Placement("L77/cpu:0", 77), kind="buffer",
                                   nbytes=4096)
    try:
        assert registry.resolve(fake_gid) is obj
        assert registry.resident_bytes("L77/cpu:0") >= 4096
        assert not registry.register_proxy(obj, fake_gid, Placement("L77/cpu:0", 77))  # no double
    finally:
        registry.unregister(fake_gid)
    with pytest.raises(KeyError, match="owned by locality L77"):
        registry.resolve(fake_gid)


def test_torch_collected_remote_buffer_retires_its_proxy_record(loopback):
    # A proxy under a foreign-minted GID (cluster-style registration) must
    # retire its registry record — and its resident bytes — on GC, not
    # only on explicit free().
    import gc

    from repro_torch.core.device import RemoteBuffer

    rdev = loopback.localities()[0].devices[0]
    foreign_gid = (88 << 40) | 5  # not a loopback-shared GID: proxy registers
    base = registry.resident_bytes(rdev.key)
    buf = RemoteBuffer(rdev, foreign_gid, (256,), np.float32)
    assert buf._proxied and registry.resident_bytes(rdev.key) == base + 1024
    del buf
    gc.collect()
    assert registry.resident_bytes(rdev.key) == base
    with pytest.raises(KeyError):
        registry.resolve(foreign_gid)


def test_torch_loopback_steal_fetch_batches_buffer_reads(loopback):
    # the cross-locality steal path: one parcel returns every requested
    # buffer, bit-exactly, in request order
    rdev = loopback.localities()[0].devices[0]
    a = np.arange(16, dtype=np.float32)
    b = np.linspace(-1.0, 1.0, 32, dtype=np.float32)
    ba = rdev.create_buffer_from(a).get()
    bb = rdev.create_buffer_from(b).get()
    arrays = loopback.call(rdev.locality_id, "steal_fetch", {"gids": [ba.gid, bb.gid]}).get()
    assert len(arrays) == 2
    assert np.asarray(arrays[0]).tobytes() == a.tobytes()
    assert np.asarray(arrays[1]).tobytes() == b.tobytes()
    wait_all([ba.free(), bb.free()])


def test_torch_steal_prefetch_resolves_remote_args_in_one_parcel(loopback):
    # what a thief pump does before running a cross-locality stolen
    # launch: remote buffer args become host arrays, the rest pass through
    rdev = loopback.localities()[1].devices[0]
    a = np.full(8, 2.0, np.float32)
    b = np.full(8, 5.0, np.float32)
    ba = rdev.create_buffer_from(a).get()
    bb = rdev.create_buffer_from(b).get()
    dev = _cpu_device()
    sched = Scheduler([dev])
    passthrough = np.ones(3, np.float32)
    fetched = sched._prefetch_stolen_args(dev, [ba, passthrough, bb])
    assert np.asarray(fetched[0]).tobytes() == a.tobytes()
    assert fetched[1] is passthrough
    assert np.asarray(fetched[2]).tobytes() == b.tobytes()
    wait_all([ba.free(), bb.free()])


# ---------------------------------------------------------------------------
# the port against the JAX package: wire bytes, bf16, kernels by name
# ---------------------------------------------------------------------------


def _wire_values():
    rng = np.random.default_rng(11)
    vals = list(_CODEC_VALUES)
    vals += [np.float32(1.5), np.int32(-7), np.float16(0.25), np.uint8(255), np.bool_(True)]
    vals += [rng.normal(size=(3, 5)).astype(d) for d in ("<f4", "<f8", "<f2")]
    vals += [rng.integers(-50, 50, size=(7,)).astype(d) for d in ("<i4", "<i8", "|u1", "|i1")]
    vals += [np.zeros((), np.float32), np.zeros((0, 3), np.int32), np.array([True, False])]
    vals += [np.arange(24, dtype=np.float32).reshape(4, 6)[:, ::2]]
    vals += [KeyError("gone"), ValueError("bad", 3), RuntimeError("x"), ZeroDivisionError()]
    vals += [{"kernel": "stencil", "args": [("gid", 7), ("val", np.ones(4, np.float32))],
              "out": None, "grid": (4, 1, 1), "block": None}]
    return vals


def test_torch_codec_wire_bytes_equal_the_reference():
    """Every value the reference encodes gives the same bytes here, and each
    side loads the other's frames (parcel frames included)."""
    for v in _wire_values():
        mine, theirs = dumps(v), jparcel.dumps(v)
        assert mine == theirs, v
        for got in (loads(theirs), jparcel.loads(mine)):
            assert dumps(got) == mine, v
    p = Parcel("launch", {"kernel": "k", "args": [("val", np.ones(3, np.float32))]}, 42, 3)
    jp = jparcel.Parcel("launch", {"kernel": "k", "args": [("val", np.ones(3, np.float32))]}, 42, 3)
    assert encode_parcel(p) == jparcel.encode_parcel(jp)
    q = jparcel.decode_parcel(encode_parcel(p))
    assert (q.action, q.pid, q.locality, q.ok) == ("launch", 42, 3, True)


def test_torch_codec_bf16_tensor_roundtrip_is_bit_exact():
    g = torch.Generator().manual_seed(3)
    for shape in ((), (5,), (3, 7), (2, 0, 4)):
        t = torch.randn(shape, generator=g).to(torch.bfloat16)
        out = loads(dumps(t))
        assert isinstance(out, torch.Tensor) and out.dtype == torch.bfloat16
        assert out.shape == t.shape and out.device.type == "cpu"
        assert torch.equal(out.view(torch.int16), t.view(torch.int16))
    nested = loads(dumps({"w": [t, np.float32(2.0)]}))
    assert torch.equal(nested["w"][0].view(torch.int16), t.view(torch.int16))
    # a bfloat16 buffer travels both ways through a loopback locality
    port = LoopbackParcelport(1, platform=CPU)
    try:
        rdev = port.devices()[0]
        x = torch.randn(64, generator=g).to(torch.bfloat16)
        rbuf = rdev.create_buffer_from(x).get()
        assert rbuf.dtype == torch.bfloat16
        assert torch.equal(rbuf.enqueue_read_sync().view(torch.int16), x.view(torch.int16))
        rbuf.free().get()
    finally:
        port.shutdown()


def _by_name(port_cls, name, args, block, **kw):
    port = port_cls(1, **kw)
    try:
        rdev = port.localities()[0].devices[0]
        prog = rdev.create_program([name], name=f"byname-{name}").get()
        return np.asarray(prog.run(args, name, block=block).get()[0])
    finally:
        port.shutdown()


@pytest.mark.parametrize("name", ["stencil", "partition_map", "mandelbrot"])
def test_torch_kernels_by_name_through_loopback_match_the_reference(name):
    """The paper's kernels launched by name through a loopback locality of
    each package on the same seeded inputs: mandelbrot bit-equal, stencil
    and partition_map at the reference kernel tests' tolerances.  Mandelbrot
    runs at 32 x 32 with a (32, 8) block, a shape the reference serves by
    its Pallas kernel (at 24 x 32 it serves its linspace oracle, whose
    coordinates differ from the kernel's in the last bit: ROADMAP Queue 3)."""
    rng = np.random.default_rng(21)
    if name == "mandelbrot":
        args, block = [np.array([32, 32], np.int32)], (32, 8, 1)
    else:
        args, block = [(rng.normal(size=(4096,)) * 10).astype(np.float32)], (256, 1, 1)
    got = _by_name(LoopbackParcelport, name, args, block, platform=CPU)
    want = _by_name(jparcel.LoopbackParcelport, name, args, block)
    assert got.shape == want.shape and got.dtype == want.dtype
    if name == "mandelbrot":
        np.testing.assert_array_equal(got, want)
    elif name == "stencil":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_torch_shm_guard_takes_the_inline_lane_when_dev_shm_is_full(monkeypatch):
    """A segment is sparse until written: filling one past /dev/shm's free
    space is a SIGBUS in the sender.  When the payload does not fit, the
    encoder writes the array inline instead (the reference's own fallback
    when a segment cannot be made), and counts it."""
    if not tparcel.shm_available():
        pytest.skip("no usable /dev/shm in this environment")
    x = np.random.default_rng(4).normal(size=(1 << 17,)).astype(np.float32)  # 512 KB
    sink: list = []
    tparcel.reset_lane_counts()
    blob = dumps(x, shm_sink=sink)  # room: the out-of-band lane
    assert len(sink) == 1 and blob[:1] == b"A"
    assert loads(blob).tobytes() == x.tobytes()  # consumes (unlinks) the segment

    class _Full:
        f_bavail, f_frsize = 16, 4096  # 64 KB free

    monkeypatch.setattr(tparcel.os, "statvfs", lambda path: _Full())
    sink = []
    blob = dumps(x, shm_sink=sink)
    assert sink == [] and blob == dumps(x)  # inline: the no-lane bytes
    assert loads(blob).tobytes() == x.tobytes()
    counts = tparcel.lane_counts()
    assert counts["shm_arrays"] == 1 and counts["shm_refused"] == 1
    assert counts["shm_refused_bytes"] == x.nbytes and counts["inline_arrays"] >= 2


def test_torch_cluster_of_cuda_localities_needs_a_card():
    """A worker that finds no card fails its hello, and the constructor
    raises: a locality never takes the CPU instead."""
    if torch.cuda.is_available():
        port = LocalClusterParcelport(n_workers=1, heartbeat_timeout=60.0)
        try:
            assert [d.platform for d in port.devices()] == ["cuda"]
        finally:
            port.shutdown()
        return
    with pytest.raises(RuntimeError, match="found no cuda device"):
        LocalClusterParcelport(n_workers=1, heartbeat_timeout=60.0)


# ---------------------------------------------------------------------------
# cluster integration: 2 real worker processes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cluster():
    port = LocalClusterParcelport(n_workers=2, heartbeat_timeout=60.0, platform=CPU)
    yield port
    port.shutdown()


def test_torch_cluster_mandelbrot_on_remote_locality_matches_ref(cluster):
    """Against the port's plain version, bit for bit, as the reference test
    holds its kernel to its oracle (the port's plain version takes the
    Pallas kernel's pixel coordinates, not the JAX oracle's linspace)."""
    from repro_torch.kernels.mandelbrot.ref import mandelbrot_ref

    rdev = cluster.localities()[0].devices[0]
    assert not rdev.is_local and rdev.key.startswith("L")
    prog = rdev.create_program(["mandelbrot"], name="mandel").get()
    res = prog.run([np.array([24, 32], np.int32)], "mandelbrot").get()
    np.testing.assert_array_equal(np.asarray(res[0]), mandelbrot_ref(24, 32).numpy())


def test_torch_cluster_run_on_any_is_bit_identical_to_local(cluster):
    from repro_torch.kernels.partition_map.ref import partition_map_ref

    prog = Program(_cpu_device(), {"partition_map_ref": partition_map_ref}, "pm")
    x = np.random.default_rng(7).normal(size=(1024,)).astype(np.float32)
    local = np.asarray(prog.run([x], "partition_map_ref").get())

    remote_devs = cluster.devices()
    assert len({d.locality_id for d in remote_devs}) >= 2  # >= 2 worker processes
    for rdev in remote_devs:  # every worker produces the bit-identical answer
        sched = Scheduler([rdev], policy="static")
        fut = prog.run_on_any([x], "partition_map_ref", scheduler=sched)
        remote = np.asarray(fut.get()[0])
        assert remote.dtype == local.dtype and np.array_equal(remote, local)
        assert sched.stats() == {rdev.key: 1}


def test_torch_cluster_multi_locality_graph_replays_through_one_future(cluster):
    from repro_torch.core import capture
    from repro_torch.kernels.partition_map.ref import partition_map_ref

    da = cluster.localities()[0].devices[0]
    db = cluster.localities()[1].devices[0]
    assert da.locality_id != db.locality_id
    pa = da.create_program(["partition_map_ref"], name="ga").get()
    pb = db.create_program(["partition_map_ref"], name="gb").get()

    dev = _cpu_device()
    b_in = dev.create_buffer(128, np.float32).get()
    mid = dev.create_buffer(128, np.float32).get()
    out = dev.create_buffer(128, np.float32).get()
    x = np.random.default_rng(3).normal(size=(128,)).astype(np.float32)
    with capture("xlocality") as g:
        w = b_in.enqueue_write(0, x)
        pa.run([b_in], "partition_map_ref", out=[mid])  # segment on locality A
        pb.run([mid], "partition_map_ref", out=[out])   # segment on locality B
        r = out.enqueue_read()
    exe = g.instantiate()
    assert exe._fanout and len(exe._segments) == 2, repr(exe)
    assert {s.device.locality_id for s in exe._segments} == {da.locality_id, db.locality_id}

    fut = exe.replay()  # ONE future for the whole cross-process graph
    assert isinstance(fut, Future)
    res = fut.get()
    twice = lambda v: partition_map_ref(partition_map_ref(torch.from_numpy(v))).numpy()  # noqa: E731
    np.testing.assert_allclose(res[r], twice(x), rtol=1e-6)
    # re-fed replay (cudaGraphExecKernelNodeSetParams analogue) still works
    y = np.random.default_rng(4).normal(size=(128,)).astype(np.float32)
    res2 = exe.replay(feeds={w: y}).get()
    np.testing.assert_allclose(res2[r], twice(y), rtol=1e-6)
    np.testing.assert_allclose(out.enqueue_read_sync(), twice(y), rtol=1e-6)


def test_torch_cluster_plan_over_two_localities_matches_the_reference_math(cluster):
    """stencil_ref on this locality, partition_map_ref on a worker: the
    remote segment replays as one run_segment parcel (no graph), the local
    one staged (the CPU has no CUDA graph); each replay resolves through
    one future and agrees with the JAX package's two functions on the same
    inputs at the kernel tests' tolerance.  (A loopback locality shares
    this process's devices, whose lanes the fan-out fences until its join:
    a plan over one parks, in the reference as here; ROADMAP Queue 3.)"""
    from repro.kernels.partition_map.ref import partition_map_ref as j_pm
    from repro.kernels.stencil.ref import stencil_ref as j_st
    from repro_torch.core import capture
    from repro_torch.kernels.stencil.ref import stencil_ref

    dev = _cpu_device()
    rng = np.random.default_rng(13)
    x, y = ((rng.normal(size=(4096,)) * 10).astype(np.float32) for _ in range(2))
    local = Program(dev, {"stencil_ref": stencil_ref}, "plan-local")
    remote = cluster.devices()[0].create_program(["partition_map_ref"], name="plan-remote").get()
    src, mid, out = (dev.create_buffer(x.size, np.float32).get() for _ in range(3))
    with capture("two-localities") as g:
        w = src.enqueue_write(0, x)
        local.run([src], "stencil_ref", out=[mid])
        remote.run([mid], "partition_map_ref", out=[out])
        r = out.enqueue_read()
    exe = g.instantiate()
    assert sorted(seg.exec_mode for seg in exe._segments) == ["remote", "staged"], repr(exe)
    fut = exe.replay()
    assert isinstance(fut, Future)
    np.testing.assert_allclose(fut.get()[r], np.asarray(j_pm(j_st(x))), rtol=1e-6, atol=1e-6)
    got = exe.replay(feeds={w: y}).get()[r]
    np.testing.assert_allclose(got, np.asarray(j_pm(j_st(y))), rtol=1e-6, atol=1e-6)
    assert out.enqueue_read_sync().tobytes() == got.tobytes()  # committed home


def test_torch_cluster_graph_reads_a_remote_extern_by_one_parcel(cluster):
    """A worker's buffer read as an extern input of a local launch: each
    replay fetches its current value (one read parcel), so a write to it
    between replays shows in the next."""
    from repro_torch.core import capture
    from repro_torch.kernels.partition_map.ref import partition_map_ref

    rdev = cluster.devices()[1]
    x = (np.random.default_rng(14).normal(size=(256,)) * 10).astype(np.float32)
    rbuf = rdev.create_buffer_from(x).get()
    dev = _cpu_device()
    prog = Program(dev, {"partition_map_ref": partition_map_ref}, "extern")
    out = dev.create_buffer(256, np.float32).get()
    with capture("remote-extern") as g:
        prog.run([rbuf], "partition_map_ref", out=[out])
        r = out.enqueue_read()
    exe = g.instantiate()
    assert exe._remote and list(g._extern.values()) == [rbuf]
    want = partition_map_ref(torch.from_numpy(x)).numpy()
    assert exe.replay().get()[r].tobytes() == want.tobytes()
    rbuf.enqueue_write(0, x * 2).get()
    want2 = partition_map_ref(torch.from_numpy(x * 2)).numpy()
    assert exe.replay().get()[r].tobytes() == want2.tobytes()
    rbuf.free().get()


def test_torch_cluster_route_batches_ships_apply_parcels(cluster):
    from repro_torch.serving.serve_step import route_batches

    sched = Scheduler(cluster.devices(), policy="round_robin")
    batches = [np.full(8, float(i), np.float32) for i in range(4)]
    futs = route_batches("partition_map_ref", batches, scheduler=sched)
    for f in futs:
        np.testing.assert_allclose(np.asarray(f.get()), np.ones(8), rtol=1e-6)
    assert len(sched.stats()) == 2  # both worker processes took batches
    # a closure cannot cross the process boundary: descriptive refusal
    with pytest.raises(ValueError, match="kernel name"):
        route_batches(lambda b: b, [np.ones(2, np.float32)],
                      scheduler=Scheduler(cluster.devices(), policy="static"))


def test_torch_cluster_remote_build_compiles_ahead(cluster):
    rdev = cluster.localities()[0].devices[0]
    prog = rdev.create_program(["partition_map_ref"], name="bld").get()
    # Listing-2 overlap: ship the build ahead of the data as its own parcel
    prog.build("partition_map_ref", torch.empty((32,), device="meta")).get()
    res = prog.run([np.ones(32, np.float32)], "partition_map_ref").get()
    np.testing.assert_allclose(np.asarray(res[0]), np.ones(32), rtol=1e-6)


def test_torch_cluster_remote_resident_pipeline_keeps_bytes_remote(cluster):
    """Write once, launch against the GID, read once: the kernel argument
    and result never transit the parent between the two parcels."""
    rdev = cluster.localities()[1].devices[0]
    x = np.linspace(0.0, 1.0, 64, dtype=np.float32)
    rbuf = rdev.create_buffer_from(x).get()
    rout = rdev.create_buffer(64, np.float32).get()
    assert registry.placement(rbuf.gid).device_key == rdev.key  # proxy record
    assert locality_of(rbuf.gid) == rdev.locality_id  # minted by the worker
    prog = rdev.create_program(["partition_map_ref"], name="resident").get()
    prog.run([rbuf], "partition_map_ref", out=[rout]).get()
    np.testing.assert_allclose(rout.enqueue_read_sync(), np.ones(64), rtol=1e-6)
    wait_all([rbuf.free(), rout.free()])


def test_torch_cluster_steal_fetch_crosses_a_real_process_boundary(cluster):
    rdev = cluster.localities()[0].devices[0]
    a = np.random.default_rng(7).normal(size=(128,)).astype(np.float32)
    b = np.random.default_rng(8).normal(size=(64,)).astype(np.float32)
    ba = rdev.create_buffer_from(a).get()
    bb = rdev.create_buffer_from(b).get()
    arrays = cluster.call(rdev.locality_id, "steal_fetch", {"gids": [ba.gid, bb.gid]}).get()
    assert np.asarray(arrays[0]).tobytes() == a.tobytes()
    assert np.asarray(arrays[1]).tobytes() == b.tobytes()
    wait_all([ba.free(), bb.free()])


def test_torch_cluster_heartbeat_flap_recovers_and_reenters_placement():
    # a locality latched dead for a MISSED HEARTBEAT (the process is
    # alive) must flow work again once it answers the monitor's probe
    port = LocalClusterParcelport(n_workers=1, heartbeat_timeout=2.0, platform=CPU)
    try:
        rdev = port.localities()[0].devices[0]
        lid = rdev.locality_id
        assert port.call(lid, "ping", {}).get() == "pong"
        port._mark_dead(lid, "missed its heartbeat deadline (test-induced flap)")
        assert not port.alive(lid)
        with pytest.raises(RuntimeError, match="failed"):
            port.call(lid, "ping", {}).get()  # fail-fast while latched
        with pytest.raises(RuntimeError, match="no live devices"):
            Scheduler([rdev]).select()  # excluded from placement
        deadline = time.monotonic() + 20
        while not port.alive(lid) and time.monotonic() < deadline:
            time.sleep(0.1)
        assert port.alive(lid), "flapped worker was never re-admitted"
        assert port.call(lid, "ping", {}).get() == "pong"
        assert Scheduler([rdev]).select() is rdev  # back in the fleet
    finally:
        port.shutdown()


# ---------------------------------------------------------------------------
# shared-memory lane + pipelined channel
# ---------------------------------------------------------------------------

# 512 KB of float32: at the default REPRO_PARCEL_SHM_MIN threshold, so the
# payload rides the shared-memory lane in BOTH directions on an shm port.
_SHM_N = 1 << 17


def _psm_segments():
    import glob

    return set(glob.glob("/dev/shm/psm_*"))


def test_torch_cluster_shm_lane_roundtrip_is_bit_exact():
    from repro_torch.kernels.partition_map.ref import partition_map_ref

    if not tparcel.shm_available():
        pytest.skip("no usable /dev/shm in this environment")
    port = LocalClusterParcelport(n_workers=1, heartbeat_timeout=60.0, shm=True, platform=CPU)
    try:
        assert port._shm_ok
        rdev = port.localities()[0].devices[0]
        x = np.random.default_rng(5).normal(size=(_SHM_N,)).astype(np.float32)
        rbuf = rdev.create_buffer_from(x).get()  # parent -> worker via shm
        back = rbuf.enqueue_read_sync()          # worker -> parent via shm
        assert back.dtype == x.dtype and back.tobytes() == x.tobytes()
        # a launch whose argument and reply both cross the lane stays
        # bit-identical to the same launch on a local device
        local = np.asarray(Program(_cpu_device(), {"partition_map_ref": partition_map_ref},
                                   "shm-l").run([x], "partition_map_ref").get())
        prog = rdev.create_program(["partition_map_ref"], name="shm").get()
        res = np.asarray(prog.run([x], "partition_map_ref").get()[0])
        assert res.tobytes() == local.tobytes()
        worker_lanes = port.call(rdev.locality_id, "invoke",
                                 {"fn": "repro_torch.core.parcel:lane_counts"}).get()
        assert worker_lanes["shm_arrays"] >= 2  # the two replies
        rbuf.free().get()
    finally:
        port.shutdown()


def test_torch_cluster_shm_off_falls_back_to_inline_wire():
    # shm=False must force every payload inline on the pipe — same results,
    # no lane involvement, regardless of size.
    port = LocalClusterParcelport(n_workers=1, heartbeat_timeout=60.0, shm=False, platform=CPU)
    try:
        assert not port._shm_ok
        rdev = port.localities()[0].devices[0]
        x = np.random.default_rng(6).normal(size=(_SHM_N,)).astype(np.float32)
        rbuf = rdev.create_buffer_from(x).get()
        assert rbuf.enqueue_read_sync().tobytes() == x.tobytes()
        rbuf.free().get()
    finally:
        port.shutdown()


def test_torch_cluster_shm_segments_do_not_leak_after_shutdown():
    if not tparcel.shm_available():
        pytest.skip("no usable /dev/shm in this environment")
    before = _psm_segments()
    port = LocalClusterParcelport(n_workers=1, heartbeat_timeout=60.0, shm=True, platform=CPU)
    try:
        rdev = port.localities()[0].devices[0]
        x = np.random.default_rng(7).normal(size=(_SHM_N,)).astype(np.float32)
        for _ in range(3):  # several lane crossings, both directions
            rbuf = rdev.create_buffer_from(x).get()
            assert rbuf.enqueue_read_sync().tobytes() == x.tobytes()
            rbuf.free().get()
        rdev.synchronize()
    finally:
        port.shutdown()
    leaked = _psm_segments() - before
    assert not leaked, f"shm segments leaked past shutdown: {sorted(leaked)}"


def test_torch_cluster_pipelined_channel_orders_and_fences():
    port = LocalClusterParcelport(n_workers=1, heartbeat_timeout=60.0, platform=CPU)
    try:
        assert port.pipelined  # the default channel stages + flushes
        rdev = port.localities()[0].devices[0]
        rbuf = rdev.create_buffer_from(np.zeros(16, np.float32)).get()
        futs = [rbuf.enqueue_write(0, np.full(16, float(i), np.float32)) for i in range(8)]
        # synchronize() rides the "barrier" action through the worker's
        # action pool, so its reply proves every staged parcel executed
        rdev.synchronize()
        # channel FIFO: staging order == execution order -> last write wins
        np.testing.assert_array_equal(rbuf.enqueue_read_sync(), np.full(16, 7.0))
        wait_all(futs)

        prog = rdev.create_program(["partition_map_ref"], name="pipe").get()
        x = np.random.default_rng(8).normal(size=(1024,)).astype(np.float32)
        burst = [prog.run([x], "partition_map_ref") for _ in range(6)]  # in flight together
        outs = [np.asarray(f.get()[0]) for f in burst]
        assert all(o.tobytes() == outs[0].tobytes() for o in outs)
        rbuf.free().get()
    finally:
        port.shutdown()


def test_torch_cluster_pipeline_off_uses_blocking_channel():
    port = LocalClusterParcelport(n_workers=1, heartbeat_timeout=60.0, pipeline=False,
                                  platform=CPU)
    try:
        assert not port.pipelined
        rdev = port.localities()[0].devices[0]
        prog = rdev.create_program(["partition_map_ref"], name="nopipe").get()
        x = np.random.default_rng(9).normal(size=(256,)).astype(np.float32)
        res = np.asarray(prog.run([x], "partition_map_ref").get()[0])
        np.testing.assert_allclose(res, np.ones(256), rtol=1e-5)
        rdev.synchronize()  # no-op fence on a blocking channel
    finally:
        port.shutdown()


# ---------------------------------------------------------------------------
# fault: heartbeat exclusion + fail-fast; the reset test last
# (reset_runtime tears down every live port, including module fixtures)
# ---------------------------------------------------------------------------


def test_torch_zz_dead_worker_fails_fast_and_is_excluded_from_placement():
    port = LocalClusterParcelport(n_workers=1, heartbeat_timeout=2.0, platform=CPU)
    try:
        rdev = port.localities()[0].devices[0]
        lid = rdev.locality_id
        assert rdev.alive() and port.call(lid, "ping", {}).get() == "pong"
        port._workers[lid].proc.kill()  # fail-stop: the worker vanishes
        deadline = time.monotonic() + 15
        while port.alive(lid) and time.monotonic() < deadline:
            time.sleep(0.1)
        assert not port.alive(lid), "heartbeat monitor never declared the worker dead"
        # new parcels fail fast, with the action and locality in the error
        with pytest.raises(RuntimeError, match="L.*failed"):
            rdev._call("ping").get()
        with pytest.raises(RuntimeError, match="failed"):
            port.call(lid, "enqueue_read", {"gid": 1}).get()
        # and the scheduler refuses to place there
        with pytest.raises(RuntimeError, match="no live devices"):
            Scheduler([rdev]).select()
    finally:
        port.shutdown()


def test_torch_zzz_reset_runtime_shuts_down_live_parcelport_workers():
    import multiprocessing

    from repro_torch.core import reset_runtime

    before = _psm_segments()
    port = LocalClusterParcelport(n_workers=1, heartbeat_timeout=60.0, platform=CPU)
    procs = [w.proc for w in port._workers.values()]
    assert all(p.is_alive() for p in procs)
    loop = LoopbackParcelport(n_localities=1, platform=CPU)
    proxies = [d.gid for d in port.devices() + loop.devices()]
    reset_runtime()  # must drain + stop workers, not leak them past the test
    deadline = time.monotonic() + 10
    while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert not any(p.is_alive() for p in procs), "reset_runtime leaked worker processes"
    assert port._shut and loop._shut
    assert not [p for p in multiprocessing.active_children() if p in procs]
    assert not _psm_segments() - before
    for gid in proxies:  # the remote devices' AGAS records are retired
        with pytest.raises(KeyError):
            registry.resolve(gid)
    # the runtime rebuilds cleanly afterwards
    fresh = _cpu_device()
    buf = fresh.create_buffer_from(np.arange(4.0, dtype=np.float32)).get()
    np.testing.assert_allclose(buf.enqueue_read_sync(), np.arange(4.0))
