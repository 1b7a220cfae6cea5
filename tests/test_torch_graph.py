"""The port's graph capture and replay (``repro_torch.core.graph``), held
against the JAX package's ``repro.core.graph`` on the CPU.

Each test builds the same graph from the same numpy inputs (drawn from a
seed) in both packages, with plain kernels, and holds the port's replay
against the reference's replay AND against the port's own eager chain of
``Program.run`` calls, bit for bit wherever ``tests/test_graph.py`` /
``tests/test_stream.py`` assert bit-equality.  On the CPU device the port
has no CUDA graph: every plan replays ``staged`` with the same bookkeeping
(the CUDA-graph half is in ``tests/test_torch_cuda.py`` and the smoke's
``graph`` phase).  Also: the first result survives a second replay with
other feeds, a plan over two devices replays (the reference's checks), a
write to a remote buffer and a launch into one are refused (plans over
worker processes are in ``tests/test_torch_parcel.py``), and
``REPRO_SEGMENT_COMPILE=staged|fused`` give the same values.
"""
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro_torch import core as tcore
from repro_torch.core import Device, Dim3, Future, TaskGraph, capture, get_all_devices


@pytest.fixture(scope="module")
def device():
    return get_all_devices(platform="cpu").get()[0]


@pytest.fixture(scope="module")
def jax_device():
    return jcore.get_all_devices(1, 0).get()[0]


KERNELS = {"double": lambda x: x * 2.0, "inc": lambda x: x + 1.0, "axpy": lambda x, y: x + y}


@pytest.fixture()
def prog(device):
    return device.create_program(dict(KERNELS), name="graph-test").get()


@pytest.fixture()
def jprog(jax_device):
    return jax_device.create_program(dict(KERNELS), name="graph-test").get()


def _bufs(device, n, k):
    return [device.create_buffer(n, np.float32).get() for _ in range(k)]


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(a, b) -> None:
    a, b = _np(a), _np(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _chain3(core, device, prog, host):
    """double -> inc -> double, captured with a write and a read; returns
    (exe, write node, read node)."""
    n = host.size
    gbuf, gt1, gt2, gout = _bufs(device, n, 4)
    g = core.TaskGraph("prebound")
    w = g.write(gbuf, host)
    g.run(prog, [gbuf], "double", out=[gt1])
    g.run(prog, [gt1], "inc", out=[gt2])
    g.run(prog, [gt2], "double", out=[gout])
    r = g.read(gout)
    return g.instantiate(), w, r


def _eager3(device, prog, x):
    ebuf = device.create_buffer_from(x).get()
    et1, et2, eout = _bufs(device, x.size, 3)
    prog.run([ebuf], "double", out=[et1]).get()
    prog.run([et1], "inc", out=[et2]).get()
    prog.run([et2], "double", out=[eout]).get()
    return eout.enqueue_read_sync()


# ---------------------------------------------------------------------------
# capture -> instantiate -> replay equivalence vs eager Program.run
# ---------------------------------------------------------------------------


def test_torch_builder_replay_matches_eager(device, prog, jax_device, jprog):
    n = 256
    host = np.linspace(-1.0, 1.0, n).astype(np.float32)

    def run(core, dev, p):
        ebuf = dev.create_buffer_from(host).get()
        etmp, eout = _bufs(dev, n, 2)
        p.run([ebuf], "double", out=[etmp]).get()
        p.run([etmp], "inc", out=[eout]).get()
        want = eout.enqueue_read_sync()
        gbuf, gtmp, gout = _bufs(dev, n, 3)
        g = core.TaskGraph("chain")
        g.write(gbuf, host)
        g.run(p, [gbuf], "double", out=[gtmp])
        g.run(p, [gtmp], "inc", out=[gout])
        r = g.read(gout)
        res = g.instantiate().replay().get()
        return want, res[r], gout.enqueue_read_sync()

    want, got, kept = run(tcore, device, prog)
    jwant, jgot, jkept = run(jcore, jax_device, jprog)
    _same(got, want)
    _same(kept, want)
    _same(got, jgot)
    _same(kept, jkept)


def test_torch_capture_context_matches_eager(device, prog, jax_device, jprog):
    n = 128
    host = np.arange(n, dtype=np.float32)

    def run(dev, p):
        buf = dev.create_buffer_from(host).get()
        out = _bufs(dev, n, 1)[0]
        with dev.capture("cap") as g:
            node = p.run([buf], "double", out=[out])
            r = out.enqueue_read()
        assert not isinstance(node, (Future, jcore.Future)) and not isinstance(r, (Future, jcore.Future))
        exe = g.instantiate()
        # replay is repeatable: extern inputs are never donated
        return exe.replay().get()[r], exe.replay().get()[r]

    first, second = run(device, prog)
    jfirst, jsecond = run(jax_device, jprog)
    _same(first, host * 2.0)
    _same(second, host * 2.0)
    _same(first, jfirst)
    _same(second, jsecond)


def test_torch_graph_fuses_same_device_chain(device, prog, jax_device, jprog):
    n = 64

    def run(core, dev, p):
        bufs = _bufs(dev, n, 4)
        g = core.TaskGraph("fuse4")
        g.write(bufs[0], np.ones(n, np.float32))
        g.run(p, [bufs[0]], "inc", out=[bufs[1]])
        g.run(p, [bufs[1]], "inc", out=[bufs[2]])
        g.run(p, [bufs[2]], "inc", out=[bufs[3]])
        g.read(bufs[3])
        exe = g.instantiate()
        assert len(exe._segments) == 1  # 3 launches -> 1 segment
        return exe.replay().get().reads[0]

    got = run(tcore, device, prog)
    _same(got, np.full(n, 4.0, np.float32))
    _same(got, run(jcore, jax_device, jprog))


def test_torch_replay_with_feeds_overrides_write(device, prog, jax_device, jprog):
    n = 32
    new = np.random.default_rng(3).normal(size=n).astype(np.float32)

    def run(core, dev, p):
        buf, out = _bufs(dev, n, 2)
        g = core.TaskGraph("feeds")
        w = g.write(buf, np.zeros(n, np.float32))
        g.run(p, [buf], "inc", out=[out])
        r = g.read(out)
        exe = g.instantiate()
        # the recorded payload, a feed by node, a feed by buffer
        return [exe.replay().get()[r], exe.replay(feeds={w: new}).get()[r],
                exe.replay(feeds={buf: new * 2}).get()[r]]

    got = run(tcore, device, prog)
    for g_, want in zip(got, (np.ones(n, np.float32), new + np.float32(1), new * 2 + np.float32(1))):
        _same(g_, want)
    for g_, j in zip(got, run(jcore, jax_device, jprog)):
        _same(g_, j)


def test_torch_graph_respects_grid_block_binding(device):
    seen = []

    def k(x, grid=None, block=None):
        seen.append((x.device.type, grid, block))
        return x * 1.0

    prog = device.create_program({"k": k}, name="gb").get()
    buf = device.create_buffer_from(np.zeros(4, np.float32)).get()
    out = device.create_buffer(4, np.float32).get()
    g = TaskGraph("geo")
    g.run(prog, [buf], "k", grid=Dim3(2, 1, 1), block=(64, 1, 1), out=[out])
    # recording ran the kernel on meta tensors only: nothing executed
    assert seen == [("meta", (2, 1, 1), (64, 1, 1))]
    g.instantiate().replay().get()
    assert seen[-1] == ("cpu", (2, 1, 1), (64, 1, 1))


def test_torch_outless_launch_is_fetchable(device, prog, jax_device, jprog):
    host = np.arange(8, dtype=np.float32)

    def run(core, dev, p):
        buf = dev.create_buffer_from(host).get()
        g = core.TaskGraph("outless")
        node = g.run(p, [buf], "double")
        return g.instantiate().replay().get()[node]

    got = run(tcore, device, prog)
    assert isinstance(got, torch.Tensor)  # raw result, as an eager out-less launch's
    _same(got, host * 2.0)
    _same(got, run(jcore, jax_device, jprog))


# ---------------------------------------------------------------------------
# ownership: graph-internal buffers, first results
# ---------------------------------------------------------------------------


def test_torch_donated_intermediate_not_readable_after_replay(device, prog, jax_device, jprog):
    n = 64

    def run(core, dev, p):
        src, tmp, out = _bufs(dev, n, 3)
        src.enqueue_write(0, np.ones(n, np.float32)).get()
        g = core.TaskGraph("donate")
        g.run(p, [src], "double", out=[tmp])   # tmp: graph-internal
        g.run(p, [tmp], "inc", out=[out])      # consumed by a later launch
        g.read(out)
        g.instantiate().replay().get()
        with pytest.raises(RuntimeError, match="donated"):
            tmp.array()
        with pytest.raises(RuntimeError, match="donated"):
            tmp.enqueue_read().get()
        tmp.enqueue_write(0, np.zeros(n, np.float32)).get()  # writable again
        return tmp.enqueue_read_sync(), out.enqueue_read_sync(), src.enqueue_read_sync()

    got = run(tcore, device, prog)
    for g_, want in zip(got, (0.0, 3.0, 1.0)):
        _same(g_, np.full(n, want, np.float32))
    for g_, j in zip(got, run(jcore, jax_device, jprog)):
        _same(g_, j)


def test_torch_tensor_payload_survives_replays(device, prog):
    n = 16
    buf, out = _bufs(device, n, 2)
    payload = torch.full((n,), 2.0)  # a conforming tensor: used by reference
    g = TaskGraph("payload")
    g.write(buf, payload)
    g.run(prog, [buf], "inc", out=[out])
    r = g.read(out)
    exe = g.instantiate()
    for _ in range(3):
        _same(exe.replay().get()[r], np.full(n, 3.0, np.float32))
    assert torch.equal(payload, torch.full((n,), 2.0))
    with pytest.raises(RuntimeError, match="donated"):
        buf.array()  # consumed by the graph, kept by nothing


def test_torch_write_fed_buffer_kept_with_donate_false(device, prog, jax_device, jprog):
    n = 8
    host = np.arange(n, dtype=np.float32)

    def run(core, dev, p):
        buf, out = _bufs(dev, n, 2)
        g = core.TaskGraph("nodonate")
        g.write(buf, host)
        g.run(p, [buf], "inc", out=[out])
        g.instantiate(donate=False).replay().get()
        return buf.enqueue_read_sync(), out.enqueue_read_sync()

    got = run(tcore, device, prog)
    _same(got[0], host)
    for g_, j in zip(got, run(jcore, jax_device, jprog)):
        _same(g_, j)


@pytest.mark.parametrize("what", ["kept buffer", "outless result", "read"])
def test_torch_first_result_unchanged_by_later_replay(device, prog, what):
    n = 64
    rng = np.random.default_rng(5)
    x1, x2 = (rng.normal(size=n).astype(np.float32) for _ in range(2))
    buf, out = _bufs(device, n, 2)
    g = TaskGraph("first")
    w = g.write(buf, x1)
    node = g.run(prog, [buf], "double", out=None if what == "outless result" else [out])
    r = g.read(out) if what == "read" else None
    exe = g.instantiate()
    res1 = exe.replay(feeds={w: x1}).get()
    def value(res):
        return {"kept buffer": lambda: out.array(), "outless result": lambda: res[node],
                "read": lambda: res[r]}[what]()

    first = value(res1)
    held = _np(first).copy()
    res2 = exe.replay(feeds={w: x2}).get()
    _same(first, held)
    _same(held, x1 * 2.0)
    _same(value(res2), x2 * 2.0)


def test_torch_read_sync_rejected_under_capture(device):
    buf = device.create_buffer_from(np.zeros(4, np.float32)).get()
    with device.capture("sync-read") as g:
        with pytest.raises(RuntimeError, match="capture"):
            buf.enqueue_read_sync()
    assert g._nodes == []  # the failed sync read recorded nothing


def test_torch_frozen_graph_rejects_new_nodes(device, prog):
    buf = device.create_buffer_from(np.zeros(4, np.float32)).get()
    g = TaskGraph("frozen")
    g.run(prog, [buf], "double")
    g.instantiate()
    with pytest.raises(RuntimeError, match="frozen"):
        g.run(prog, [buf], "double")


@pytest.mark.parametrize("call", ["write", "read", "enqueue_write"])
def test_torch_partial_transfer_rejected_under_capture(device, call):
    buf = device.create_buffer(8, np.float32).get()
    g = TaskGraph("partial")
    with pytest.raises(NotImplementedError):
        if call == "write":
            g.write(buf, np.zeros(3, np.float32), offset=2, count=3)
        elif call == "read":
            g.read(buf, offset=1)
        else:
            with capture("partial") as g2:
                buf.enqueue_write(2, np.zeros(3, np.float32))
    if call == "enqueue_write":
        assert g2._nodes == []


# ---------------------------------------------------------------------------
# the pre-bound plan, the executors and what is refused
# ---------------------------------------------------------------------------


def test_torch_prebound_fast_plan_replay_bit_equal_to_eager(device, prog, jax_device, jprog):
    n = 512
    host = np.random.default_rng(11).normal(size=(n,)).astype(np.float32)
    host2 = np.random.default_rng(12).normal(size=(n,)).astype(np.float32)
    exe, w, r = _chain3(tcore, device, prog, host)
    jexe, jw, jr = _chain3(jcore, jax_device, jprog, host)
    assert exe._fast is not None and not exe._fanout
    for feeds, x in ((None, host), ({w: host2}, host2), (None, host)):
        got = exe.replay(feeds=feeds).get()[r]
        _same(got, _eager3(device, prog, x))  # bit-equal, not just allclose
        jgot = jexe.replay(feeds=None if feeds is None else {jw: host2}).get()[jr]
        _same(got, jgot)


@pytest.mark.parametrize("mode", ["staged", "fused", "auto"])
def test_torch_segment_compile_env_same_values(device, prog, monkeypatch, mode):
    monkeypatch.setenv("REPRO_SEGMENT_COMPILE", mode)
    host = np.random.default_rng(13).normal(size=(96,)).astype(np.float32)
    exe, _, r = _chain3(tcore, device, prog, host)
    # the CPU device has no CUDA graph: every mode replays staged
    assert {s.exec_mode for s in exe._segments} == {"staged"}
    assert "compile=staged" in repr(exe) and "no CUDA graph" in repr(exe)
    _same(exe.replay().get()[r], _eager3(device, prog, host))


def test_torch_multi_device_plan_refused(device, prog):
    """Refused until the multi-device slice; now the reference's checks of
    a plan over two devices (``tests/test_scheduler.py``'s xdev graph and
    donation race), on the CPU device and a logical CPU device: recorded
    through ``run_on_any``, the plan replays through one future, with a
    transfer step and the out buffer left on the device that wrote it."""
    d0, d1 = device, Device(torch.device("cpu"), logical=1)
    p2 = d0.create_program({"inc": lambda x: x + 1.0, "scale": lambda x: x * 3.0}, "g").get()
    b_in, t_mid = _bufs(d0, 16, 2)
    t_out = d1.create_buffer(16, np.float32).get()
    rr = tcore.Scheduler([d0, d1], policy="round_robin")
    with capture("xdev") as g:
        w = b_in.enqueue_write(0, np.ones(16, np.float32))
        p2.run_on_any([b_in], "inc", out=[t_mid], scheduler=rr)     # -> d0
        p2.run_on_any([t_mid], "scale", out=[t_out], scheduler=rr)  # -> d1
        r = t_out.enqueue_read()
    exe = g.instantiate()
    assert exe._fanout and len(exe._segments) == 2, repr(exe)
    assert len(exe._transfers) >= 1 and "1 transfer(s)" in repr(exe), repr(exe)
    fut = exe.replay()  # ONE future for the whole graph
    assert isinstance(fut, Future)
    _same(fut.get()[r], np.full(16, 6.0, np.float32))
    res2 = exe.replay(feeds={w: np.full(16, 2.0, np.float32)}).get()
    _same(res2[r], np.full(16, 9.0, np.float32))
    assert tcore.registry.placement(t_out.gid).device_key == d1.key

    # a sym consumed by two segments that may run concurrently is never donated
    a0, m1, o2 = _bufs(d0, 8, 3)
    o1 = d1.create_buffer(8, np.float32).get()
    ga = TaskGraph("donate-race")
    ga.write(a0, np.ones(8, np.float32))
    ga.run(p2.for_device(d0), [a0], "inc", out=[m1])    # seg 0 (d0) -> m1
    ga.run(p2.for_device(d1), [m1], "scale", out=[o1])  # seg 1 (d1) reads m1
    ga.run(p2.for_device(d0), [m1], "inc", out=[o2])    # seg 2 (d0) reads m1 too
    r1, r2 = ga.read(o1), ga.read(o2)
    m1_sym = ga._cur[id(m1)]
    exe_a = ga.instantiate()
    assert exe_a._fanout and len(exe_a._segments) == 3, repr(exe_a)
    assert m1_sym not in exe_a._donated_syms
    res_a = exe_a.replay().get()
    _same(res_a[r1], np.full(8, 6.0, np.float32))  # (1+1)*3
    _same(res_a[r2], np.full(8, 3.0, np.float32))  # (1+1)+1


def test_torch_remote_buffer_refused(device, prog):
    """What capture still refuses of a remote buffer, as the reference
    does: a write to it and a launch writing into it.  Reading it (an
    extern input fetched by one read parcel at each replay) is recorded."""
    buf, out = _bufs(device, 8, 2)
    buf.is_remote_buffer = True  # what a parcel port's proxy would say
    for record in (lambda g: g.write(buf, np.zeros(8, np.float32)),
                   lambda g: g.run(prog, [out], "double", out=[buf])):
        with pytest.raises(NotImplementedError, match="local buffers only"):
            record(TaskGraph("remote"))
    for record in (lambda g: g.read(buf), lambda g: g.run(prog, [buf], "double")):
        g = TaskGraph("remote")
        record(g)
        assert list(g._extern.values()) == [buf]


def test_torch_unrecordable_kernel_raises(device):
    prog = device.create_program({"host": lambda x: torch.from_numpy(x.numpy() + 1)}).get()
    buf = device.create_buffer(4, np.float32).get()
    with pytest.raises(TypeError, match="meta"):
        TaskGraph("host").run(prog, [buf], "host")


def test_torch_stream_replay_and_fanout_refuses_stream(device, prog):
    n = 32
    host = np.arange(n, dtype=np.float32)
    s = device.create_stream()
    exe, w, r = _chain3(tcore, device, prog, host)
    res = s.replay(exe).get()
    _same(res[r], _eager3(device, prog, host))
    assert s.record().future.get(timeout=10) is None  # the replay is a stream completion
    a, b, oa, ob = _bufs(device, n, 4)
    with capture("fan") as g:
        prog.run([a], "double", out=[oa])
        prog.run([b], "inc", out=[ob])
    fan = g.instantiate()
    with pytest.raises(ValueError, match="fan-out"):
        fan.replay(stream=s)


# ---------------------------------------------------------------------------
# stream-aware plans (tests/test_stream.py)
# ---------------------------------------------------------------------------


def test_torch_graph_two_chains_two_streams_bit_equal_eager(device, prog, jax_device, jprog):
    n = 256
    ha = np.linspace(-1.0, 1.0, n).astype(np.float32)
    hb = np.linspace(1.0, 3.0, n).astype(np.float32)

    def run(core, dev, p):
        ea = dev.create_buffer_from(ha).get()
        eb = dev.create_buffer_from(hb).get()
        eoa, eob = _bufs(dev, n, 2)
        p.run([ea], "double", out=[eoa]).get()
        p.run([eb], "inc", out=[eob]).get()
        want = (eoa.enqueue_read_sync(), eob.enqueue_read_sync())
        a, b, oa, ob = _bufs(dev, n, 4)
        with core.capture("chains") as g:
            g.write(a, ha)
            g.write(b, hb)
            p.run([a], "double", out=[oa])
            p.run([b], "inc", out=[ob])
            ra, rb = oa.enqueue_read(), ob.enqueue_read()
        exe = g.instantiate()
        assert exe._fanout and len(exe._segments) == 2, repr(exe)
        assert len({id(s.queue) for s in exe._segments}) == 2, repr(exe)  # distinct lanes
        got = []
        for _ in range(3):  # replays are repeatable AND bit-equal to eager
            res = exe.replay().get()
            got.append((res[ra], res[rb]))
        return want, got

    want, got = run(tcore, device, prog)
    jwant, jgot = run(jcore, jax_device, jprog)
    for (a, b), (ja, jb) in zip(got, jgot):
        _same(a, want[0])
        _same(b, want[1])
        _same(a, ja)
        _same(b, jb)


def test_torch_graph_chain_join_has_event_edge(device, prog, jax_device, jprog):
    n = 64

    def run(core, dev, p):
        a, b, ma, mb, out = _bufs(dev, n, 5)
        with core.capture("join") as g:
            g.write(a, np.ones(n, np.float32))
            g.write(b, np.full(n, 2.0, np.float32))
            p.run([a], "inc", out=[ma])      # chain 0
            p.run([b], "double", out=[mb])   # chain 1 (independent head)
            p.run([ma, mb], "axpy", out=[out])  # join -> event edge from chain 1
            r = g.read(out)
        exe = g.instantiate()
        assert exe._fanout and len(exe._segments) == 3, repr(exe)
        return exe._event_edges, exe.replay().get()[r], repr(exe)

    edges, got, rep = run(tcore, device, prog)
    jedges, jgot, _ = run(jcore, jax_device, jprog)
    assert edges and [(p, c) for p, c, _ in edges] == [(p, c) for p, c, _ in jedges]
    assert f"{len(edges)} event edge(s)" in rep
    _same(got, np.full(n, 6.0, np.float32))  # (1+1) + 2*2
    _same(got, jgot)


def test_torch_eager_read_after_fanout_replay_sees_commit(device, prog):
    """An eager read submitted right after a multi-chain replay() returns
    observes the replayed values, not pre-replay state."""
    n = 128
    a, b, oa, ob = _bufs(device, n, 4)
    with capture("fence") as g:
        g.write(a, np.ones(n, np.float32))
        g.write(b, np.full(n, 3.0, np.float32))
        prog.run([a], "inc", out=[oa])      # chain 0 (default lane)
        prog.run([b], "double", out=[ob])   # chain 1 (replay lane)
    exe = g.instantiate()
    assert exe._fanout, repr(exe)
    for _ in range(5):
        exe.replay(sync="dispatch")  # don't wait: race the eager read
        _same(ob.enqueue_read_sync(), np.full(n, 6.0, np.float32))


def test_torch_replay_lane_names_never_share_a_lane(device):
    streams = [device.create_stream("s2"), device.create_stream(),
               device.create_stream("default"), device.create_stream("replay.1")]
    lanes = {id(s.lane) for s in streams} | {id(device.ops_queue), id(device._replay_lane(1))}
    assert len(lanes) == len(streams) + 2
    assert device._replay_lane(1) is device._replay_lane(1)  # memoized
    assert device._replay_lane(0) is device.ops_queue


def test_torch_graph_dependent_chain_stays_one_segment(device, prog, jax_device, jprog):
    n = 64

    def run(core, dev, p):
        bufs = _bufs(dev, n, 3)
        with core.capture("seq") as g:
            g.write(bufs[0], np.zeros(n, np.float32))
            p.run([bufs[0]], "inc", out=[bufs[1]])
            p.run([bufs[1]], "inc", out=[bufs[2]])
            r = g.read(bufs[2])
        exe = g.instantiate()
        assert len(exe._segments) == 1 and not exe._fanout, repr(exe)
        return exe.replay().get()[r]

    got = run(tcore, device, prog)
    _same(got, np.full(n, 2.0, np.float32))
    _same(got, run(jcore, jax_device, jprog))


def test_torch_plan_matches_reference_plan(device, prog, jax_device, jprog):
    """The plan itself — segments, chains, keep set, donated syms, event
    edges — is the reference's, on a graph that has all of them."""
    n = 16

    def run(core, dev, p):
        a, b, c, ma, mb, out, spare = _bufs(dev, n, 7)
        c.enqueue_write(0, np.ones(n, np.float32)).get()
        with core.capture("plan") as g:
            g.write(a, np.ones(n, np.float32))
            g.write(b, np.full(n, 2.0, np.float32))
            p.run([a], "inc", out=[ma])
            p.run([b], "double", out=[mb])
            p.run([ma, c], "axpy", out=[ma])
            p.run([ma, mb], "axpy", out=[out])
            p.run([out], "double")
            g.read(spare)
        exe = g.instantiate()
        return ([(s.chain, [nd.kernel for nd in s.nodes], s.in_syms, s.out_syms, s.donated_ixs)
                 for s in exe._segments], sorted(exe._keep), sorted(exe._donated_syms),
                exe._event_edges)

    assert run(tcore, device, prog) == run(jcore, jax_device, jprog)


def test_torch_smoke_graph_phase_rehearsed_on_cpu(device, monkeypatch):
    """``chip_smoke.phase_graph`` end to end on the CPU device at a small
    size: every check passes but those only a card can meet (the CUDA
    graph as executor, the launches its capture recorded)."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    monkeypatch.setattr(smoke, "GRAPH_N", 1000)
    monkeypatch.setattr(smoke, "GRAPH_REPLAYS", 3)
    monkeypatch.setattr(smoke, "GRAPH_TIMED", 2)
    failed = []
    monkeypatch.setattr(smoke, "require", lambda ok, msg: ok or failed.append(msg))
    out = smoke.phase_graph(device)
    card_only = ("graph: executor ['staged']", "graph: the capture recorded {}",
                 "graph: the two-chain plan is")
    assert len(failed) == 3 and all(m.startswith(c) for m, c in zip(failed, card_only)), failed
    assert "fan-out" in out["two_chains"] and "3 segment(s)" in out["two_chains"]
    assert out["device_ms_per_step"] is None and len(out["host_us_per_step"]["replay"]) == 2
