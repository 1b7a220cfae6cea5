"""Graph plans over several devices (``repro_torch.core.graph``, DESIGN.md
§9): the port's multi-device ``GraphExec`` held against the JAX
package's on the CPU.

The reference's plan over 4 forced host devices
(``--xla_force_host_platform_device_count=4``, in a subprocess, as
``tests/test_scheduler.py`` runs it) must equal the port's over 4 logical
CPU devices (``REPRO_LOGICAL_DEVICES=4``): segments, chains, transfer
steps, event edges, the keep set and the donated syms, and the replayed
values bit for bit.  Random DAGs over 1-4 logical devices replay
bit-equal to the same DAG run eagerly; an extern spilled or moved between
two replays is brought back; the smoke's ``graph_fleet`` phase is
rehearsed at a small size.  On the CPU every segment replays ``staged``
on its chain's lane; the CUDA-graph half is in ``tests/test_torch_cuda.py``
and the smoke.
"""
import importlib.util
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # hypothesis not installed: deterministic fallback shim
    from _hypothesis_compat import given, settings, strategies as st

from repro_torch.core import HOST_KEY, TaskGraph, capture, get_all_devices, registry, reset_runtime

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = {"inc": lambda x: x + 1.0, "double": lambda x: x * 2.0, "axpy": lambda x, y: x + y}


@pytest.fixture(scope="module")
def fleet():
    """4 logical CPU devices; the device cache is dropped afterwards, so
    no later test sees a split CPU."""
    old = os.environ.get("REPRO_LOGICAL_DEVICES")
    os.environ["REPRO_LOGICAL_DEVICES"] = "4"
    try:
        devs = get_all_devices(platform="cpu").get()
    finally:
        if old is None:
            del os.environ["REPRO_LOGICAL_DEVICES"]
        else:
            os.environ["REPRO_LOGICAL_DEVICES"] = old
    assert [d.key for d in devs] == ["cpu:0", "cpu:0.1", "cpu:0.2", "cpu:0.3"]
    yield devs
    reset_runtime()


@pytest.fixture(scope="module")
def prog(fleet):
    return fleet[0].create_program(dict(KERNELS), name="fleet-graph").get()


def _host(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# the plan is the reference's (4 forced host devices, in a subprocess)
# ---------------------------------------------------------------------------

# One DAG over 4 devices with every piece of a plan: externs on two
# devices, a write, joins across devices, a buffer rewritten in place, a
# value read by two segments, an out-less launch, reads, and an out
# buffer homed on another device than the launch that writes it.
_DAG = textwrap.dedent(
    """
    def build(core, devs, prog, n=8):
        d0, d1, d2, d3 = devs
        p = [prog.for_device(d) for d in devs]
        x0 = d0.create_buffer_from(np.arange(n, dtype=np.float32)).get()
        x1 = d1.create_buffer_from(np.full(n, 3.0, np.float32)).get()
        w0, a, c = (d.create_buffer(n, np.float32).get() for d in (d2, d0, d2))
        b, o, z = (d.create_buffer(n, np.float32).get() for d in (d1, d3, d0))
        g = core.TaskGraph("plan4")
        w = g.write(w0, np.full(n, 5.0, np.float32))
        g.run(p[0], [x0], "inc", out=[a])           # d0
        g.run(p[1], [x1], "double", out=[b])        # d1, independent head
        g.run(p[2], [a, w0], "axpy", out=[c])       # d2: a crosses d0 -> d2
        g.run(p[2], [c], "inc", out=[c])            # d2, same chain: c rewritten
        g.run(p[3], [b, c], "axpy", out=[o])        # d3: a join of d1 and d2
        g.run(p[0], [a], "double", out=[a])         # d0: a read again, rewritten
        node = g.run(p[1], [o, x1], "axpy")         # d1: out-less, o crosses d3 -> d1
        reads = [g.read(o), g.read(a)]
        g.run(p[3], [o], "inc", out=[z])            # d3 writes z, homed on d0
        return g, w, node, reads, {"x0": x0, "z": z, "c": c, "b": b, "w0": w0}
    """
)

_REF_CHILD = textwrap.dedent(
    """
    import os, json
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                               + os.environ.get("XLA_FLAGS", ""))
    import numpy as np
    import repro.core as core
    """
) + _DAG + textwrap.dedent(
    """
    devs = core.get_all_devices(1, 0).get()
    assert len(devs) == 4, devs
    prog = devs[0].create_program(
        {"inc": lambda x: x + 1.0, "double": lambda x: x * 2.0, "axpy": lambda x, y: x + y},
        "fleet-graph").get()
    g, w, node, reads, bufs = build(core, devs, prog)
    exe = g.instantiate()
    keys = [d.key for d in devs]
    plan = {
        "segments": [[keys.index(s.device.key), s.chain, [n.kernel for n in s.nodes], s.in_syms,
                      s.out_syms, list(s.donated_ixs), list(s.transfer_ixs)] for s in exe._segments],
        "transfers": [[s, keys.index(a), keys.index(b)] for s, a, b in exe._transfers],
        "event_edges": [list(e) for e in exe._event_edges],
        "keep": sorted(exe._keep), "donated": sorted(exe._donated_syms),
    }
    values = []
    for feeds in (None, {w: np.full(8, -2.0, np.float32)}):
        res = exe.replay(feeds=feeds).get()
        values.append({"reads": [np.asarray(res[r]).tolist() for r in reads],
                       "outless": np.asarray(res[node]).tolist(),
                       "z": bufs["z"].enqueue_read_sync().tolist(),
                       "z_home": keys.index(core.registry.placement(bufs["z"].gid).device_key)})
    print("PLAN " + json.dumps({"plan": plan, "values": values}))
    """
)

exec(_DAG)  # noqa: S102 - the same builder, in this process, for the port


def _port_plan(exe, devs) -> dict:
    keys = [d.key for d in devs]
    return {
        "segments": [[keys.index(s.device.key), s.chain, [n.kernel for n in s.nodes], s.in_syms,
                      s.out_syms, list(s.donated_ixs), list(s.transfer_ixs)] for s in exe._segments],
        "transfers": [[s, keys.index(a), keys.index(b)] for s, a, b in exe._transfers],
        "event_edges": [list(e) for e in exe._event_edges],
        "keep": sorted(exe._keep), "donated": sorted(exe._donated_syms),
    }


def test_torch_multi_device_plan_equals_reference_over_4_devices(fleet, prog):
    env = dict(os.environ)
    env["PYTHONPATH"] = "src" + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, "-c", _REF_CHILD], capture_output=True, text=True,
                          env=env, cwd=ROOT, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = next(l for l in proc.stdout.splitlines() if l.startswith("PLAN "))
    ref = json.loads(line[len("PLAN "):])

    from repro_torch import core as tcore

    g, w, node, reads, bufs = build(tcore, fleet, prog)  # noqa: F821 - defined by exec(_DAG)
    exe = g.instantiate()
    assert _port_plan(exe, fleet) == ref["plan"]
    assert len({s.device.key for s in exe._segments}) == 4 and exe._transfers and exe._event_edges
    for feeds, want in zip((None, {w: np.full(8, -2.0, np.float32)}), ref["values"]):
        res = exe.replay(feeds=feeds).get()
        for r, v in zip(reads, want["reads"]):
            np.testing.assert_array_equal(res[r], np.asarray(v, np.float32))
        np.testing.assert_array_equal(_host(res[node]), np.asarray(want["outless"], np.float32))
        np.testing.assert_array_equal(bufs["z"].enqueue_read_sync(), np.asarray(want["z"], np.float32))
        assert [d.key for d in fleet].index(registry.placement(bufs["z"].gid).device_key) \
            == want["z_home"]
    assert bufs["z"].device is fleet[3]  # re-homed to the device that wrote it
    with pytest.raises(RuntimeError, match="donated"):
        bufs["w0"].enqueue_read_sync()  # write-fed, consumed across a transfer, kept by nothing
    rep = repr(exe)
    assert f"{len(exe._transfers)} transfer(s)" in rep and f"{len(exe._event_edges)} event edge(s)" in rep
    assert "fan-out" in rep and "no CUDA graph" in rep and exe.cuda_graphs == 0


# ---------------------------------------------------------------------------
# random DAGs over 1-4 logical devices: replays bit-equal to eager
# ---------------------------------------------------------------------------


def _random_dag(rng, devs):
    """(buffer homes, initial values, ops): an op is ("write", b) |
    ("run", device, kernel, arg buffers, out buffer or None) | ("read", b)."""
    nbuf = int(rng.integers(2, 6))
    homes = [int(rng.integers(len(devs))) for _ in range(nbuf)]
    init = [rng.integers(-8, 8, size=16).astype(np.float32) for _ in range(nbuf)]
    ops = []
    for _ in range(int(rng.integers(2, 13))):
        if rng.random() < 0.2:
            ops.append(("write", int(rng.integers(nbuf))))
        kernel = ["inc", "double", "axpy"][int(rng.integers(3))]
        args = [int(rng.integers(nbuf)) for _ in range(2 if kernel == "axpy" else 1)]
        out = None if rng.random() < 0.1 else int(rng.integers(nbuf))  # may rewrite an arg
        ops.append(("run", int(rng.integers(len(devs))), kernel, args, out))
        if rng.random() < 0.25:
            ops.append(("read", int(rng.integers(nbuf))))
    return homes, init, ops


@settings(max_examples=12, deadline=None)
@given(seed=st.integers(0, 2**31 - 1))
def test_torch_random_multi_device_dags_replay_bit_equal_to_eager(fleet, prog, seed):
    rng = np.random.default_rng(seed)
    devs = fleet[:int(rng.integers(1, 5))]
    homes, init, ops = _random_dag(rng, devs)
    gbufs = [devs[h].create_buffer_from(v).get() for h, v in zip(homes, init)]
    ebufs = [devs[h].create_buffer_from(v).get() for h, v in zip(homes, init)]
    g = TaskGraph("random")
    writes, handles = [], []
    for op in ops:
        if op[0] == "write":
            writes.append((op[1], g.write(gbufs[op[1]], np.zeros(16, np.float32))))
        elif op[0] == "run":
            _, d, kernel, args, out = op
            handles.append(g.run(prog.for_device(devs[d]), [gbufs[a] for a in args], kernel,
                                 out=None if out is None else [gbufs[out]]))
        else:
            handles.append(g.read(gbufs[op[1]]))
    exe = g.instantiate()
    final = {id(b): g._cur[id(b)] for b in gbufs if id(b) in g._cur}
    for it in range(3):
        feeds = {node: rng.integers(-8, 8, size=16).astype(np.float32) for _, node in writes}
        res = exe.replay(feeds=feeds).get()
        # the same DAG, eagerly, on the twin buffers
        want, feed_of = [], {id(node): f for node, f in feeds.items()}
        wi = 0
        for op in ops:
            if op[0] == "write":
                b, node = writes[wi]
                wi += 1
                ebufs[b].enqueue_write(0, feed_of[id(node)]).get()
            elif op[0] == "run":
                _, d, kernel, args, out = op
                got = prog.for_device(devs[d]).run([ebufs[a] for a in args], kernel,
                                                   out=None if out is None else [ebufs[out]]).get()
                want.append(_host(got) if out is None else None)
            else:
                want.append(ebufs[op[1]].enqueue_read_sync())
        for h, v in zip(handles, want):
            if v is not None:
                np.testing.assert_array_equal(_host(res[h]), v)
        internal = {id(b) for b in exe._fast.commit_invs}
        for gb, eb in zip(gbufs, ebufs):
            if id(gb) in internal:
                assert final[id(gb)] not in exe._keep
                with pytest.raises(RuntimeError, match="donated"):
                    gb.enqueue_read_sync()
                gb.enqueue_write(0, eb.enqueue_read_sync()).get()  # in step for the next replay
            else:
                np.testing.assert_array_equal(gb.enqueue_read_sync(), eb.enqueue_read_sync())
    wait = [b.free() for b in gbufs + ebufs]
    for f in wait:
        f.get()


# ---------------------------------------------------------------------------
# externs moved or spilled between replays; fences; the stream override
# ---------------------------------------------------------------------------


def _xdev(fleet, prog):
    """inc on device 0 -> double on device 1, x an extern on device 0."""
    d0, d1 = fleet[0], fleet[1]
    x = d0.create_buffer_from(np.arange(16, dtype=np.float32)).get()
    m = d0.create_buffer(16, np.float32).get()
    o = d1.create_buffer(16, np.float32).get()
    with capture("moved") as g:
        prog.for_device(d0).run([x], "inc", out=[m])
        prog.for_device(d1).run([m], "double", out=[o])
        r = o.enqueue_read()
    return g.instantiate(), x, r


@pytest.mark.parametrize("how", ["spilled", "moved"])
def test_torch_extern_spilled_or_moved_between_replays_is_brought_back(fleet, prog, how):
    d0, d2 = fleet[0], fleet[2]
    exe, x, r = _xdev(fleet, prog)
    assert exe._transfers == [(exe._segments[1].in_syms[0], d0.key, fleet[1].key)]
    np.testing.assert_array_equal(exe.replay().get()[r], (np.arange(16) + 1.0) * 2.0)
    if how == "spilled":
        before = d0.refetches
        assert x.spill().get() is True
        assert registry.placement(x.gid).device_key == HOST_KEY
        want = np.arange(16) + 1.0
    else:
        prog.for_device(d2).run([x], "double", out=[x]).get()  # x moves to device 2
        assert x.device is d2
        want = np.arange(16) * 2.0 + 1.0
    for _ in range(2):
        np.testing.assert_array_equal(exe.replay().get()[r], (want * 2.0).astype(np.float32))
    if how == "spilled":
        assert d0.refetches == before + 1 and registry.placement(x.gid).device_key == d0.key
    else:
        assert x.device is d2 and registry.placement(x.gid).device_key == d2.key
    np.testing.assert_array_equal(x.enqueue_read_sync(), (want - 1.0).astype(np.float32)
                                  if how == "spilled" else np.arange(16) * 2.0)


def test_torch_single_segment_plan_with_moved_extern_fans_out(fleet, prog):
    """One segment on device 0 whose extern then moves to device 1: the
    replay reads it on its new owner's lane and copies it back."""
    d0, d1 = fleet[0], fleet[1]
    x = d0.create_buffer_from(np.ones(16, np.float32)).get()
    o = d0.create_buffer(16, np.float32).get()
    g = TaskGraph("one-seg")
    g.run(prog, [x], "double", out=[o])
    r = g.read(o)
    exe = g.instantiate()
    assert not exe._multi_device and not exe._fanout and "pre-bound" in repr(exe)
    np.testing.assert_array_equal(exe.replay().get()[r], np.full(16, 2.0, np.float32))
    prog.for_device(d1).run([x], "inc", out=[x]).get()
    assert x.device is d1
    s = d0.create_stream()
    np.testing.assert_array_equal(exe.replay().get()[r], np.full(16, 4.0, np.float32))
    np.testing.assert_array_equal(s.replay(exe).get()[r], np.full(16, 4.0, np.float32))
    np.testing.assert_array_equal(exe.replay().get()[r], np.full(16, 4.0, np.float32))


def test_torch_multi_device_single_segment_plan_takes_a_stream(fleet, prog):
    """A single segment reading an extern on another device: a transfer
    step, no fan-out, and ``stream=`` still honoured (the reference's
    single-hop path); a fan-out plan still refuses it."""
    d0, d1 = fleet[0], fleet[1]
    x = d1.create_buffer_from(np.arange(16, dtype=np.float32)).get()
    o = d0.create_buffer(16, np.float32).get()
    g = TaskGraph("xdev-one")
    g.run(prog, [x], "inc", out=[o])
    r = g.read(o)
    exe = g.instantiate()
    assert exe._multi_device and not exe._fanout and len(exe._transfers) == 1, repr(exe)
    s = d0.create_stream()
    for res in (exe.replay().get(), s.replay(exe).get(), exe.replay(stream=s).get()):
        np.testing.assert_array_equal(res[r], np.arange(16, dtype=np.float32) + 1.0)
    fan, _, _ = _xdev(fleet, prog)
    with pytest.raises(ValueError, match="fan-out"):
        fan.replay(stream=s)


def test_torch_eager_ops_after_multi_device_dispatch_see_the_commit(fleet, prog):
    """An eager read submitted right after a ``sync="dispatch"`` replay of
    a plan over three devices returns observes the committed buffer; the
    values consumed across devices are graph-internal."""
    d0, d1, d2 = fleet[:3]
    a = d0.create_buffer(64, np.float32).get()
    m = d1.create_buffer(64, np.float32).get()
    o = d2.create_buffer(64, np.float32).get()
    with capture("fenced") as g:
        w = g.write(a)
        prog.for_device(d1).run([a], "inc", out=[m])
        prog.for_device(d2).run([m], "double", out=[o])
        prog.for_device(d0).run([o], "inc", out=[a])
    exe = g.instantiate()
    for i in range(5):
        fut = exe.replay(feeds={w: np.full(64, float(i), np.float32)}, sync="dispatch")
        np.testing.assert_array_equal(a.enqueue_read_sync(), np.full(64, (i + 1.0) * 2 + 1, np.float32))
        fut.get(timeout=60)
    assert a.device is d0 and registry.placement(a.gid).device_key == d0.key
    for buf in (m, o):  # consumed across devices, kept by nothing
        with pytest.raises(RuntimeError, match="donated"):
            buf.enqueue_read_sync()


def test_torch_failed_segment_fails_the_one_future_and_releases_the_plan(fleet):
    """A kernel that raises at replay fails the replay's future (its
    consumers on other devices fail with it), and the plan replays again."""
    d0, d1 = fleet[0], fleet[1]
    state = {"fail": False}

    def flaky(x):
        if state["fail"] and x.device.type != "meta":
            raise RuntimeError("flaky kernel")
        return x + 1.0

    p = d0.create_program({"flaky": flaky, "double": KERNELS["double"]}, "flaky").get()
    x = d0.create_buffer_from(np.ones(8, np.float32)).get()
    m = d0.create_buffer(8, np.float32).get()
    o = d1.create_buffer(8, np.float32).get()
    g = TaskGraph("flaky")
    g.run(p, [x], "flaky", out=[m])
    g.run(p.for_device(d1), [m], "double", out=[o])
    r = g.read(o)
    exe = g.instantiate()
    state["fail"] = True
    with pytest.raises(RuntimeError, match="flaky kernel"):
        exe.replay().get(timeout=60)
    state["fail"] = False
    np.testing.assert_array_equal(exe.replay().get(timeout=60)[r], np.full(8, 4.0, np.float32))


# ---------------------------------------------------------------------------
# the smoke's graph_fleet phase, rehearsed on the CPU
# ---------------------------------------------------------------------------


def test_torch_smoke_graph_fleet_phase_rehearsed_on_cpu(fleet, monkeypatch):
    """``chip_smoke.phase_graph_fleet`` over the 4 logical CPU devices on
    16 chunks of 2**10 f32: every replay (fused, staged) bit-equal to the
    eager ``run_on_any`` DAG and to one device's kernels, the plan's
    transfers and event edges as planned; only the check that every device
    has a CUDA graph fails (a CPU device has none)."""
    spec = importlib.util.spec_from_file_location("chip_smoke_graph_fleet",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    monkeypatch.setattr(smoke, "FIG4_N", 1 << 14)
    monkeypatch.setattr(smoke, "GRAPH_FLEET_REPLAYS", 3)
    monkeypatch.setattr(smoke, "GRAPH_FLEET_TIMED", 2)
    failed = []
    monkeypatch.setattr(smoke, "require", lambda ok, msg: ok or failed.append(msg))
    out = smoke.phase_graph_fleet(fleet)
    assert len(failed) == 1 and failed[0].startswith("graph_fleet: CUDA graphs on []"), failed
    assert out["devices"] == [d.key for d in fleet]
    assert out["segments"] == 32 and out["lanes"] == 32 and out["chunks"] == 16
    assert out["transfers"] == 16 and out["transfer_bytes_per_replay"] == 16 * (1 << 10) * 4
    assert out["event_edges"] == 16 and out["cross_device_event_edges"] == 16
    assert out["cuda_graphs"] == 0 and out["auto_exec_mode_per_segment"] == ["staged"] * 32
    assert out["device_ms_per_replay"] is None and out["device_only_ms_per_replay"] is None
    assert [len(v) for v in out["host_us_per_replay"].values()] == [2, 2, 2]
    assert out["_replayed"] == {} and out["recorded_launches"] == {}
