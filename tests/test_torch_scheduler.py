"""The port's placement scheduler (``repro_torch.core.scheduler``) held
against the JAX package's ``repro.core.scheduler``: the port of
``tests/test_scheduler.py``.

Policy and scheduler decisions run the same sequences of loads, argument
bytes and fakes through both packages: the chosen device keys, ``stats()``
and the ``spill_lru`` order must be equal.  The runtime half (load
accounting, AGAS reverse index, buffer lifetime, spill and refetch, the
steal pool, ``run_on_any``) runs on the port's CPU devices, where the
reference's forced 8 host devices become 8 logical CPU devices
(``REPRO_LOGICAL_DEVICES=8``), in-process.
"""
import functools
import gc
import threading
import time

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # hypothesis not installed: deterministic fallback shim
    from _hypothesis_compat import given, settings, strategies as st

import repro.core.scheduler as jsched
from repro.core import get_all_devices as jax_get_all_devices
from repro.core import registry as jax_registry
from repro.core.executor import QueueLoad as JaxQueueLoad
from repro_torch.core import (
    HOST_KEY,
    QueueLoad,
    Scheduler,
    TaskGraph,
    capture,
    get_all_devices,
    get_all_localities,
    get_runtime,
    get_scheduler,
    make_policy,
    registry,
    reset_runtime,
    set_scheduler,
    wait_all,
)
from repro_torch.core import scheduler as tsched
from repro_torch.core.scheduler import LeastLoadedPolicy
from repro_torch.kernels.partition_map.ref import partition_map_ref

# ---------------------------------------------------------------------------
# policy decisions, both packages (duck-typed fakes: policies read only
# key / ops_queue.load / resident_bytes / memory_limit)
# ---------------------------------------------------------------------------

SIDES = {"jax": (jsched, JaxQueueLoad), "torch": (tsched, QueueLoad)}


def _both(fn):
    """``fn(scheduler_module, QueueLoad)`` on both packages; the results
    must be equal, and the port's is returned."""
    got = {side: fn(*mods) for side, mods in SIDES.items()}
    assert got["torch"] == got["jax"], got
    return got["torch"]


class _FakeQueue:
    def __init__(self, load_cls, depth=0, busy_time=0.0):
        self.load_cls, self.depth, self.busy_time = load_cls, depth, busy_time

    def load(self):
        return self.load_cls(depth=self.depth, inflight=1 if self.depth else 0, busy_for=0.0,
                             busy_time=self.busy_time, submitted=self.depth, completed=0)


class _FakeDevice:
    def __init__(self, load_cls, key, depth=0, busy_time=0.0):
        self.key = key
        self.ops_queue = _FakeQueue(load_cls, depth, busy_time)

    def __repr__(self):
        return f"_FakeDevice({self.key})"


class _MemDevice(_FakeDevice):
    def __init__(self, load_cls, key, resident=0, limit=0):
        super().__init__(load_cls, key)
        self._resident = resident
        self.memory_limit = limit

    def resident_bytes(self):
        return self._resident


class _FakeBuf:
    """Affinity arg: anything exposing device + nbytes counts."""

    def __init__(self, device, nbytes):
        self.device, self.nbytes = device, nbytes


def _fleet(load_cls, n=4):
    return [_FakeDevice(load_cls, f"cpu:{i}") for i in range(n)]


def test_torch_static_policy_pins_one_device():
    def run(m, Q):
        devs = _fleet(Q)
        return [m.StaticPolicy().select(devs).key for _ in range(5)], \
            m.StaticPolicy(index=2).select(devs).key

    assert _both(run) == (["cpu:0"] * 5, "cpu:2")


def test_torch_round_robin_cycles_through_fleet():
    def run(m, Q):
        devs, p = _fleet(Q, 3), m.RoundRobinPolicy()
        return [p.select(devs).key for _ in range(7)]

    assert _both(run) == ["cpu:0", "cpu:1", "cpu:2", "cpu:0", "cpu:1", "cpu:2", "cpu:0"]


@pytest.mark.parametrize("depths,want", [((3, 1, 0, 2), "cpu:2"), ((0, 2, 2, 2), "cpu:0"),
                                         ((5, 5, 5, 4), "cpu:3")])
def test_torch_least_loaded_prefers_idle_queue(depths, want):
    def run(m, Q):
        devs = _fleet(Q, 4)
        for d, n in zip(devs, depths):
            d.ops_queue.depth = n
        return m.LeastLoadedPolicy().select(devs).key

    assert _both(run) == want


def test_torch_least_loaded_ties_rotate_not_pile_up():
    def run(m, Q):
        devs, p = _fleet(Q, 3), m.LeastLoadedPolicy()
        blind = [p.select(devs).key for _ in range(4)]  # a blind signal: round-robin spread
        devs[1].ops_queue.depth = 2
        return blind, [p.select(devs).key for _ in range(4)]

    blind, loaded = _both(run)
    assert blind == ["cpu:0", "cpu:1", "cpu:2", "cpu:0"]
    assert set(loaded) == {"cpu:0", "cpu:2"}  # the loaded queue is skipped


def test_torch_affinity_avoids_percolation():
    def run(m, Q):
        devs = _fleet(Q, 4)
        devs[2].ops_queue.depth = 5  # resident data outweighs load ...
        args = [_FakeBuf(devs[2], nbytes=1 << 20), _FakeBuf(devs[0], nbytes=16)]
        # ... and with no resident args it degrades to least_loaded
        return (m.AffinityPolicy().select(devs, args=args).key,
                m.AffinityPolicy().select(devs, args=[np.ones(4)]).key)

    assert _both(run) == ("cpu:2", "cpu:0")


def test_torch_arg_home_of_tensors_buffers_and_fakes():
    """A tensor homes to its card's device while the card is not split, as
    a committed jax.Array does (the split card: the logical-devices test
    below); anything without a home scores nothing; fakes by their key."""
    jdev = jax_get_all_devices(1, 0).get()[0]
    import jax
    import jax.numpy as jnp

    arr = jax.device_put(jnp.ones(16, jnp.float32), jdev.jax_device)
    assert tsched._arg_home(torch.ones(16)) == jsched._arg_home(arr) == ("cpu:0", 64)
    assert tsched._arg_home(np.ones(4)) == jsched._arg_home(np.ones(4)) == (None, 0)
    fake = _FakeBuf(_FakeDevice(QueueLoad, "cpu:5"), 8)
    assert tsched._arg_home(fake) == jsched._arg_home(fake) == ("cpu:5", 8)


def test_torch_make_policy_rejects_unknown():
    for m in (jsched, tsched):
        with pytest.raises(ValueError, match="unknown placement policy"):
            m.make_policy("fifo")
        p = m.RoundRobinPolicy()
        assert m.make_policy(p) is p  # instances pass through
    assert sorted(tsched.POLICIES) == sorted(jsched.POLICIES)
    assert make_policy("affinity").name == "affinity"


def test_torch_scheduler_records_placement_stats():
    def run(m, Q):
        s = m.Scheduler(_fleet(Q, 2), policy="round_robin")
        return [s.select().key for _ in range(4)], s.stats()

    assert _both(run)[1] == {"cpu:0": 2, "cpu:1": 2}


def test_torch_affinity_ties_rotate_across_equal_hosts():
    def run(m, Q):
        devs = _fleet(Q, 3)
        args = [_FakeBuf(devs[1], nbytes=1024), _FakeBuf(devs[2], nbytes=1024)]
        p = m.AffinityPolicy()
        return [p.select(devs, args=args).key for _ in range(4)]

    picked = _both(run)
    assert set(picked) == {"cpu:1", "cpu:2"} and picked[0] != picked[1]


def test_torch_percolation_ties_rotate_across_equal_costs():
    def run(m, Q):
        devs = _fleet(Q, 2)
        foreign = _FakeBuf(_FakeDevice(Q, "cpu:9"), nbytes=512)  # the same bytes move anywhere
        p = m.PercolationPolicy()
        return [p.select(devs, args=[foreign]).key for _ in range(4)]

    assert _both(run) == ["cpu:0", "cpu:1", "cpu:0", "cpu:1"]


def test_torch_select_batch_cold_start_spreads_over_fleet():
    def run(m, Q):
        s = m.Scheduler(_fleet(Q, 4), policy="least_loaded", steal=False)
        return [s.select_batch([[np.ones(4, np.float32)]]).key for _ in range(4)]

    assert len(set(_both(run))) == 4  # blind batches round-robin, no pile-up


def test_torch_occupancy_recent_free_probe_ignores_own_charge():
    def run(m, Q):
        devs = _fleet(Q, 2)
        s = m.Scheduler(devs, policy="least_loaded", steal=False)
        base = s.occupancy(devs[0])
        s.charge(devs[0], 4)
        return s.occupancy(devs[0]) > base, s.occupancy(devs[0], recent=False) == base

    assert _both(run) == (True, True)


def test_torch_select_batch_prefer_holds_against_self_repulsion():
    def run(m, Q):
        s = m.Scheduler(_fleet(Q, 4), policy="least_loaded", steal=False)
        home = s.select_batch([[np.ones(4, np.float32)]])
        s.charge(home, 7)
        keys = []
        for _ in range(5):
            dev = s.select_batch([[np.ones(4, np.float32)]], prefer=home.key)
            keys.append(dev.key)
            s.charge(dev, 7)
        return home.key, keys, s.stats()

    home, keys, stats = _both(run)
    assert keys == [home] * 5 and stats[home] == 6


@pytest.mark.parametrize("depth,want", [(20, "cpu:1"), (8, "cpu:0")])
def test_torch_select_batch_prefer_yields_only_to_structural_load(depth, want):
    """A real backlog beyond the 16.0 slack moves the batch; a burst's
    in-flight window within it holds the home."""
    def run(m, Q):
        devs = _fleet(Q, 2)
        devs[0].ops_queue.depth = depth
        s = m.Scheduler(devs, policy="least_loaded", steal=False)
        return s.select_batch([[np.ones(4, np.float32)]], prefer="cpu:0").key

    assert _both(run) == want


def test_torch_select_batch_prefer_ignored_by_non_load_policies():
    def run(m, Q):
        s = m.Scheduler(_fleet(Q, 3), policy="round_robin", steal=False)
        return [s.select_batch([[np.ones(4, np.float32)]], prefer="cpu:0").key for _ in range(3)]

    assert _both(run) == ["cpu:0", "cpu:1", "cpu:2"]


def test_torch_memory_veto_skips_near_full_device():
    def run(m, Q):
        full, empty = _MemDevice(Q, "cpu:0", 900, 1000), _MemDevice(Q, "cpu:1", 0, 1000)
        s = m.Scheduler([full, empty], policy="least_loaded", steal=False)
        arg = _FakeBuf(empty, nbytes=500)  # foreign to cpu:0: 900 + 500 > limit
        vetoed = [s.select(args=[arg]).key for _ in range(3)]
        s2 = m.Scheduler([full, empty], policy="least_loaded", steal=False)
        return vetoed, sorted({s2.select().key for _ in range(4)}), s.stats()

    assert _both(run) == (["cpu:1"] * 3, ["cpu:0", "cpu:1"], {"cpu:1": 3})


def test_torch_memory_veto_everything_full_still_places():
    def run(m, Q):
        devs = [_MemDevice(Q, f"cpu:{i}", resident=2000, limit=1000) for i in range(2)]
        s = m.Scheduler(devs, policy="least_loaded", steal=False)
        return s.select(args=[_FakeBuf(_FakeDevice(Q, "cpu:9"), nbytes=64)]).key

    assert _both(run) in {"cpu:0", "cpu:1"}  # degraded, not dead


def test_torch_scheduler_refuses_a_fleet_across_localities(device):
    """A fleet across localities is placed now, as the reference places it
    (the data's home wins under ``percolation``); what still refuses one is
    the paged engine: shipping sequences' pages between processes is
    ROADMAP item 10b."""
    from repro_torch.serving.paged import PagedKVCache, PagedServeEngine, PageSpec

    def run(m, Q):
        local, remote = _FakeDevice(Q, "cpu:0"), _FakeDevice(Q, "L1/cpu:0")
        s = m.Scheduler([local, remote], policy="percolation", steal=False)
        return [s.select(args=[_FakeBuf(remote, 1 << 20)]).key,
                s.select(args=[_FakeBuf(local, 1 << 20)]).key, sorted(s.stats().items())]

    assert _both(run)[:2] == ["L1/cpu:0", "cpu:0"]
    kv = PagedKVCache(PageSpec(1, 4, 1, 4), devices=[device], pool_pages=8)
    fleet = Scheduler([device, _FakeDevice(QueueLoad, "L1/cpu:0")])
    with pytest.raises(NotImplementedError, match="Queue 1 item 10b"):
        PagedServeEngine(kv, lambda t, e: None, lambda *a: None, max_seq_len=16, scheduler=fleet)
    assert tsched.locality_of_key("L3/cpu:0") == jsched.locality_of_key("L3/cpu:0") == 3


# ---------------------------------------------------------------------------
# runtime signals, AGAS reverse index, buffer lifetime (the port's devices)
# ---------------------------------------------------------------------------


@pytest.fixture()
def device():
    return get_all_devices(1, 0, platform="cpu").get()[0]


@pytest.fixture()
def fleet8(monkeypatch):
    """8 logical CPU devices (the reference's forced 8 host devices); the
    device cache is dropped afterwards, so no later test sees a split card."""
    monkeypatch.setenv("REPRO_LOGICAL_DEVICES", "8")
    devs = get_all_devices(1, 0, platform="cpu").get()
    yield devs
    reset_runtime()


def test_torch_workqueue_load_counts_backlog():
    q = get_runtime().queue("test-torch-load-accounting")
    assert q.load().depth == 0
    gate, started = threading.Event(), threading.Event()

    def _block():
        started.set()
        gate.wait(10)

    f = q.submit(_block)
    rest = [q.submit(lambda: None) for _ in range(3)]
    assert started.wait(10)
    load = q.load()
    assert load.depth == 4 and load.inflight == 1 and load.busy_for >= 0.0
    gate.set()
    wait_all([f] + rest)
    load = q.load()
    assert load.depth == 0 and load.inflight == 0
    assert load.completed == load.submitted and load.busy_time > 0.0


def test_torch_reverse_index_and_resident_bytes(device):
    base = registry.resident_bytes(device.key)
    buf = device.create_buffer(256, np.float32).get()
    assert buf.gid in registry.gids_on(device.key, kind="buffer")
    assert registry.resident_bytes(device.key) == device.resident_bytes() == base + 1024
    buf.free().get()
    assert registry.resident_bytes(device.key) == base
    assert buf.gid not in registry.gids_on(device.key)


def test_torch_buffer_free_is_terminal_and_idempotent(device):
    buf = device.create_buffer(8, np.float32).get()
    buf.free().get()
    buf.free().get()  # idempotent: the second free is a ready no-op
    with pytest.raises(RuntimeError, match="freed"):
        buf.array()
    with pytest.raises(KeyError):
        registry.resolve(buf.gid)


def test_torch_free_is_ordered_after_pending_launches(device):
    prog = device.create_program({"double": lambda x: x * 2.0}, name="free-order").get()
    buf = device.create_buffer_from(np.arange(8, dtype=np.float32)).get()
    fut = prog.run([buf], "double")
    buf.free()  # queued behind the launch: the launch still reads live storage
    np.testing.assert_allclose(np.asarray(fut.get()), np.arange(8.0) * 2.0)
    with pytest.raises(RuntimeError, match="freed"):
        buf.enqueue_read().get()


def test_torch_collected_buffer_unregisters_via_finalizer(device):
    base = registry.resident_bytes(device.key)
    buf = device.create_buffer(512, np.float32).get()
    gid = buf.gid
    assert registry.resident_bytes(device.key) == base + 2048
    del buf
    gc.collect()
    with pytest.raises(KeyError):
        registry.resolve(gid)
    assert gid not in registry.gids_on(device.key)
    assert registry.resident_bytes(device.key) == base


def test_torch_copy_to_between_logical_devices_is_a_real_copy(fleet8):
    """``copy_to`` registers the bytes on the target, and between two
    logical devices of one card it copies (no aliasing of the source)."""
    a, b = fleet8[0], fleet8[3]
    src = a.create_buffer_from(np.arange(16, dtype=np.float32)).get()
    for target in (a, b):
        moved = src.copy_to(target).get()
        assert moved.gid in registry.gids_on(target.key, kind="buffer")
        assert moved.array().data_ptr() != src.array().data_ptr()
        np.testing.assert_array_equal(moved.enqueue_read_sync(), np.arange(16.0))
        moved.free().get()
    src.enqueue_write(0, np.zeros(16, np.float32)).get()
    src.free().get()


def test_torch_logical_devices_have_their_own_keys_lanes_and_limits(fleet8, monkeypatch):
    assert [d.key for d in fleet8] == ["cpu:0"] + [f"cpu:0.{j}" for j in range(1, 8)]
    assert len({id(d.ops_queue) for d in fleet8}) == 8
    assert len({id(d.compile_queue) for d in fleet8}) == 8
    assert all(d.torch_device == torch.device("cpu") for d in fleet8)
    # a tensor on the split card scores toward none of them; buffers do
    assert tsched._arg_home(torch.ones(4)) == (None, 0)
    buf = fleet8[5].create_buffer(4, np.float32).get()
    assert tsched._arg_home(buf) == ("cpu:0.5", 16)
    assert registry.resident_bytes("cpu:0.5") >= 16 and buf.gid not in registry.gids_on("cpu:0")
    buf.free().get()
    monkeypatch.setenv("REPRO_SPILL_BYTES", "4096")
    monkeypatch.setenv("REPRO_LOGICAL_DEVICES", "9")
    assert get_all_devices(platform="cpu").get()[8].memory_limit == 4096
    assert fleet8[0].memory_limit == 0  # seeded once, at creation


def test_torch_default_discovery_is_one_device_a_card(monkeypatch):
    monkeypatch.delenv("REPRO_LOGICAL_DEVICES", raising=False)
    devs = get_all_devices(1, 0, platform="cpu").get()
    assert [d.key for d in devs] == ["cpu:0"] and devs[0].logical == 0


def test_torch_localities_group_by_process(device):
    from repro_torch.core import LoopbackParcelport

    locs = get_all_localities(1, 0, platform="cpu").get()
    assert len(locs) == 1 and locs[0].is_local and device in list(locs[0])
    port = LoopbackParcelport(2, platform="cpu")
    try:
        locs = get_all_localities(1, 0, platform="cpu", cluster=port).get()
        assert [loc.is_local for loc in locs] == [True, False, False]
        assert [loc.process_index for loc in locs[1:]] == [d.locality_id for d in port.devices()]
        # what is still refused: a cluster of CUDA localities without a card
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="found no cuda device"):
                LoopbackParcelport(1)
    finally:
        port.shutdown()


def test_torch_run_on_any_single_device(device):
    prog = device.create_program({"double": lambda x: x * 2.0}, name="any").get()
    sched = Scheduler([device], policy="least_loaded")
    out = device.create_buffer(4, np.float32).get()
    prog.run_on_any([np.arange(4, dtype=np.float32)], "double", out=[out], scheduler=sched).get()
    np.testing.assert_allclose(out.enqueue_read_sync(), [0.0, 2.0, 4.0, 6.0])
    assert sched.stats() == {device.key: 1}
    # over a cluster: the port's scheduler places on the localities grid,
    # and a remote pick runs the sibling RemoteProgram as parcels; a
    # closure kernel runs there by its shadow (loopback shares this
    # process), a name unknown to the registry is still refused
    from repro_torch.core import LoopbackParcelport, register_kernel

    register_kernel("double", lambda x: x * 2.0)
    port = LoopbackParcelport(1, platform="cpu")
    try:
        rdev = port.devices()[0]
        res = prog.run_on_any([np.ones(4, np.float32)], "double",
                              scheduler=Scheduler([rdev], policy="static")).get()
        np.testing.assert_allclose(np.asarray(res[0]), np.full(4, 2.0))
        bad = device.create_program({"no_such_kernel_anywhere": lambda x: x}).get()
        with pytest.raises(KeyError, match="not resolvable"):
            bad.run_on_any([np.ones(4, np.float32)], "no_such_kernel_anywhere",
                           scheduler=Scheduler([rdev], policy="static")).get()
    finally:
        port.shutdown()


def test_torch_select_batch_places_every_batch(device):
    """The reference's ``route_batches`` test (``serve_step.route_batches``
    comes with ROADMAP item 8): every batch is one logged decision and runs
    where it was placed."""
    sched = Scheduler([device], policy="round_robin")
    prog = device.create_program({"double": lambda x: x * 2.0}, name="batches").get()
    batches = [np.full(4, i, np.float32) for i in range(3)]
    futs = [prog.for_device(sched.select_batch([[b]])).run([b], "double") for b in batches]
    for i, f in enumerate(futs):
        np.testing.assert_allclose(np.asarray(f.get()), np.full(4, 2.0 * i))
    assert sched.stats() == {device.key: 3}


def test_torch_default_scheduler_is_process_wide():
    set_scheduler(None)
    s1, s2 = get_scheduler(), get_scheduler()
    assert s1 is s2
    mine = Scheduler(policy="round_robin")
    set_scheduler(mine)
    try:
        assert get_scheduler() is mine
    finally:
        set_scheduler(None)


def test_torch_reset_runtime_recycles_device_cache():
    dev = get_all_devices(1, 0, platform="cpu").get()[0]
    dev.create_buffer(4, np.float32).get()
    old_gid = dev.gid
    set_scheduler(Scheduler([dev]))
    reset_runtime()
    with pytest.raises(KeyError):
        registry.resolve(old_gid)
    fresh = get_all_devices(1, 0, platform="cpu").get()[0]
    buf = fresh.create_buffer_from(np.arange(4.0, dtype=np.float32)).get()
    np.testing.assert_allclose(buf.enqueue_read_sync(), np.arange(4.0))
    # the default scheduler went with the runtime: a fresh one is built
    set_scheduler(Scheduler([fresh]))
    try:
        assert get_scheduler().select().ops_queue is fresh.ops_queue
    finally:
        set_scheduler(None)


def test_torch_busy_ewma_rises_with_work_then_decays(monkeypatch):
    from repro_torch.core import executor

    monkeypatch.setattr(executor, "_LOAD_HALFLIFE", 0.05)
    q = get_runtime().queue("test-torch-busy-ewma")
    q.submit(lambda: time.sleep(0.12)).get()
    hot = q.load().busy_ewma
    assert hot > 0.25, hot  # just burned > 1 tau of wall time
    time.sleep(0.4)  # 8 half-lives: the signal forgets
    cold = q.load().busy_ewma
    assert cold < 0.1 and cold < hot, (hot, cold)


def test_torch_least_loaded_sees_recent_busy_time_not_just_depth(monkeypatch):
    from repro_torch.core import executor

    monkeypatch.setattr(executor, "_LOAD_HALFLIFE", 0.5)

    class _Shell:
        def __init__(self, key, q):
            self.key, self.ops_queue = key, q

    busy = _Shell("cpu:0", get_runtime().queue("test-torch-occ-busy"))
    idle = _Shell("cpu:1", get_runtime().queue("test-torch-occ-idle"))
    busy.ops_queue.submit(lambda: time.sleep(0.6)).get()
    p = LeastLoadedPolicy()
    assert all(p.select([busy, idle]).key == "cpu:1" for _ in range(3))


# ---------------------------------------------------------------------------
# spill / refetch
# ---------------------------------------------------------------------------


def test_torch_spill_refetch_keeps_resident_bytes_honest(device):
    base_dev = registry.resident_bytes(device.key)
    base_host = registry.resident_bytes(HOST_KEY)
    spills, refetches = device.spills, device.refetches
    data = np.arange(256, dtype=np.float32)
    buf = device.create_buffer_from(data).get()
    assert registry.resident_bytes(device.key) == base_dev + 1024
    assert buf.spill().get() is True
    assert registry.placement(buf.gid).device_key == HOST_KEY
    assert registry.resident_bytes(device.key) == base_dev
    assert registry.resident_bytes(HOST_KEY) == base_host + 1024
    assert registry.spilled_bytes() >= 1024
    assert buf.spill().get() is False  # idempotent: nothing left to evict
    # transparent refetch: bit-equal data, the record moves back
    np.testing.assert_array_equal(buf.enqueue_read_sync(), data)
    assert registry.placement(buf.gid).device_key == device.key
    assert registry.resident_bytes(device.key) == base_dev + 1024
    assert registry.resident_bytes(HOST_KEY) == base_host
    assert (device.spills, device.refetches) == (spills + 1, refetches + 1)
    # a full overwrite makes the host copy dead: discarded, not refetched
    buf.spill().get()
    buf.enqueue_write(0, data * 3.0).get()
    assert registry.placement(buf.gid).device_key == device.key
    assert registry.resident_bytes(HOST_KEY) == base_host
    np.testing.assert_array_equal(buf.enqueue_read_sync(), data * 3.0)
    assert (device.spills, device.refetches) == (spills + 2, refetches + 1)
    buf.free().get()
    assert registry.resident_bytes(device.key) == base_dev


@settings(max_examples=5, deadline=None)
@given(n=st.integers(1, 4096), seed=st.integers(0, 2**31 - 1))
def test_torch_spill_roundtrip_is_bit_exact(n, seed):
    device = get_all_devices(1, 0, platform="cpu").get()[0]
    data = np.random.default_rng(seed).normal(size=(n,)).astype(np.float32)
    buf = device.create_buffer_from(data).get()
    try:
        assert buf.spill().get() is True
        assert np.asarray(buf.enqueue_read_sync()).tobytes() == data.tobytes()
        assert registry.placement(buf.gid).device_key == device.key
        # a launch refetches too
        prog = device.create_program({"neg": lambda x: -x}, name="spill-launch").get()
        assert buf.spill().get() is True
        assert np.asarray(prog.run([buf], "neg").get()).tobytes() == (-data).tobytes()
    finally:
        buf.free().get()


def test_torch_rehome_while_spilled_keeps_host_record(fleet8):
    device, other = fleet8[0], fleet8[1]
    buf = device.create_buffer_from(np.ones(64, np.float32)).get()
    buf.spill().get()
    buf._rehome(other)  # re-homing a spilled handle must not lie about bytes
    assert registry.placement(buf.gid).device_key == HOST_KEY
    np.testing.assert_array_equal(buf.enqueue_read_sync(), np.ones(64))
    assert registry.placement(buf.gid).device_key == other.key
    buf.free().get()


def _spill_order(devs_and_bufs, need_bytes):
    """The LRU spill order of ``bufs`` (by index) under ``sched.spill_lru``."""
    sched, dev, bufs = devs_and_bufs
    order = []
    for i, b in enumerate(bufs):
        b.spill = functools.partial(lambda i, f: (order.append(i), f())[1], i, b.spill)
    wait_all(sched.spill_lru(dev, need_bytes))
    return order


def test_torch_spill_lru_order_matches_reference(device):
    """The same ages and byte need through both packages spill the same
    buffers in the same order (oldest first), and nothing else."""
    ages = [-3.0, -9.0, -1.0, -7.0, -5.0]  # older than any other buffer of the process
    sides = {}
    for side, dev, reg, mod in (("jax", jax_get_all_devices(1, 0).get()[0], jax_registry, jsched),
                                ("torch", device, registry, tsched)):
        bufs = [dev.create_buffer_from(np.zeros(256, np.float32)).get() for _ in ages]
        for b, a in zip(bufs, ages):
            b._last_use = a
        order = _spill_order((mod.Scheduler([dev], steal=False), dev, bufs), 3 * 1024 - 1)
        homes = [reg.placement(b.gid).device_key for b in bufs]
        sides[side] = (order, [h == dev.key for h in homes])
        wait_all([b.free() for b in bufs])
    assert sides["torch"] == sides["jax"]
    assert sides["torch"][0] == [1, 3, 4]  # the three oldest, oldest first


def test_torch_memory_pressure_triggers_lru_spill_on_placement(device):
    victim = device.create_buffer_from(np.zeros(256, np.float32)).get()
    victim._last_use = -100.0
    s = Scheduler([device], policy="least_loaded", steal=False, spill_bytes=1)
    s.select(args=[_FakeBuf(_FakeDevice(QueueLoad, "cpu:9"), nbytes=4096)])
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline and registry.placement(victim.gid).device_key != HOST_KEY:
        time.sleep(0.01)
    assert registry.placement(victim.gid).device_key == HOST_KEY
    victim.free().get()


def test_torch_spill_lru_never_evicts_kept_gids(device):
    keeper = device.create_buffer_from(np.zeros(256, np.float32)).get()
    keeper._last_use = -100.0  # oldest, but protected
    s = Scheduler([device], policy="least_loaded", steal=False)
    futs = s.spill_lru(device, 1, keep={keeper.gid})
    wait_all(futs)
    assert registry.placement(keeper.gid).device_key == device.key
    keeper.free().get()


# ---------------------------------------------------------------------------
# steal pool: tail-stealing invariants on real lanes
# ---------------------------------------------------------------------------


class _QueueDevice:
    """A real WorkQueue behind a device-shaped shell: the pump/steal
    protocol runs against real FIFO lanes while the launch is synthetic."""

    def __init__(self, key):
        self.key = key
        self.ops_queue = get_runtime().queue(f"torch-steal-{key}")


class _RecordingProgram:
    """``for_device``/``run`` shaped like Program; logs (task id, device
    key), the task id being the last argument."""

    def __init__(self, log, delays=None):
        self.log = log
        self.delays = dict(delays or {})

    def for_device(self, dev):
        return _BoundRecording(self, dev)


class _BoundRecording:
    def __init__(self, root, dev):
        self._root, self._dev = root, dev

    def run(self, args, name, grid=None, block=None, out=None, sync="ready"):
        root, dev = self._root, self._dev

        def _work():
            d = root.delays.get(dev.key, 0.0)
            if d:
                time.sleep(d)
            root.log.append((args[-1], dev.key))
            return args[-1] * 2

        return dev.ops_queue.submit(_work)


@settings(max_examples=5, deadline=None)
@given(n=st.integers(6, 18), delay_ms=st.integers(5, 25))
def test_torch_steal_tail_preserves_victim_head_fifo(n, delay_ms):
    log = []
    devs = [_QueueDevice(f"sp{i}") for i in range(3)]
    prog = _RecordingProgram(log, delays={"sp0": delay_ms / 1000.0})
    sched = Scheduler(devs, policy="static", steal=True)
    futs = [sched.submit(prog, [i], "k") for i in range(n)]
    assert [f.get() for f in futs] == [2 * i for i in range(n)]
    assert len(log) == n and {tid for tid, _ in log} == set(range(n))
    ran_on_victim = [tid for tid, key in log if key == "sp0"]
    assert ran_on_victim == sorted(ran_on_victim), log
    assert sched.steal_stats()["steals"] >= 1 and sched.steal_stats()["pending"] == {}


def test_torch_steal_byte_gate_blocks_expensive_migrations():
    log = []
    devs = [_QueueDevice(f"bg{i}") for i in range(3)]
    heavy = _FakeBuf(devs[0], nbytes=1 << 20)
    prog = _RecordingProgram(log, delays={"bg0": 0.01})
    sched = Scheduler(devs, policy="static", steal=True, steal_max_bytes=1024)
    futs = [sched.submit(prog, [heavy, i], "k") for i in range(6)]
    assert [f.get() for f in futs] == [2 * i for i in range(6)]
    assert {key for _, key in log} == {"bg0"}, log  # nothing migrated
    assert sched.steal_stats()["steals"] == 0


def test_torch_steal_disabled_uses_direct_launch_path(device, monkeypatch):
    assert Scheduler([device, device], steal=False).steals is False
    monkeypatch.setenv("REPRO_STEAL", "off")
    assert Scheduler([device, device]).steals is False  # the env knob
    monkeypatch.setenv("REPRO_STEAL", "auto")
    assert Scheduler([device]).steals is False  # one device: nothing to balance
    assert Scheduler([device, device]).steals is True


def test_torch_run_on_any_routes_through_steal_pool(device):
    prog = device.create_program({"double": lambda x: x * 2.0}, name="steal-route").get()
    sched = Scheduler([device, _QueueDevice("sr1")], policy="static", steal=True)
    fut = prog.run_on_any([np.arange(4, dtype=np.float32)], "double", scheduler=sched)
    np.testing.assert_allclose(np.asarray(fut.get()), [0.0, 2.0, 4.0, 6.0])
    assert sched.stats()[device.key] == 1


# ---------------------------------------------------------------------------
# integration over 8 logical CPU devices (the reference's forced 8 host
# devices, in-process)
# ---------------------------------------------------------------------------


def _iterated_map(x):
    """fig6's partition workload, compute-dense (an iterated map)."""
    for _ in range(32):
        x = partition_map_ref(x) * 0.5 + x * 0.5
    return x


def test_torch_scheduler_integration_8_logical_devices(fleet8):
    devices = fleet8
    prog = devices[0].create_program({"k": _iterated_map}, "partition").get()
    parts = [np.random.default_rng(i).normal(size=(1 << 17,)).astype(np.float32)
             for i in range(8)]
    want = [_iterated_map(torch.from_numpy(p)) for p in parts]

    def pipeline(sched):
        futs = [prog.run_on_any([p], "k", scheduler=sched) for p in parts]
        wait_all(futs)
        return [f.get() for f in futs]

    # placement spread: least_loaded fills the 8-device fleet, bit-equal
    sched_ll = Scheduler(devices, policy="least_loaded")
    got = pipeline(sched_ll)
    assert len(sched_ll.stats()) == 8, sched_ll.stats()
    assert all(torch.equal(g, w) for g, w in zip(got, want))

    # least_loaded beats static placement on a 2-device fleet (stealing off:
    # the placement signal alone), one intra-op thread as the reference's
    # single-threaded Eigen; interleaved min-of-reps, retried on spikes
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        def time_policy(policy):
            sched = Scheduler(devices[:2], policy=policy, steal=False)
            t0 = time.perf_counter()
            pipeline(sched)
            return time.perf_counter() - t0

        time_policy("static")
        time_policy("least_loaded")
        best = float("inf")
        for _ in range(4):
            t_s = t_l = float("inf")
            for _ in range(3):
                t_s = min(t_s, time_policy("static"))
                t_l = min(t_l, time_policy("least_loaded"))
            best = min(best, t_l / t_s)
            if best < 0.9:
                break
    finally:
        torch.set_num_threads(threads)
    assert best < 1.0, best

    # affinity keeps the work where the bytes are (no percolation)
    target = devices[5]
    big = target.create_buffer_from(np.ones(1 << 16, np.float32)).get()
    aff = Scheduler(devices, policy="affinity")
    out = target.create_buffer(1 << 16, np.float32).get()
    prog.run_on_any([big], "k", out=[out], scheduler=aff).get()
    assert aff.stats() == {target.key: 1}
    assert registry.placement(out.gid).device_key == target.key

    # captured multi-device graph (recorded through run_on_any) replays
    # through ONE future: per-device segments + an explicit transfer
    d0, d1 = devices[0], devices[1]
    p2 = d0.create_program({"inc": lambda x: x + 1.0, "scale": lambda x: x * 3.0}, "g").get()
    b_in = d0.create_buffer(16, np.float32).get()
    t_mid = d0.create_buffer(16, np.float32).get()
    t_out = d1.create_buffer(16, np.float32).get()
    rr = Scheduler([d0, d1], policy="round_robin")
    with capture("xdev") as g:
        w = b_in.enqueue_write(0, np.ones(16, np.float32))
        p2.run_on_any([b_in], "inc", out=[t_mid], scheduler=rr)     # -> cpu:0
        p2.run_on_any([t_mid], "scale", out=[t_out], scheduler=rr)  # -> cpu:0.1
        r = t_out.enqueue_read()
    assert rr.stats() == {d0.key: 1, d1.key: 1}
    exe = g.instantiate()
    assert exe._fanout and len(exe._segments) == 2, repr(exe)
    assert len(exe._transfers) >= 1, repr(exe)
    res = exe.replay().get()  # ONE future for the whole graph
    np.testing.assert_array_equal(res[r], np.full(16, 6.0, np.float32))
    res2 = exe.replay(feeds={w: np.full(16, 2.0, np.float32)}).get()
    np.testing.assert_array_equal(res2[r], np.full(16, 9.0, np.float32))
    assert registry.placement(t_out.gid).device_key == d1.key

    # fan-out donation safety: a sym consumed by two segments that may run
    # concurrently (both depend only on the producer) is never donated
    a0 = d0.create_buffer(8, np.float32).get()
    m1 = d0.create_buffer(8, np.float32).get()
    o1 = d1.create_buffer(8, np.float32).get()
    o2 = d0.create_buffer(8, np.float32).get()
    ga = TaskGraph("donate-race")
    ga.write(a0, np.ones(8, np.float32))
    ga.run(p2.for_device(d0), [a0], "inc", out=[m1])    # seg 0 (dev0) -> m1
    ga.run(p2.for_device(d1), [m1], "scale", out=[o1])  # seg 1 (dev1) reads m1
    ga.run(p2.for_device(d0), [m1], "inc", out=[o2])    # seg 2 (dev0) reads m1 too
    r1, r2 = ga.read(o1), ga.read(o2)
    m1_sym = ga._cur[id(m1)]
    exe_a = ga.instantiate()
    assert exe_a._fanout and len(exe_a._segments) == 3, repr(exe_a)
    assert m1_sym not in exe_a._donated_syms  # concurrent readers: no donation
    res_a = exe_a.replay().get()
    np.testing.assert_array_equal(res_a[r1], np.full(8, 6.0, np.float32))  # (1+1)*3
    np.testing.assert_array_equal(res_a[r2], np.full(8, 3.0, np.float32))  # (1+1)+1


def test_torch_steal_recovers_throttled_lane_8_logical_devices(fleet8, monkeypatch):
    monkeypatch.delenv("REPRO_STEAL", raising=False)
    devices = fleet8

    class Throttled:
        """A per-task brake on one device's default lane."""

        def __init__(self, q, delay):
            self._q, self._delay = q, delay

        def submit(self, fn, *a, **k):
            def slow(*aa, **kk):
                time.sleep(self._delay)
                return fn(*aa, **kk)

            return self._q.submit(slow, *a, **k)

        def __getattr__(self, name):
            return getattr(self._q, name)

    prog = devices[0].create_program({"k": lambda x: x * 2.0 + 1.0}, "steal").get()
    parts = [np.random.default_rng(i).normal(size=(4096,)).astype(np.float32) for i in range(32)]

    def run(steal):
        sched = Scheduler(devices, policy="round_robin", steal=steal)
        t0 = time.perf_counter()
        futs = [prog.run_on_any([p], "k", scheduler=sched) for p in parts]
        res = [np.asarray(f.get()) for f in futs]
        return time.perf_counter() - t0, res, sched

    run(True)
    run(False)  # warm every sibling's build cache first
    monkeypatch.setattr(devices[0], "ops_queue", Throttled(devices[0].ops_queue, 0.30))
    best, sched_on = 0.0, None
    for _ in range(4):
        t_off, res_off, _ = run(False)
        t_on, res_on, sched_on = run(True)
        for a, b in zip(res_off, res_on):
            assert a.tobytes() == b.tobytes()  # bit-equal, stolen or not
        best = max(best, t_off / max(t_on, 1e-9))
        if best >= 1.5:
            break
    assert best >= 1.5, best
    assert sched_on.steal_stats()["steals"] > 0, sched_on.steal_stats()
