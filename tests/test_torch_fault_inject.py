"""The port's chaos layer (``repro_torch.fault.inject``) on the CPU.

The ports of the reference's tests that need no transport
(``tests/test_fault_inject.py``: a stalled lane seen by ``least_loaded``,
scheduler cordons, heartbeat flaps, seeded kill plans), the injector's
worker kills on the elastic trainer's ``LocalWorker`` with the log in
firing order, and the retry half of the reference's dropped-parcel test
without a transport: a stand-in port holds the injector's fault filter, and
a worker consults it before each shard, as a parcel port would before
each send.  The loopback forms of the parcel tests wait for the port's
parcel layer (ROADMAP.md Queue 1 item 10).
"""
import numpy as np
import pytest

from repro_torch.core import Future, get_all_devices
from repro_torch.core.executor import QueueLoad
from repro_torch.core.scheduler import Scheduler, make_policy
from repro_torch.fault.inject import FaultInjector, InjectedFault
from repro_torch.fault.monitor import Heartbeat
from repro_torch.training.elastic import ElasticTrainer, LocalWorker

ARCH, BATCH, SEQ = "olmo-1b", 6, 8


# ---------------------------------------------------------------------------
# lane stall, cordon, heartbeat corruption, scenario planning
# ---------------------------------------------------------------------------


def test_torch_stall_lane_visible_to_least_loaded():
    """A stalled lane is a SLOW device, not a dead one: its queue depth
    rises, ``least_loaded`` routes around it, and queued work completes
    once the stall drains."""
    dev = get_all_devices(platform="cpu").get()[0]
    inj = FaultInjector(seed=0)
    stall = inj.stall_lane(dev, 0.25)
    probe = dev.ops_queue.submit(lambda: 42)  # queues behind the stall
    load = dev.ops_queue.load()
    assert load.depth >= 1 or load.inflight >= 1

    class _IdleQueue:
        def load(self):
            return QueueLoad(depth=0, inflight=0, busy_for=0.0, busy_time=0.0,
                             submitted=0, completed=0)

    class _IdleDev:
        key = "cpu:idle"
        ops_queue = _IdleQueue()

    picked = make_policy("least_loaded").select([dev, _IdleDev()])
    assert picked.key == "cpu:idle"
    assert probe.get() == 42  # stalled, not lost
    stall.get()
    assert [f.kind for f in inj.log] == ["stall"]


def test_torch_cordon_excludes_device_until_uncordon():
    class _FakeQueue:
        def load(self):
            return QueueLoad(depth=0, inflight=0, busy_for=0.0, busy_time=0.0,
                             submitted=0, completed=0)

    class _FakeDev:
        def __init__(self, key):
            self.key = key
            self.ops_queue = _FakeQueue()

    devs = [_FakeDev("cpu:0"), _FakeDev("cpu:1")]
    sched = Scheduler(devs, policy="round_robin", steal=False)
    inj = FaultInjector(seed=0)
    inj.cordon_device(sched, "cpu:1")
    assert {sched.select().key for _ in range(4)} == {"cpu:0"}
    # cordoning the whole fleet waives the cordon instead of deadlocking
    inj.cordon_device(sched, "cpu:0")
    assert sched.select().key in {"cpu:0", "cpu:1"}
    inj.uncordon_device(sched, "cpu:0")
    inj.uncordon_device(sched, "cpu:1")
    assert {sched.select().key for _ in range(4)} == {"cpu:0", "cpu:1"}


def test_torch_corrupt_heartbeat_fires_on_dead_per_death():
    deaths = []
    hb = Heartbeat(timeout_s=60.0, on_dead=lambda: deaths.append(1))
    inj = FaultInjector(seed=0)
    hb.tick()
    assert hb.check()
    inj.corrupt_heartbeat(hb)
    assert not hb.check()  # death #1
    assert not hb.check()  # latched: no double fire
    assert len(deaths) == 1
    hb.tick()  # recovery clears the latch
    assert hb.check()
    inj.corrupt_heartbeat(hb)  # flap: death #2
    assert not hb.check()
    assert len(deaths) == 2
    assert all(f.kind == "hb_expire" for f in inj.log)


def test_torch_plan_kill_is_deterministic_and_in_range():
    victims = ["w0", "w1", "w2"]
    a = FaultInjector(seed=11).plan_kill(10, victims)
    b = FaultInjector(seed=11).plan_kill(10, victims)
    assert a == b
    for seed in range(20):
        k, v = FaultInjector(seed=seed).plan_kill(10, victims)
        assert 1 <= k < 10
        assert v in victims
    with pytest.raises(ValueError):
        FaultInjector(seed=0).plan_kill(10, [])


# ---------------------------------------------------------------------------
# worker kills on the elastic trainer's LocalWorker
# ---------------------------------------------------------------------------


def test_torch_kill_worker_and_kill_at_step_on_local_worker():
    """``kill_worker`` kills a ``LocalWorker`` at once (its heartbeat fires
    ``on_dead``); ``kill_at_step`` arms a death inside its shard at that
    step; ``plan_kill`` draws one; the log holds them in firing order."""
    deaths = []
    w0 = LocalWorker(0, on_dead=lambda: deaths.append(0), platform="cpu")
    w1 = LocalWorker(1, platform="cpu")
    inj = FaultInjector(seed=5)
    step, victim = inj.plan_kill(4, [w0, w1])
    inj.kill_worker(w0)
    assert not w0.alive() and deaths == [0]
    assert not w0.heartbeat.check()
    inj.kill_at_step(w1, 2)
    assert w1.alive()  # armed, not dead
    with pytest.raises(RuntimeError, match="killed by fault injection at step 2"):
        w1.run_shard({"step": 2}).get()
    assert not w1.alive()
    assert [(f.kind, f.target, f.detail) for f in inj.log] == [
        ("plan", str(victim.wid), float(step)), ("kill", "0", None),
        ("kill_at_step", "1", 2.0)]
    assert all(isinstance(f, InjectedFault) for f in inj.log)
    with pytest.raises(TypeError, match="don't know how to kill"):
        inj.kill_worker(object())


# ---------------------------------------------------------------------------
# dropped parcels: retry, then reshard (no transport)
# ---------------------------------------------------------------------------


class _StandInPort:
    """Holds the injector's fault filter, as a parcel port does."""

    def __init__(self):
        self.filter = None

    def set_fault_filter(self, fn) -> None:
        self.filter = fn


class _FilteredWorker(LocalWorker):
    """A local worker that asks the port's fault filter before each shard,
    as a parcel port asks before each send: a drop fails the shard's future
    with ``ParcelDropped`` before anything runs."""

    def __init__(self, wid, port, lid, **kw):
        super().__init__(wid, **kw)
        self.port, self.lid = port, lid

    def run_shard(self, task):
        verdict = self.port.filter(self.lid, "invoke") if self.port.filter else None
        if verdict is not None and verdict[0] == "drop":
            return Future.failed(verdict[1])
        return super().run_shard(task)


def test_torch_dropped_parcels_retry_then_reshard_without_transport():
    port = _StandInPort()
    inj = FaultInjector(seed=0)
    t = ElasticTrainer(ARCH, use_smoke=True, batch=BATCH, seq=SEQ, workers=0, total_steps=5,
                       max_retries=2, device="cpu")
    try:
        for wid, lid in ((0, 10), (1, 11)):
            t.workers.append(_FilteredWorker(wid, port, lid, platform="cpu"))
        lid0 = t.workers[0].lid
        # one transient drop: re-sent to the SAME worker, not a death
        inj.drop_parcels(port, actions=["invoke"], localities=[lid0], count=1)
        assert np.isfinite(t.step())
        assert [e[0] for e in t.events] == ["retry"]
        assert len(t.active_workers()) == 2
        # persistent drops: retries exhaust, link declared dead, reshard
        inj.drop_parcels(port, actions=["invoke"], localities=[lid0], p=1.0)
        assert np.isfinite(t.step())
        kinds = [e[0] for e in t.events]
        assert kinds.count("retry") == 1 + t.max_retries
        assert kinds.count("death") == 1
        assert [w.wid for w in t.active_workers()] == [1]
        assert [f.kind for f in inj.log] == ["drop"] * (1 + 1 + t.max_retries)
        assert {f.target for f in inj.log} == {f"L{lid0}"}
    finally:
        inj.clear_parcel_faults(port)
        t.close()
    assert port.filter is None
