"""The port's data pipeline (``repro_torch.data.pipeline``) and fault
monitor (``repro_torch.fault.monitor``) on the CPU: the port of
``tests/test_pipeline_and_fault.py`` (deterministic batches, order and
resume, prefetch over a slow producer, heartbeats, flaps, stragglers),
plus ``SyntheticTokens`` bit-equal to the JAX package's batches.
"""
import time

import numpy as np
import pytest

from repro.data.pipeline import SyntheticTokens as JaxSyntheticTokens
from repro_torch.data.pipeline import Pipeline, SyntheticTokens
from repro_torch.fault.monitor import Heartbeat, StepMonitor


def test_torch_synthetic_tokens_deterministic_by_index():
    src = SyntheticTokens(1000, 16, 4, seed=9)
    a = src.batch(3)
    b = src.batch(3)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = src.batch(4)
    assert not np.array_equal(a["tokens"], c["tokens"])
    np.testing.assert_array_equal(a["labels"][:, :-1], a["tokens"][:, 1:])


@pytest.mark.parametrize("seed,index", [(0, 0), (9, 3), (5, 17)])
def test_torch_synthetic_tokens_bit_equal_to_reference(seed, index):
    ours = SyntheticTokens(50304, 64, 4, seed=seed).batch(index)
    theirs = JaxSyntheticTokens(50304, 64, 4, seed=seed).batch(index)
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype == np.int32
        np.testing.assert_array_equal(ours[k], theirs[k])


def test_torch_pipeline_order_and_resume():
    src = SyntheticTokens(100, 8, 2, seed=1)
    pipe = Pipeline(src, depth=2, device="cpu")
    i0, b0 = pipe.get()
    i1, b1 = pipe.get()
    assert (i0, i1) == (0, 1)
    cursor = pipe.state()["cursor"]
    assert cursor == 2
    # resume from cursor reproduces the stream
    pipe2 = Pipeline(src, start=cursor, depth=2, device="cpu")
    i2, b2 = pipe2.get()
    assert i2 == 2
    np.testing.assert_array_equal(b2["tokens"].numpy(), src.batch(2)["tokens"])
    pipe.close()
    pipe2.close()


def test_torch_pipeline_prefetch_overlaps_slow_producer():
    class Slow(SyntheticTokens):
        def batch(self, i):
            time.sleep(0.05)
            return super().batch(i)

    pipe = Pipeline(Slow(100, 8, 2), depth=3, device="cpu")
    time.sleep(0.25)  # let prefetch fill
    t0 = time.perf_counter()
    pipe.get()
    pipe.get()
    assert time.perf_counter() - t0 < 0.09  # served from prefetch, not 2x50ms
    pipe.close()


def test_torch_pipeline_refuses_mesh_shardings():
    """A key with a sharding is placed by it, each rank slicing its own
    copy (``src_data_rank=None``: no collective on the prefetch thread);
    the other keys stay plain tensors."""
    calls = []

    class Sharding:
        def distribute(self, x, *, src_data_rank=0):
            calls.append((tuple(x.shape), src_data_rank))
            return ("placed", x)

    src = SyntheticTokens(100, 8, 2)
    pipe = Pipeline(src, shardings={"tokens": Sharding()}, depth=1, device="cpu")
    try:
        idx, batch = pipe.get()
    finally:
        pipe.close()
    assert batch["tokens"][0] == "placed" and calls[0] == ((2, 8), None)
    np.testing.assert_array_equal(batch["tokens"][1].numpy(), src.batch(idx)["tokens"])
    np.testing.assert_array_equal(batch["labels"].numpy(), src.batch(idx)["labels"])


def test_torch_heartbeat_detects_death():
    died = []
    hb = Heartbeat(timeout_s=0.05, on_dead=lambda: died.append(1))
    hb.tick()
    assert hb.check()
    time.sleep(0.08)
    assert not hb.check()
    assert died == [1]


def test_torch_heartbeat_flap_fires_on_dead_per_death():
    # dead -> tick (recovery) -> dead again: the latch clears on recovery,
    # so the second death fires on_dead again
    died = []
    hb = Heartbeat(timeout_s=0.05, on_dead=lambda: died.append(1))
    hb.tick()
    time.sleep(0.08)
    assert not hb.check()
    assert not hb.check()  # still dead: edge-triggered, no re-fire
    assert died == [1]
    hb.tick()  # worker resumes
    assert hb.check()  # recovery reads alive AND re-arms the latch
    time.sleep(0.08)
    assert not hb.check()
    assert died == [1, 1]  # second death fired again


def test_torch_step_monitor_flags_stragglers():
    mon = StepMonitor(alpha=0.5, threshold=2.0, warmup=2)
    for i in range(5):
        assert mon.record(i, 0.1) is None
    ev = mon.record(5, 0.5)
    assert ev is not None and ev.ratio > 2
    # straggler does not poison the EWMA
    assert mon.ewma < 0.2
    assert mon.record(6, 0.1) is None
