"""The paged KV cache and ``PagedServeEngine`` over a fleet of page pools,
held against the JAX package on the CPU: the port of
``tests/test_paged.py``'s fleet, spill, defrag and concurrency tests.

* Page moves: ``_pow2_pad_idx``, ``write_pages``/``read_pages`` and the
  same sequences of new/free/spill/refetch/defrag operations on both caches
  give the same page tables; contents survive every interleaving; the
  slabs are never rebound (``defrag``, ``set_arrays``, a refetch work in
  place, so a captured step graph stays valid).
* Spill, refetch, ``migrate`` between logical devices (8 logical CPU
  devices, ``REPRO_LOGICAL_DEVICES``), LRU order, lock discipline (a spill
  waits for a held sequence; ``defrag`` never deadlocks against spillers).
* The engine, driven through the zoo contract with smoke configs (the
  reference drives a legacy toy model, which the port refuses): greedy
  tokens over 2 logical CPU devices under page pressure (spills, deferred
  steps, refetches), under a concurrent spiller and across a forced
  migration equal the JAX package's single-device padded oracle
  (``tests/test_paged_models.py``) for the dense and the mamba2 configs.
"""
import functools
import sys
import threading
import time

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # hypothesis not installed: deterministic fallback shim
    from _hypothesis_compat import given, settings, strategies as st

from repro.core import get_all_devices as jax_get_all_devices
from repro.serving.paged import OutOfPages as JaxOutOfPages
from repro.serving.paged import PagedKVCache as JaxPagedKVCache
from repro.serving.paged import PageSpec as JaxPageSpec
from repro.serving.paged import _pow2_pad_idx as jax_pow2_pad_idx
from repro_torch.core import PlacementPolicy, Scheduler, agas, get_all_devices, reset_runtime
from repro_torch.serving import LanePolicy, OutOfPages, PagedKVCache, PagedServeEngine, PageSpec
from repro_torch.serving.paged import _pow2_pad_idx
from test_torch_paged_models import MAX_NEW, MAX_SEQ, _jax_oracle, _pair, _port_oracle


@pytest.fixture()
def fleet(monkeypatch):
    """Logical CPU devices (8; the tests take what they need); the device
    cache is dropped afterwards, so no later test sees a split card."""
    monkeypatch.setenv("REPRO_LOGICAL_DEVICES", "8")
    devs = get_all_devices(platform="cpu").get()
    yield devs
    reset_runtime()


@pytest.fixture(scope="module")
def jax_device():
    return jax_get_all_devices(1, 0).get()[0]


def _spec(P=2, torch_side=True):
    return (PageSpec if torch_side else JaxPageSpec)(layers=1, page_size=P, kv_heads=1,
                                                      head_dim=2)


def _fill(spec, seq_id, tokens):
    """Token t of sequence s holds s * 1000 + t (k) and its negation (v)."""
    base = np.arange(tokens, dtype=np.float32) + seq_id * 1000.0
    k = np.broadcast_to(base[None, :, None, None],
                        (spec.layers, tokens, spec.kv_heads, spec.head_dim)).copy()
    return k, -k


def _append(kv, seq, spec, sid, tokens):
    k, v = _fill(spec, sid, tokens)
    if isinstance(kv, PagedKVCache):
        k, v = torch.from_numpy(k), torch.from_numpy(v)
    kv.append(seq, k, v)


def _check_invariants(kv):
    """No page leaked, no page double-owned, page 0 never owned."""
    for key, pool in kv.pools.items():
        owned = [p for s in kv._seqs.values() if s.pool is pool for p in s.pages]
        assert 0 not in owned, f"{key}: reserved page 0 owned"
        assert len(owned) == len(set(owned)), f"{key}: page double-owned"
        free = set(pool._free)
        assert not (free & set(owned)), f"{key}: page both free and owned"
        assert len(free) + len(owned) == pool.num_pages - 1, f"{key}: page leaked"


def _seq_tokens(seq):
    """Token values of ``seq``'s k pages, or of their host copy while it is
    spilled (first ``length``)."""
    k, v = seq._spilled if seq.spilled else seq.pool.read_pages(seq.pages)
    flat = k.movedim(0, 1).reshape(k.shape[1], -1, k.shape[3], k.shape[4])
    np.testing.assert_array_equal(v.movedim(0, 1).reshape(flat.shape)[0, :seq.length].numpy(),
                                  -flat[0, :seq.length].numpy())
    return flat[0, :seq.length, 0, 0].numpy()


# ---------------------------------------------------------------------------
# page moves and pool invariants, against the JAX cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 9, 129])
def test_torch_pow2_pad_idx_matches_jax(n):
    idx = np.arange(3, 3 + n, dtype=np.int64)
    got = _pow2_pad_idx(idx)
    np.testing.assert_array_equal(got, jax_pow2_pad_idx(idx))
    assert len(got) & (len(got) - 1) == 0 and (got[n:] == idx[-1]).all()


def test_torch_write_read_pages_match_jax_in_place(jax_device):
    """``write_pages`` of 3 pages (index padded to 4) and ``read_pages``
    give the reference's page contents; the slabs keep their storage."""
    spec, jspec = PageSpec(2, 4, 2, 3), JaxPageSpec(2, 4, 2, 3)
    device = get_all_devices(platform="cpu").get()[0]
    kv = PagedKVCache(spec, devices=[device], pool_pages=8)
    jkv = JaxPagedKVCache(jspec, devices=[jax_device], pool_pages=8)
    pool, jpool = kv.pool_of(device), jkv.pool_of(jax_device)
    rng = np.random.default_rng(0)
    k = rng.normal(size=(3, 2, 4, 2, 3)).astype(np.float32)
    v = rng.normal(size=(3, 2, 4, 2, 3)).astype(np.float32)
    ptrs = [t.data_ptr() for t in pool.arrays()]
    pool.write_pages([5, 2, 6], torch.from_numpy(k), torch.from_numpy(v))
    jpool.write_pages([5, 2, 6], k, v)
    assert [t.data_ptr() for t in pool.arrays()] == ptrs
    for mine, theirs in zip(pool.arrays(), jpool.arrays()):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
    for mine, theirs in zip(pool.read_pages([6, 5]), jpool.read_pages([6, 5])):
        np.testing.assert_array_equal(mine.numpy(), theirs)
    assert pool.read_pages([])[0].shape == (0, 2, 4, 2, 3)
    ks, vs = (t.clone() for t in pool.arrays())
    pool.set_arrays(ks * 2, vs * 2)  # copied into the same slab tensors
    assert [t.data_ptr() for t in pool.arrays()] == ptrs
    np.testing.assert_array_equal(pool.arrays()[0].numpy(), ks.numpy() * 2)


@settings(max_examples=4, deadline=None)
@given(seed=st.integers(0, 2**31 - 1))
def test_torch_alloc_free_defrag_invariants_match_jax(seed):
    """40 random new/free/defrag/spill/refetch operations on both caches:
    the same page tables after every one, the invariants hold, and the
    contents survive."""
    device = get_all_devices(platform="cpu").get()[0]
    jdev = jax_get_all_devices(1, 0).get()[0]
    spec, jspec = _spec(), _spec(torch_side=False)
    kv = PagedKVCache(spec, devices=[device], pool_pages=24)
    jkv = JaxPagedKVCache(jspec, devices=[jdev], pool_pages=24)
    ptrs = [t.data_ptr() for t in kv.pool_of(device).arrays()]
    rng = np.random.default_rng(seed)
    live, next_id = {}, 0
    for _ in range(40):
        op = rng.choice(["new", "free", "defrag", "spill", "resident"])
        if op == "new":
            tokens = int(rng.integers(1, 7))
            if kv.pool_of(device).num_free < spec.pages_for(tokens):
                continue
            seq, jseq = kv.new_seq(device), jkv.new_seq(jdev)
            _append(kv, seq, spec, next_id, tokens)
            _append(jkv, jseq, jspec, next_id, tokens)
            live[next_id] = (seq, jseq, tokens)
            next_id += 1
        elif op == "free" and live:
            seq, jseq, _ = live.pop(int(rng.choice(list(live))))
            kv.free_seq(seq), jkv.free_seq(jseq)
        elif op == "defrag":
            assert kv.defrag(device) == jkv.defrag(jdev)
        elif op == "spill" and live:
            seq, jseq, _ = live[int(rng.choice(list(live)))]
            assert seq.spill().get() == jseq.spill().get()
        elif op == "resident" and live:
            seq, jseq, _ = live[int(rng.choice(list(live)))]
            for s, err in ((seq, OutOfPages), (jseq, JaxOutOfPages)):
                try:
                    s.ensure_resident()
                except err:
                    pass
            assert seq.spilled == jseq.spilled
        _check_invariants(kv)
        for seq, jseq, _ in live.values():
            assert seq.pages == jseq.pages and seq.spilled == jseq.spilled
    assert [t.data_ptr() for t in kv.pool_of(device).arrays()] == ptrs  # never rebound
    for sid, (seq, jseq, tokens) in live.items():
        np.testing.assert_array_equal(_seq_tokens(seq), np.arange(tokens) + sid * 1000.0)
    for seq, jseq, _ in live.values():
        kv.free_seq(seq), jkv.free_seq(jseq)
    assert kv.pool_of(device).used_pages == 0


def test_torch_defrag_compacts_in_place_and_preserves_contents():
    device = get_all_devices(platform="cpu").get()[0]
    spec = _spec()
    kv = PagedKVCache(spec, devices=[device], pool_pages=16)
    seqs = []
    for sid in range(4):
        seq = kv.new_seq(device)
        _append(kv, seq, spec, sid, 4)
        seqs.append(seq)
    kv.free_seq(seqs[0])
    kv.free_seq(seqs[2])  # holes at the front and in the middle
    ptrs = [t.data_ptr() for t in kv.pool_of(device).arrays()]
    assert kv.defrag(device) > 0
    assert [t.data_ptr() for t in kv.pool_of(device).arrays()] == ptrs
    live = sorted(p for s in (seqs[1], seqs[3]) for p in s.pages)
    assert live == list(range(1, len(live) + 1))  # compacted to the low slots
    for sid in (1, 3):
        np.testing.assert_array_equal(_seq_tokens(seqs[sid]), np.arange(4) + sid * 1000.0)
    assert kv.defrag(device) == 0  # idempotent once compact
    kv.free_seq(seqs[1])
    kv.free_seq(seqs[3])


def test_torch_seq_pages_spill_and_refetch_pages_and_state():
    """A spill returns the pages to the pool and moves the bytes (pages and
    state) to the host record; the refetch brings both back bit-exact."""
    device = get_all_devices(platform="cpu").get()[0]
    spec = _spec()
    kv = PagedKVCache(spec, devices=[device], pool_pages=16)
    before = agas.registry.resident_bytes(device.key)
    seq = kv.new_seq(device)
    _append(kv, seq, spec, 7, 5)  # 3 pages
    state = {"ssm": torch.randn(2, 3, generator=torch.Generator().manual_seed(0))}
    seq.set_state({"ssm": state["ssm"].clone()})
    assert seq.nbytes == 3 * spec.page_bytes + 24
    assert agas.registry.resident_bytes(device.key) == before + seq.nbytes
    pool = kv.pool_of(device)
    free_before = pool.num_free
    assert seq.spill().get() is True and seq.spilled
    assert pool.num_free == free_before + 3 and seq.nbytes == 0
    assert agas.registry.resident_bytes(device.key) == before
    assert agas.registry.placement(seq.gid).device_key == agas.HOST_KEY
    assert seq.spill().get() is False  # nothing left to evict
    seq.ensure_resident()
    assert agas.registry.placement(seq.gid).device_key == device.key
    assert torch.equal(seq.state["ssm"], state["ssm"])
    np.testing.assert_array_equal(_seq_tokens(seq), np.arange(5) + 7000.0)
    assert kv.stats()[device.key]["spills"] == 1 and kv.stats()[device.key]["refetches"] == 1
    kv.free_seq(seq)
    assert agas.registry.resident_bytes(device.key) == before


def test_torch_spill_lru_evicts_cold_sequence_first():
    device = get_all_devices(platform="cpu").get()[0]
    spec = _spec()
    kv = PagedKVCache(spec, devices=[device], pool_pages=16)
    cold, hot = kv.new_seq(device), kv.new_seq(device)
    _append(kv, cold, spec, 0, 4)
    _append(kv, hot, spec, 1, 4)
    cold._last_use = -100.0  # the oldest spillable resident of the device
    for f in Scheduler([device], policy="least_loaded").spill_lru(device, need_bytes=1):
        f.get()
    assert cold.spilled and not hot.spilled
    kv.free_seq(cold), kv.free_seq(hot)


def test_torch_migrate_between_logical_devices(fleet):
    """One coalesced move: contents preserved, the source pages freed, the
    AGAS record and the bytes re-homed; a second migrate is a no-op."""
    devs = fleet[:4]
    spec = _spec()
    kv = PagedKVCache(spec, devices=devs, pool_pages=16)
    seq = kv.new_seq(devs[0])
    _append(kv, seq, spec, 5, 5)
    seq.set_state({"s": torch.arange(4.0)})
    src_free = kv.pool_of(devs[0]).num_free
    # Buffers that other tests of the process left on the device: the
    # migrate must take this sequence's record away and add none.
    on_src = set(agas.registry.gids_on(devs[0].key, kind="buffer")) - {seq.gid}
    assert seq.gid in agas.registry.gids_on(devs[0].key, kind="buffer")
    kv.migrate(seq, devs[2])
    assert seq.pool is kv.pool_of(devs[2]) and seq.device is devs[2]
    assert agas.registry.placement(seq.gid).device_key == devs[2].key == "cpu:0.2"
    assert kv.pool_of(devs[0]).num_free == src_free + 3
    assert agas.registry.resident_bytes(devs[2].key) >= seq.nbytes
    assert set(agas.registry.gids_on(devs[0].key, kind="buffer")) == on_src
    np.testing.assert_array_equal(_seq_tokens(seq), np.arange(5) + 5000.0)
    assert torch.equal(seq.state["s"], torch.arange(4.0))
    kv.migrate(seq, devs[2])
    # a spilled sequence migrates through its refetch
    seq.spill().get()
    kv.migrate(seq, devs[1])
    np.testing.assert_array_equal(_seq_tokens(seq), np.arange(5) + 5000.0)
    _check_invariants(kv)
    kv.free_seq(seq)


def test_torch_spill_serializes_against_held_seq_lock():
    """A decode step holds the sequence's lock through the step; a racing
    spill waits for it and never frees the pages mid-step."""
    device = get_all_devices(platform="cpu").get()[0]
    spec = _spec()
    kv = PagedKVCache(spec, devices=[device], pool_pages=16)
    seq = kv.new_seq(device)
    _append(kv, seq, spec, 1, 4)
    seq._lock.acquire()  # an in-flight decode step pinning the sequence
    try:
        f = seq.spill()
        time.sleep(0.05)
        assert not f.done() and seq.pages and not seq.spilled
    finally:
        seq._lock.release()
    assert f.get(timeout=30) is True and seq.spilled
    kv.free_seq(seq)


def test_torch_defrag_no_deadlock_with_concurrent_spillers():
    """defrag takes the sequence locks before the pool lock, the order of
    spill and refetch: no deadlock, and the contents survive."""
    device = get_all_devices(platform="cpu").get()[0]
    spec = _spec()
    kv = PagedKVCache(spec, devices=[device], pool_pages=32)
    seqs = []
    for sid in range(6):
        seq = kv.new_seq(device)
        _append(kv, seq, spec, sid, 4)
        seqs.append(seq)
    stop = threading.Event()

    def churner(offset):
        i = offset
        while not stop.is_set():
            s = seqs[i % len(seqs)]
            try:
                s._spill_now()
                s.ensure_resident()
            except OutOfPages:
                pass
            i += 1

    threads = [threading.Thread(target=churner, args=(i,), daemon=True) for i in range(2)]
    for t in threads:
        t.start()
    d = threading.Thread(target=lambda: [kv.defrag(device) for _ in range(50)], daemon=True)
    d.start()
    d.join(timeout=60)
    deadlocked = d.is_alive()
    stop.set()
    for t in threads:
        t.join(timeout=30)
    assert not deadlocked, "defrag deadlocked against concurrent spill"
    assert not any(t.is_alive() for t in threads)
    for sid, seq in enumerate(seqs):
        seq.ensure_resident()
        np.testing.assert_array_equal(_seq_tokens(seq), np.arange(4) + sid * 1000.0)
    _check_invariants(kv)
    for seq in seqs:
        kv.free_seq(seq)


def test_torch_pool_allocations_yield_to_an_admission():
    """While a thread makes room for an admission (``PagePool.admit``), no
    other thread allocates from the pool (a lane's refetch or growth would
    take the pages a spill freed); the admitting thread does."""
    device = get_all_devices(platform="cpu").get()[0]
    pool = PagedKVCache(_spec(), devices=[device], pool_pages=8).pool_of(device)
    pool.admit(+1)
    got = {}

    def other():
        try:
            pool.alloc(1)
        except OutOfPages as e:
            got["err"] = str(e)

    th = threading.Thread(target=other)
    th.start()
    th.join(timeout=10)
    assert "admission is making room" in got["err"] and pool.admitting
    mine = pool.alloc(2)  # the admitting thread allocates
    pool.admit(-1)
    assert not pool.admitting
    th = threading.Thread(target=lambda: got.update(pages=pool.alloc(1)))
    th.start()
    th.join(timeout=10)
    assert len(got["pages"]) == 1 and pool.num_free == 4
    pool.free(mine + got["pages"])


def test_torch_capture_gate_excludes_device_work_during_a_capture():
    """``_CaptureGate``: shared holds nest and overlap; a capture waits for
    them, holds back new ones while it waits, runs alone, and refuses to
    start inside a shared hold (it would wait for itself)."""
    from repro_torch.serving.paged import _CaptureGate

    gate, log = _CaptureGate(), []
    inside, release = threading.Event(), threading.Event()

    def holder():
        with gate.shared(), gate.shared():  # nested: one hold
            inside.set()
            release.wait(10)
            log.append("holder done")

    def capture():
        with gate.exclusive():
            log.append("capture")

    def late():
        with gate.shared():
            log.append("late")

    h = threading.Thread(target=holder)
    h.start()
    assert inside.wait(10)
    c = threading.Thread(target=capture)
    c.start()
    while not gate._waiting:
        time.sleep(0.001)
    t = threading.Thread(target=late)  # arrives while the capture waits
    t.start()
    time.sleep(0.05)
    assert log == []
    release.set()
    for th in (h, c, t):
        th.join(timeout=10)
    assert not any(th.is_alive() for th in (h, c, t))
    assert log == ["holder done", "capture", "late"]
    with gate.shared(), pytest.raises(RuntimeError, match="wait for itself"):
        with gate.exclusive():
            pass


# ---------------------------------------------------------------------------
# the engine over a fleet, smoke configs through the zoo contract
# ---------------------------------------------------------------------------

PROMPT_LENS = (17, 14, 20, 5, 24, 9)  # one crosses a page boundary while decoding


@functools.lru_cache(maxsize=None)
def _oracles(arch):
    """(JAX padded oracle tokens, the port's) for PROMPT_LENS."""
    jc, tc, jparams, tparams = _pair(arch)
    prompts = _prompts(tc)
    return ([_jax_oracle(jc, jparams, p) for p in prompts],
            [_port_oracle(tc, tparams, p) for p in prompts])


def _prompts(cfg):
    rng = np.random.default_rng(23)
    return [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32) for n in PROMPT_LENS]


def _engine(arch, devices, pool_pages, **kw):
    _, tc, _, tparams = _pair(arch)
    return tc, PagedServeEngine.from_config(tc, params=tparams, devices=devices,
                                            max_seq_len=MAX_SEQ, pool_pages=pool_pages, **kw)


def _serve(eng, cfg):
    futs = [eng.submit(p, MAX_NEW) for p in _prompts(cfg)]
    got = [list(np.asarray(f.get(timeout=300))) for f in futs]
    eng.drain()
    return got, eng.metrics()


@pytest.mark.parametrize("arch", ["olmo-1b", "mamba2-130m"])
def test_torch_paged_fleet_greedy_tokens_under_page_pressure(fleet, arch):
    """2 logical devices, pools of 3 allocatable pages (a prompt of 17-32
    tokens asks for 3 at admission): the first admissions wait out the
    decode lanes' arrival window, so later ones spill, their lanes defer
    and refetch.  Tokens equal the JAX padded oracle's."""
    devs = fleet[:2]
    cfg, eng = _engine(arch, devs, 4, decode=LanePolicy(max_batch=64, max_delay_s=0.5),
                       scheduler=Scheduler(devs, policy="least_loaded"), name=f"t-fleet-{arch}")
    # the device's least-recently-used buffer, but not the pool's: spilling
    # it would give an admission no page
    bystander = devs[0].create_buffer(1 << 16, np.float32).get()
    bystander._last_use = -1e9
    try:
        got, m = _serve(eng, cfg)
    finally:
        eng.close()
    assert agas.registry.placement(bystander.gid).device_key == devs[0].key
    jax_want, port_want = _oracles(arch)
    assert got == jax_want == port_want
    assert m["requests_completed"] == len(PROMPT_LENS) and m["requests_failed"] == 0
    assert m["spills"] >= 1 and m["refetches"] >= 1, m["kv"]
    assert set(m["placed"]) == {d.key for d in devs} and sum(m["placed"].values()) == 6
    assert set(m["decode_by_device"]) == {d.key for d in devs}
    assert all(p["used_pages"] == 0 for p in m["kv"].values())
    assert m["decode_rows"] == len(PROMPT_LENS) * (MAX_NEW - 1)


def test_torch_paged_engine_exact_tokens_under_spill_pressure(fleet):
    """A concurrent spiller hammers every sequence while two lanes decode
    (the regime where an unpinned sequence's pages could be freed and
    re-owned mid-step): every token is still the oracle's."""
    devs = fleet[:2]
    cfg, eng = _engine("olmo-1b", devs, 16, scheduler=Scheduler(devs), name="t-spillrace")
    kv = eng.kv
    stop = threading.Event()

    def spiller():
        while not stop.is_set():
            with kv._seq_lock:
                seqs = list(kv._seqs.values())
            for s in seqs:
                try:
                    s.spill().get(timeout=30)
                except (KeyError, ValueError):  # freed mid-flight
                    pass
            time.sleep(0.001)

    th = threading.Thread(target=spiller, daemon=True)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    th.start()
    try:
        got, m = _serve(eng, cfg)
    finally:
        sys.setswitchinterval(old)
        stop.set()
        th.join(timeout=30)
        eng.close()
    assert not th.is_alive()
    assert got == _oracles("olmo-1b")[0]
    assert m["spills"] >= 1 and m["refetches"] >= 1
    assert all(p["used_pages"] == 0 for p in kv.stats().values())


class _DrainTo(PlacementPolicy):
    """Prefill places on the first device; a rebalancing check answers the
    second, so every checked lane migrates its coldest sequence there."""

    name = "drain-to"

    def select(self, devices, args=(), program=None):
        return devices[0]

    def select_batch(self, devices, batch_args=(), program=None):
        return devices[-1]


@pytest.mark.parametrize("arch", ["olmo-1b", "mamba2-130m"])
def test_torch_paged_fleet_migration_keeps_tokens(fleet, arch):
    """Rebalancing under page pressure (pool 0 under 20% free) migrates
    sequences, pages and state, to the other lane mid-decode; the tokens
    are the oracle's and the migrations are counted."""
    devs = fleet[:2]
    cfg, eng = _engine(arch, devs, 12, rebalance_every=1,
                       decode=LanePolicy(max_batch=64, max_delay_s=0.3),
                       scheduler=Scheduler(devs, policy=_DrainTo()), name=f"t-migrate-{arch}")
    try:
        got, m = _serve(eng, cfg)
    finally:
        eng.close()
    assert got == _oracles(arch)[0]
    assert m["migrations"] >= 1
    assert m["decode_by_device"][devs[0].key]["migrations_out"] == m["migrations"]
    assert m["placed"] == {devs[0].key: len(PROMPT_LENS)}
    assert all(p["used_pages"] == 0 for p in m["kv"].values())


def test_torch_paged_fleet_spreads_over_four_devices(fleet):
    """16 requests over 4 logical devices: placements spread over the
    fleet, padding only for warm-shape reuse, every token the oracle's."""
    devs = fleet[:4]
    cfg, eng = _engine("olmo-1b", devs, 64, scheduler=Scheduler(devs, policy="least_loaded"),
                       name="t-spread")
    prompts = _prompts(cfg)
    try:
        futs = [eng.submit(prompts[i % len(prompts)], MAX_NEW) for i in range(16)]
        got = [list(np.asarray(f.get(timeout=300))) for f in futs]
        eng.drain()
        m = eng.metrics()
    finally:
        eng.close()
    want = _oracles("olmo-1b")[0]
    assert got == [want[i % len(prompts)] for i in range(16)]
    assert m["padding_waste"] <= 0.5
    assert len([k for k, v in m["placements"].items() if v > 0]) >= 2, m["placements"]


def test_torch_prefill_partial_failure_fails_only_unadmitted():
    """A mid-group prefill failure fails only the requests prefill still
    owns: admitted members finish, the lanes survive, drain() returns, no
    page leaks."""
    device = get_all_devices(platform="cpu").get()[0]
    cfg, eng = _engine("olmo-1b", [device], 64,
                       prefill=LanePolicy(max_batch=8, max_delay_s=0.25, token_budget=4096),
                       name="t-partial")
    orig = eng._pool_with_room
    calls = {"n": 0}

    def flaky(dev, need_pages):
        calls["n"] += 1
        if calls["n"] == 3:
            raise OutOfPages("injected mid-group failure")
        return orig(dev, need_pages)

    eng._pool_with_room = flaky
    prompt = _prompts(cfg)[0]
    want = _oracles("olmo-1b")[0][0]
    try:
        futs = [eng.submit(prompt, MAX_NEW) for _ in range(4)]  # one prefill group
        for i in (0, 1):  # admitted before the failure: complete exactly
            assert list(np.asarray(futs[i].get(timeout=120))) == want
        for i in (2, 3):  # owned by prefill at the failure: fail cleanly
            with pytest.raises(OutOfPages, match="injected"):
                futs[i].get(timeout=120)
        eng.drain()
        eng._pool_with_room = orig
        assert list(np.asarray(eng.submit(prompt, MAX_NEW).get(timeout=120))) == want
        m = eng.metrics()
    finally:
        eng.close()
    assert m["requests_failed"] == 2 and m["requests_completed"] == 3
    assert eng.kv.pool_of(device).used_pages == 0


def test_torch_lane_policy_explicit_zero_not_treated_as_unset():
    """``token_budget=0`` and ``max_delay_s=0.0`` are real bounds (one row a
    prefill batch, dispatch at once), not "take the default"."""
    device = get_all_devices(platform="cpu").get()[0]
    cfg, eng = _engine("olmo-1b", [device], 64,
                       prefill=LanePolicy(max_batch=8, max_delay_s=0.05, token_budget=0),
                       decode=LanePolicy(max_batch=64, max_delay_s=0.0), name="t-zero")
    prompt = _prompts(cfg)[0]
    try:
        futs = [eng.submit(prompt, MAX_NEW) for _ in range(3)]
        got = [list(np.asarray(f.get(timeout=120))) for f in futs]
        m = eng.metrics()
    finally:
        eng.close()
    assert got == [_oracles("olmo-1b")[0][0]] * 3
    assert m["prefill_batches"] == 3


# ---------------------------------------------------------------------------
# chip_smoke's fleet phases, rehearsed on the CPU at a small size
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_fleet", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _collect_failures(smoke, monkeypatch):
    failed = []
    monkeypatch.setattr(smoke, "require", lambda ok, msg: ok or failed.append(msg))
    return failed


def test_torch_smoke_fleet_phase_rehearsed_on_cpu(smoke, monkeypatch):
    """``chip_smoke.phase_fleet`` over 4 logical CPU devices on 2**16 f32:
    every policy's outputs bit-equal to one device's, the memory-limit run
    spills and refetches; only the launch count fails (CPU tensors take the
    plain version)."""
    failed = _collect_failures(smoke, monkeypatch)
    devs = smoke.logical_devices(4, platform="cpu")
    try:
        assert [d.key for d in devs] == ["cpu:0", "cpu:0.1", "cpu:0.2", "cpu:0.3"]
        out = smoke.phase_fleet(devs, torch.randn(1 << 16, generator=torch.Generator().manual_seed(0)))
    finally:
        reset_runtime()
    assert len(failed) == 1 and "launched 0 times" in failed[0], failed
    runs = out["runs"]
    assert list(runs) == ["default", "one_device", *smoke.FLEET_POLICIES, "memory_limit"]
    assert all(sum(r["placed"].values()) == smoke.FLEET_CHUNKS for r in runs.values())
    assert runs["one_device"]["placed"] == {"cpu:0": smoke.FLEET_CHUNKS}
    assert runs["static"]["placed"] == {"cpu:0": smoke.FLEET_CHUNKS}
    assert runs["affinity"]["placed"] == {d.key: 4 for d in devs}  # each chunk where it lives
    assert runs["memory_limit"]["spills"] >= 1 and runs["memory_limit"]["refetches"] >= 1
    assert all(d.memory_limit == 0 for d in devs)


def test_torch_smoke_serve_paged_fleet_phase_rehearsed_on_cpu(smoke, monkeypatch):
    """``chip_smoke.phase_serve_paged_fleet`` on 2 logical CPU devices with
    the olmo smoke config: 8 requests whose pages exceed the fleet's, tokens
    equal to the serve flow's plain run, spills and refetches; only the
    launch checks fail."""
    from repro_torch import configs as tcfg
    from repro_torch.models import get_model

    monkeypatch.setattr(smoke, "get_config", lambda name: tcfg.smoke(tcfg.get_config(name)))
    monkeypatch.setattr(smoke, "SERVE_BATCH", 4)
    monkeypatch.setattr(smoke, "SERVE_PROMPTS", (12, 40))
    monkeypatch.setattr(smoke, "SERVE_NEW", 4)
    monkeypatch.setattr(smoke, "PAGED_WARMUP", 4)
    monkeypatch.setattr(smoke, "PAGED_FLEET_POOL", 6)  # 5 pages a pool; 16 needed
    failed = _collect_failures(smoke, monkeypatch)
    cfg = tcfg.smoke(tcfg.get_config("olmo-1b"))
    devs = smoke.logical_devices(2, platform="cpu")
    try:
        params = get_model(cfg).init(cfg, generator=torch.Generator().manual_seed(0),
                                     device="cpu")
        rng = np.random.default_rng(0)
        groups = [rng.integers(0, cfg.vocab_size, size=(4, s), dtype=np.int32) for s in (12, 40)]
        plain = smoke.serve_flow(devs[0], cfg, params, groups,
                                 [devs[0].create_stream() for _ in groups], 4, impl="ref")
        out = smoke.phase_serve_paged_fleet(devs, {
            "tokens": np.concatenate([g["tokens"] for g in plain]),
            "gaps": np.concatenate([g["gaps"] for g in plain])})
    finally:
        reset_runtime()
    assert len(failed) == 2 and all("launched" in m for m in failed), failed
    assert out["requests"] == 8 and out["spills"] >= 1 and out["refetches"] >= 1
    assert out["near_tie_cuts_vs_serve_plain"] <= 8
    assert sum(d["placed"] for d in out["per_device"].values()) == 8
    assert set(out["per_device"]) == {"cpu:0", "cpu:0.1"}
