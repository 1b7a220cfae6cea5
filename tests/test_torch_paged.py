"""The port's page pool, paged KV cache, sampling and engine admission,
held against the JAX package's ``repro.serving.paged`` on the CPU.

The same operations on both caches give the same page tables; ``PageSpec``
gives the same bytes and page counts; ``sample_token`` (numpy f64, a PRNG
keyed by ``[seed, request_id, position]``) gives the same tokens over a
sweep of logits and sampling knobs.  The port's own checks: page 0 is
never handed out, double frees and exhaustion raise, ``append`` zero-pads
a partial page on the device and refuses a start off a page boundary, the
AGAS record of a sequence carries its pages and state, and the engine
refuses what it cannot run (an unknown contract, a fleet across
localities).

The legacy two-callable contract serves the reference's toy model
(``tests/test_paged.py``'s ``_toy_paged_model``, ported with the same numpy
embedding and the port's plain paged attention): the reference's engine
tests aimed at the port, tokens bit-equal to the JAX engine's on the same
prompts.
"""
import os
import subprocess
import sys
import textwrap
import threading
import time
import types

import jax
import numpy as np
import pytest
import torch

from repro.core import get_all_devices as jax_get_all_devices
from repro.serving.paged import PagedKVCache as JaxPagedKVCache
from repro.serving.paged import PageSpec as JaxPageSpec
from repro.serving.paged import SamplingParams as JaxSamplingParams
from repro.serving.paged import sample_token as jax_sample_token
from repro.core import Scheduler as JaxScheduler
from repro.serving.paged import PagedServeEngine as JaxPagedServeEngine
from repro_torch.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.serving import LanePolicy
from test_paged import _toy_paged_model as jax_toy_paged_model
from repro_torch.core import Scheduler, agas, get_all_devices
from repro_torch.serving import (
    EngineClosed,
    OutOfPages,
    PagedKVCache,
    PagedServeEngine,
    PageSpec,
    QueueFull,
    SamplingParams,
    sample_token,
    warm_rows,
)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.fixture(scope="module")
def device():
    return get_all_devices(platform="cpu").get()[0]


@pytest.fixture(scope="module")
def jax_device():
    return jax_get_all_devices(1, 0).get()[0]


def _fill(spec, seq_id, tokens):
    """Token t of sequence s holds s * 1000 + t (k) and its negation (v)."""
    base = np.arange(tokens, dtype=np.float32) + seq_id * 1000.0
    k = np.broadcast_to(base[None, :, None, None],
                        (spec.layers, tokens, spec.kv_heads, spec.head_dim)).copy()
    return k, -k


@pytest.mark.parametrize("geom", [(1, 2, 1, 2), (16, 16, 16, 128), (24, 0, 1, 1), (3, 5, 4, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_page_spec_matches_jax(geom, dtype):
    jdt = np.float32 if dtype == "float32" else jax.numpy.bfloat16
    spec = PageSpec(*geom, dtype=getattr(torch, dtype))
    jspec = JaxPageSpec(*geom, dtype=jdt)
    assert spec.page_size == jspec.page_size and spec.page_bytes == jspec.page_bytes
    for n in (0, 1, spec.page_size - 1, spec.page_size, spec.page_size + 1, 1000, 2000):
        assert spec.pages_for(n) == jspec.pages_for(n)
    assert PageSpec(*geom, dtype=np.float32).dtype == torch.float32  # numpy dtypes convert


def test_torch_pool_alloc_free_and_exhaustion(device):
    kv = PagedKVCache(PageSpec(1, 2, 1, 2), devices=[device], pool_pages=6)
    pool = kv.pool_of(device)
    assert pool.num_free == 5 and pool.used_pages == 0
    got = pool.alloc(5)
    assert sorted(got) == [1, 2, 3, 4, 5]  # page 0 is never handed out
    with pytest.raises(OutOfPages, match="need 1 page"):
        pool.alloc(1)
    pool.free(got[:2])
    with pytest.raises(ValueError, match="double free"):
        pool.free([got[0]])
    with pytest.raises(ValueError, match="not an allocatable page"):
        pool.free([0])
    assert pool.num_free == 2 and pool.used_pages == 3
    with pytest.raises(ValueError, match=">= 2 pages"):
        PagedKVCache(PageSpec(1, 2, 1, 2), devices=[device], pool_pages=1)
    with pytest.raises(KeyError, match="no page pool"):
        kv.new_seq(types.SimpleNamespace(key="cuda:7"))


def test_torch_append_zero_pads_and_refuses_off_boundary(device):
    spec = PageSpec(2, 4, 1, 2)
    kv = PagedKVCache(spec, devices=[device], pool_pages=8)
    pool = kv.pool_of(device)
    ks, vs = pool.arrays()
    ks.fill_(7.0)  # stale contents a zero-pad must overwrite
    vs.fill_(7.0)
    seq = kv.new_seq(device)
    k, v = _fill(spec, 1, 6)
    kv.append(seq, torch.from_numpy(k), torch.from_numpy(v))
    assert seq.length == 6 and len(seq.pages) == 2
    ks, vs = pool.arrays()
    flat_k = ks[:, seq.pages].reshape(2, 8, 1, 2)
    flat_v = vs[:, seq.pages].reshape(2, 8, 1, 2)
    np.testing.assert_array_equal(flat_k[:, :6].numpy(), k)
    np.testing.assert_array_equal(flat_v[:, :6].numpy(), v)
    assert (flat_k[:, 6:] == 0).all() and (flat_v[:, 6:] == 0).all()  # the tail is zero-padded
    assert (ks[:, 0] == 7).all()  # page 0 untouched
    with pytest.raises(ValueError, match="page boundary"):
        kv.append(seq, torch.from_numpy(k[:, :1]), torch.from_numpy(v[:, :1]))
    kv.ensure_slot(seq)  # 6 < 8: no new page
    assert len(seq.pages) == 2
    kv.note_decoded(seq), kv.note_decoded(seq)
    kv.ensure_slot(seq)  # length 8 on a boundary: one more page
    assert len(seq.pages) == 3 and seq.length == 8


def test_torch_table_matches_jax_cache_after_same_operations(device, jax_device):
    spec, jspec = PageSpec(1, 4, 1, 2), JaxPageSpec(1, 4, 1, 2)
    kv = PagedKVCache(spec, devices=[device], pool_pages=32)
    jkv = JaxPagedKVCache(jspec, devices=[jax_device], pool_pages=32)
    seqs, jseqs = [], []
    for i, n in enumerate([5, 8, 13, 1]):
        k, v = _fill(spec, i, n)
        s, js = kv.new_seq(device), jkv.new_seq(jax_device)
        kv.append(s, torch.from_numpy(k), torch.from_numpy(v))
        jkv.append(js, k, v)
        seqs.append(s), jseqs.append(js)
    for _ in range(4):  # decode tokens: tails grow page by page
        for s, js in zip(seqs, jseqs):
            kv.ensure_slot(s), jkv.ensure_slot(js)
            kv.note_decoded(s), jkv.note_decoded(js)
    kv.free_seq(seqs[1]), jkv.free_seq(jseqs[1])
    k, v = _fill(spec, 9, 11)
    s, js = kv.new_seq(device), jkv.new_seq(jax_device)  # reuses the freed pages
    kv.append(s, torch.from_numpy(k), torch.from_numpy(v))
    jkv.append(js, k, v)
    live, jlive = [seqs[0], seqs[2], seqs[3], s], [jseqs[0], jseqs[2], jseqs[3], js]
    tbl, lens = kv.table(live, 8)
    jtbl, jlens = jkv.table(jlive, 8)
    np.testing.assert_array_equal(tbl, jtbl)
    np.testing.assert_array_equal(lens, jlens)
    assert tbl.dtype == np.int32 and lens.dtype == np.int32
    with pytest.raises(ValueError, match="table width"):
        kv.table(live, 2)
    stats = kv.stats()[device.key]
    assert stats["used_pages"] == sum(len(x.pages) for x in live)


def test_torch_seq_agas_nbytes_counts_pages_and_state(device):
    spec = PageSpec(2, 4, 1, 2)
    kv = PagedKVCache(spec, devices=[device], pool_pages=16)
    pool = kv.pool_of(device)
    for slab in (pool.k_slab, pool.v_slab):  # capacity is not pressure
        rec = agas.registry._records[slab.gid]
        assert rec.kind == "pool" and rec.meta["nbytes"] == 0
    seq = kv.new_seq(device)
    k, v = _fill(spec, 0, 9)
    kv.append(seq, torch.from_numpy(k), torch.from_numpy(v))
    rec = agas.registry._records[seq.gid]
    assert rec.kind == "buffer" and rec.meta["nbytes"] == 3 * spec.page_bytes == seq.nbytes
    seq.set_state({"state": torch.zeros(2, 3, dtype=torch.float32),
                   "conv": torch.zeros(5, dtype=torch.bfloat16)})
    assert agas.registry._records[seq.gid].meta["nbytes"] == 3 * spec.page_bytes + 24 + 10
    gid = seq.gid
    kv.free_seq(seq)
    assert gid not in agas.registry._records and pool.used_pages == 0


@pytest.mark.parametrize("temperature", [0.0, 0.7, 1.3])
@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (5, 1.0), (0, 0.9), (40, 0.5)])
def test_torch_sample_token_matches_jax(temperature, top_k, top_p):
    rng = np.random.default_rng(int(temperature * 10) + top_k)
    for trial in range(8):
        logits = rng.normal(size=(97,)).astype(np.float32) * 3
        for rid, pos in ((0, 0), (3, 7), (11, 1)):
            sp = SamplingParams(temperature, top_k, top_p, seed=trial)
            jsp = JaxSamplingParams(temperature, top_k, top_p, seed=trial)
            got = sample_token(logits, sp, rid, pos)
            assert got == jax_sample_token(logits, jsp, rid, pos)
            assert got == sample_token(torch.from_numpy(logits), sp, rid, pos)
    assert sample_token(np.asarray([0.0, 2.0, 1.0]), None, 0, 0) == 1  # greedy


def _toy_engine(device, prefill_fn=None, **kw):
    spec = PageSpec(1, 4, 1, 4)
    kv = PagedKVCache(spec, devices=[device], pool_pages=16)

    def decode_fn(*args):
        raise AssertionError("no decode expected")

    return PagedServeEngine(kv, prefill_fn or (lambda t, e: None), decode_fn, max_seq_len=16,
                            name="t-guard", **kw)


@pytest.mark.parametrize("warm,rows,want", [
    (set(), 3, 3),          # nothing warm: exact
    ({4}, 3, 4),            # the nearest warm count above
    ({4, 8}, 5, 8),         # 3 pad rows for 5 real ones
    ({8}, 4, 8),            # exactly 2x: taken
    ({8}, 3, 3),            # over 2x: exact instead
    ({2, 8}, 1, 2),
    ({1, 3, 6}, 7, 7),      # a new high-water mark
    ({6}, 6, 6),
])
def test_torch_warm_rows_rule(warm, rows, want):
    assert warm_rows(rows, warm) == want


def test_torch_engine_submit_refusals(device):
    gate = threading.Event()

    def blocked_prefill(tokens, extras):
        gate.wait(timeout=30)
        raise RuntimeError("released")

    eng = _toy_engine(device, blocked_prefill, max_queue=1)
    try:
        with pytest.raises(ValueError, match="empty prompt"):
            eng.submit(np.zeros((0,), np.int32), 4)
        with pytest.raises(ValueError, match="max_seq_len"):
            eng.submit(np.ones((12,), np.int32), 8)
        first = eng.submit(np.ones((4,), np.int32), 2)
        deadline = time.monotonic() + 10
        while eng._queue and time.monotonic() < deadline:  # the prefill lane holds it
            time.sleep(0.005)
        second = eng.submit(np.ones((4,), np.int32), 2)  # queued behind it
        with pytest.raises(QueueFull, match="admission queue is full"):
            eng.submit(np.ones((4,), np.int32), 2)
        gate.set()
        for fut in (first, second):
            with pytest.raises(RuntimeError, match="released"):
                fut.get(timeout=30)
        eng.drain()
        assert eng.metrics()["requests_failed"] == 2
    finally:
        gate.set()
        eng.close()
    with pytest.raises(EngineClosed):
        eng.submit(np.ones((4,), np.int32), 2)


def test_torch_engine_refuses_what_is_not_ported(device):
    with pytest.raises(ValueError, match="contract must be 'legacy' or 'zoo'"):
        _toy_engine(device, contract="fig9")
    # A fleet across localities (a device keyed in locality 1): an engine
    # serves one locality's devices, as the reference's; decode elsewhere
    # goes through export_seq and a paged_worker_decode parcel.
    remote = types.SimpleNamespace(key="L1/cpu:0")
    with pytest.raises(NotImplementedError, match="paged_worker_decode"):
        _toy_engine(device, scheduler=Scheduler([device, remote]))
    assert all(callable(getattr(PagedKVCache, n, None)) for n in ("export_seq", "import_seq"))


def test_torch_paged_modules_import_without_jax():
    code = textwrap.dedent(
        """
        import sys
        sys.modules["jax"] = None  # any import of jax now raises
        import repro_torch.serving, repro_torch.serving.paged, repro_torch.serving.engine
        import repro_torch.kernels.paged_attention.ops, repro_torch.kernels.paged_attention.kernel
        import repro_torch.launch.mesh, repro_torch.distribution.sharding
        from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
        from repro_torch.distribution.sharding import constrain, spec_for, tree_sharding
        from repro_torch.serving.paged import (paged_worker_decode, paged_worker_reset,
                                               paged_worker_stats)
        from repro_torch.models import input_specs
        from repro_torch.models.model import paged_surface
        from repro_torch.configs import get_config
        for arch in ("olmo-1b", "mamba2-130m"):
            paged_surface(get_config(arch))[0](get_config(arch))
        assert not any(m == "repro" or m.startswith("repro.") for m in sys.modules), "imports repro"
        print("ok")
        """
    )
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_torch_engine_stress_many_submitters(device):
    """Prefill lane, decode lane and four submitter threads at once, with a
    short switch interval: every request gets its own tokens back (the
    decode attends over pages only that sequence wrote), every page comes
    back, every count adds up."""
    from repro_torch.models import layers

    V = 64

    def prefill_fn(tokens, extras):  # v of every token = the prompt's first token
        B, T = tokens.shape
        v = tokens[:, :1].float()[:, None, :, None, None].expand(B, 1, T, 1, 4).contiguous()
        return torch.zeros_like(v), v, None, torch.nn.functional.one_hot(tokens[:, 0].long(), V).float()

    def decode_fn(ks, vs, state, tokens, positions, tables, lengths):
        B = tokens.shape[0]
        c = tokens.float()[:, None, None, None].expand(B, 1, 1, 4)
        kp, vp = layers.page_scatter(ks[0], vs[0], torch.zeros_like(c), c, tables, positions)
        o = layers.paged_decode_attend(torch.zeros(B, 1, 1, 4), kp, vp, tables, lengths)
        return ks, vs, state, torch.nn.functional.one_hot(o[:, 0, 0, 0].round().long(), V).float()

    kv = PagedKVCache(PageSpec(1, 4, 1, 4), devices=[device], pool_pages=512)
    eng = PagedServeEngine(kv, prefill_fn, decode_fn, max_seq_len=32, name="t-stress")
    rng = np.random.default_rng(0)
    jobs = [(int(rng.integers(1, V)), int(rng.integers(1, 20)), int(rng.integers(1, 8)))
            for _ in range(48)]  # (token, prompt length, tokens to generate)
    futs = [None] * len(jobs)

    def submitter(k):
        for i in range(k, len(jobs), 4):
            c, n, new = jobs[i]
            futs[i] = eng.submit(np.full(n, c, np.int32), new)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=submitter, args=(k,)) for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        got = [list(f.get(timeout=120)) for f in futs]
        eng.drain()
        m = eng.metrics()
    finally:
        sys.setswitchinterval(old)
        eng.close()
    assert got == [[c] * new for c, _, new in jobs]
    assert m["requests_completed"] == len(jobs) and m["requests_failed"] == 0
    assert m["decode_rows"] == sum(new - 1 for _, _, new in jobs)
    assert kv.pool_of(device).used_pages == 0 and not kv._seqs


# ---------------------------------------------------------------------------
# the legacy two-callable contract on the reference's toy model
# ---------------------------------------------------------------------------

def _toy_paged_model(V=64, K=1, D=4, P=4):
    """``tests/test_paged.py``'s toy model on the port: next token = (last +
    1) % V, with the KV pools and the port's plain paged attention exercised
    for real (a masking or table fault makes the attention non-finite,
    which moves the token by 2**20).  The decode writes the pools in place
    and returns them."""
    emb = torch.from_numpy(np.random.default_rng(0).normal(size=(V, K, D)).astype(np.float32))

    def prefill_fn(tokens):
        e = emb.to(tokens.device)[tokens.long()]  # (B, T, K, D)
        return e[:, None], e[:, None], (tokens[:, -1] + 1) % V

    def decode_fn(kp, vp, tokens, positions, tables, lengths):
        e = emb.to(tokens.device)[tokens.long()]
        b = tokens.shape[0]
        page = tables[torch.arange(b, device=tokens.device), (positions // P).long()].long()
        slot = (positions % P).long()
        kp[0, page, slot] = e
        vp[0, page, slot] = e
        o = paged_attention_ref(e.reshape(b, K, D), kp[0], vp[0], tables, lengths + 1)
        guard = torch.where(torch.isfinite(o.sum(dim=(1, 2))), 0, 1 << 20).to(torch.int32)
        return kp, vp, (tokens + 1) % V + guard

    return prefill_fn, decode_fn


def _legacy_engine(device, V=64, P=4, pool_pages=64, model=None, **kw):
    prefill_fn, decode_fn = model or _toy_paged_model(V=V, P=P)
    kv = PagedKVCache(PageSpec(1, P, 1, 4), devices=[device], pool_pages=pool_pages)
    return PagedServeEngine(kv, prefill_fn, decode_fn, max_seq_len=32,
                            scheduler=Scheduler([device]), contract="legacy", **kw)


def _mixed_prompts(V, n, seed, most):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, V - 16, size=int(rng.integers(1, most))).astype(np.int32)
            for _ in range(n)]


def test_torch_legacy_engine_serves_mixed_lengths_with_zero_padding(device, jax_device):
    """The reference's test on the port, with the JAX engine serving the
    same prompts through the reference's toy model: tokens bit-equal."""
    V = 64
    prompts = _mixed_prompts(V, 9, 3, 10)  # mixed lengths share decode steps
    eng = _legacy_engine(device, V=V, name="t-legacy")
    assert eng.contract == "legacy"
    try:
        got = [list(f.get(timeout=120)) for f in [eng.submit(p, max_new_tokens=5)
                                                  for p in prompts]]
        m = eng.metrics()
    finally:
        eng.close()
    jkv = JaxPagedKVCache(JaxPageSpec(1, 4, 1, 4), devices=[jax_device], pool_pages=64)
    jeng = JaxPagedServeEngine(jkv, *jax_toy_paged_model(V=V, P=4), max_seq_len=32,
                               scheduler=JaxScheduler([jax_device]), name="t-legacy-jax")
    try:
        want = [list(f.get(timeout=120)) for f in [jeng.submit(p, max_new_tokens=5)
                                                   for p in prompts]]
    finally:
        jeng.close()
    assert got == want
    assert got == [[(int(p[-1]) + 1 + j) % V for j in range(5)] for p in prompts]
    assert m["requests_completed"] == 9
    # rows pad only when a shrinking tail reuses a warm row count, at most 2x
    assert m["padding_waste"] <= 0.5
    assert m["decode_steps"] < 9 * 4 + 5  # mixed lengths shared steps
    assert eng.kv.pools[device.key].used_pages == 0  # every page back


def test_torch_legacy_engine_admission_guards(device):
    eng = _legacy_engine(device, pool_pages=16, name="t-legacy-guard")
    try:
        with pytest.raises(ValueError, match="empty prompt"):
            eng.submit(np.zeros((0,), np.int32), 4)
        with pytest.raises(ValueError, match="max_seq_len"):
            eng.submit(np.ones((30,), np.int32), 8)
    finally:
        eng.close()


def test_torch_legacy_engine_exact_tokens_under_spill_pressure(device):
    """A concurrent spiller hammers the sequences a decode lane steps:
    every token stays exact and every page comes back."""
    V = 64
    eng = _legacy_engine(device, V=V, name="t-legacy-spillrace")
    kv = eng.kv
    stop = threading.Event()

    def spiller():
        while not stop.is_set():
            with kv._seq_lock:
                seqs = list(kv._seqs.values())
            for s in seqs:
                try:
                    s.spill().get(timeout=30)
                except Exception:  # noqa: BLE001 - freed mid-flight is fine
                    pass
            time.sleep(0.001)

    th = threading.Thread(target=spiller, daemon=True)
    th.start()
    prompts = _mixed_prompts(V, 8, 7, 9)
    try:
        futs = [eng.submit(p, max_new_tokens=6) for p in prompts]
        for p, f in zip(prompts, futs):
            assert list(f.get(timeout=120)) == [(int(p[-1]) + 1 + j) % V for j in range(6)]
    finally:
        stop.set()
        th.join(timeout=30)
        eng.close()
    assert kv.pools[device.key].used_pages == 0


def test_torch_legacy_prefill_partial_failure_fails_only_unadmitted(device):
    """A mid-group prefill failure fails only the requests prefill still
    owns: admitted members finish exactly, the lanes survive, drain()
    returns, no page leaks."""
    V = 64
    eng = _legacy_engine(device, V=V, name="t-legacy-partial",
                         prefill=LanePolicy(max_batch=8, max_delay_s=0.25, token_budget=4096))
    orig = eng._pool_with_room
    calls = {"n": 0}

    def flaky(dev, need_pages):
        calls["n"] += 1
        if calls["n"] == 3:
            raise OutOfPages("injected mid-group failure")
        return orig(dev, need_pages)

    eng._pool_with_room = flaky
    try:
        prompts = [np.arange(4, dtype=np.int32) + i for i in range(4)]
        futs = [eng.submit(p, max_new_tokens=4) for p in prompts]
        for i in (0, 1):  # admitted before the failure: complete exactly
            assert list(futs[i].get(timeout=120)) == [(int(prompts[i][-1]) + 1 + j) % V
                                                      for j in range(4)]
        for i in (2, 3):  # owned by prefill at the failure: fail cleanly
            with pytest.raises(OutOfPages, match="injected"):
                futs[i].get(timeout=120)
        eng.drain()
        eng._pool_with_room = orig
        out = eng.submit(np.arange(4, dtype=np.int32), 3).get(timeout=120)
        assert list(out) == [(3 + 1 + j) % V for j in range(3)]
        m = eng.metrics()
    finally:
        eng.close()
    assert m["requests_failed"] == 2 and m["requests_completed"] == 3
    assert eng.kv.pools[device.key].used_pages == 0


def test_torch_legacy_lane_policy_explicit_zero_not_treated_as_unset(device):
    """``token_budget=0`` floors at one row a prefill batch and
    ``max_delay_s=0.0`` dispatches at once: real bounds, not unset."""
    V = 64
    eng = _legacy_engine(device, V=V, name="t-legacy-zero",
                         prefill=LanePolicy(max_batch=8, max_delay_s=0.05, token_budget=0),
                         decode=LanePolicy(max_batch=64, max_delay_s=0.0))
    try:
        prompts = [np.arange(4, dtype=np.int32) for _ in range(3)]
        futs = [eng.submit(p, 3) for p in prompts]
        for p, f in zip(prompts, futs):
            assert list(f.get(timeout=120)) == [(int(p[-1]) + 1 + j) % V for j in range(3)]
        m = eng.metrics()
    finally:
        eng.close()
    assert m["prefill_batches"] == 3


def test_torch_legacy_new_slabs_are_copied_into_the_pool(device):
    """A legacy ``decode_fn`` that returns new slab tensors (the reference's
    functional update) has them copied into the pool's own slabs, which stay
    the same tensors: the tokens are the in-place model's."""
    V = 64
    prefill_fn, inplace = _toy_paged_model(V=V)

    def functional(kp, vp, *args):
        k2, v2, nxt = inplace(kp.clone(), vp.clone(), *args)
        return k2, v2, nxt

    eng = _legacy_engine(device, V=V, model=(prefill_fn, functional), name="t-legacy-copy")
    ks, vs = eng.kv.pool_of(device).arrays()
    prompts = _mixed_prompts(V, 5, 11, 9)
    try:
        got = [list(f.get(timeout=120)) for f in [eng.submit(p, 6) for p in prompts]]
    finally:
        eng.close()
    assert got == [[(int(p[-1]) + 1 + j) % V for j in range(6)] for p in prompts]
    assert eng.kv.pool_of(device).arrays()[0] is ks and eng.kv.pool_of(device).arrays()[1] is vs
