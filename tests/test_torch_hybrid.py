"""The port's hybrid family (``models/hybrid.py``) and its sliding-window
helpers, held against the JAX package on the CPU.

The reference's ``smoke(hymba-1.5b)`` has 2 layers with ``global_attn_layers
= (0,)``, so no layer consumes shared K/V.  The tests here also take a deeper
smoke, ``DEEP``: 6 layers with global layers 0 and 5, so producers 0, 1, 2,
4, 5 and consumer 3, with the smoke's 4 meta tokens and window 16.  Prompts
are longer than the window and not whole windows (the pad path runs), and
decode runs past the window (the ring wraps).  The JAX params (``init(cfg,
jax.random.key(0))``) are carried across with ``params_from_numpy`` and both
packages run the same numpy-seeded inputs in f32, held within 1e-4 (the
tolerance of ``tests/test_torch_zoo.py``), and greedy tokens bit for bit.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfg
from repro.models import layers as jax_layers
from repro.models import transformer as jax_transformer
from repro.models.model import get_model as jax_get_model
from repro.serving.paged import PagedServeEngine as JaxPagedServeEngine
from repro_torch import configs as tcfg
from repro_torch.core import get_all_devices
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.models import hybrid, layers
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import PagedServeEngine

TOL = dict(rtol=1e-4, atol=1e-4)
DEEP = dict(num_layers=6, global_attn_layers=(0, 5))
PAGE, MAX_PAGES = 16, 3
MAX_SEQ = PAGE * MAX_PAGES  # the oracle's cache width == the engine's table width * P
PROMPT_LENS = (5, 14, 17)  # + 4 meta: 9, 18 and 21 tokens, two past the window of 16
MAX_NEW = 8  # the longest reaches 28 tokens: its ring wraps


@functools.lru_cache(maxsize=None)
def _pair(deep: bool):
    jc = jcfg.smoke(jcfg.get_config("hymba-1.5b"))
    tc = tcfg.smoke(tcfg.get_config("hymba-1.5b"))
    if deep:
        jc, tc = dataclasses.replace(jc, **DEEP), dataclasses.replace(tc, **DEEP)
    jparams = jax_get_model(jc).init(jc, jax.random.key(0))
    tparams = params_from_numpy(tc, jax.tree.map(np.asarray, jparams), device="cpu")
    return jc, tc, jparams, tparams


def _rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **(tol or TOL))


# ---------------------------------------------------------------------------
# the window helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S,window", [(32, 16), (48, 8), (16, 16)])
def test_torch_local_block_attention_matches_jax(S, window):
    rng = np.random.default_rng(1)
    q, k, v = _rand(rng, 2, S, 4, 8), _rand(rng, 2, S, 2, 8), _rand(rng, 2, S, 2, 8)
    want = jax_layers.local_block_attention(*map(jnp.asarray, (q, k, v)), window=window)
    _close(layers.local_block_attention(*map(torch.from_numpy, (q, k, v)), window=window), want)


def test_torch_local_block_attention_refuses_a_part_window():
    """The reference asserts a whole number of windows; the port raises."""
    q = torch.zeros(1, 20, 2, 8)
    with pytest.raises(ValueError, match="not a multiple of the window 16"):
        layers.local_block_attention(q, q, q, window=16)
    with pytest.raises(AssertionError):
        jax_layers.local_block_attention(*(jnp.zeros((1, 20, 2, 8)),) * 3, window=16)


@pytest.mark.parametrize("q_block", [None, 8])
@pytest.mark.parametrize("causal,q_offset", [(True, 0), (True, 5), (False, 0)])
def test_torch_windowed_attention_matches_jax(q_block, causal, q_offset):
    rng = np.random.default_rng(2)
    q, k, v = _rand(rng, 2, 24, 4, 8), _rand(rng, 2, 29, 2, 8), _rand(rng, 2, 29, 2, 8)
    want = jax_layers.attention(*map(jnp.asarray, (q, k, v)), causal=causal, window=6,
                                q_offset=q_offset, q_block=q_block)
    got = layers.attention(*map(torch.from_numpy, (q, k, v)), causal=causal, window=6,
                           q_offset=q_offset, q_block=q_block)
    _close(got, want)


@pytest.mark.parametrize("ring", [None, 8])
def test_torch_cache_update_and_decode_attend_match_jax(ring):
    """A ring (or full) cache written token by token past its length: the
    caches bit-equal, each step's windowed (or causal) attend within TOL."""
    rng = np.random.default_rng(3)
    cfg = tcfg.smoke(tcfg.get_config("hymba-1.5b"))
    width = ring or 20
    jk = jv = jnp.zeros((2, width, 2, 8), jnp.float32)
    tk, tv = torch.zeros(2, width, 2, 8), torch.zeros(2, width, 2, 8)
    for pos in range(20):
        kn, vn, q = _rand(rng, 2, 1, 2, 8), _rand(rng, 2, 1, 2, 8), _rand(rng, 2, 1, 4, 8)
        jk, jv = jax_layers.cache_update(jk, jv, jnp.asarray(kn), jnp.asarray(vn), pos, ring=ring)
        out = layers.cache_update(tk, tv, torch.from_numpy(kn), torch.from_numpy(vn), pos,
                                  ring=ring)
        assert out[0] is tk and out[1] is tv  # in place
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        want = jax_layers.decode_attend(cfg, jnp.asarray(q), jk, jv, pos, window=ring)
        _close(layers.decode_attend(cfg, torch.from_numpy(q), tk, tv, pos, window=ring), want)


def test_torch_ring_gather_and_paged_ring_attend_match_jax():
    """Rows before, at and past the ring's first wrap, a row at position 0
    (slots not written yet clamp to token 0), on a table of 4 pages of 4."""
    rng = np.random.default_rng(4)
    N, P, K, D, H, ring = 12, 4, 2, 8, 4, 6
    kp, vp = _rand(rng, N, P, K, D), _rand(rng, N, P, K, D)
    tbl = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 0], [3, 1, 0, 0]], np.int32)
    pos = np.asarray([13, 5, 6, 0], np.int32)
    q = _rand(rng, 4, 1, H, D)
    for pages in (kp, vp):
        want = jax_layers.ring_gather(jnp.asarray(pages), jnp.asarray(tbl), jnp.asarray(pos), ring)
        got = layers.ring_gather(*map(torch.from_numpy, (pages, tbl, pos)), ring)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jax_layers.paged_ring_attend(*map(jnp.asarray, (q, kp, vp, tbl, pos)), ring=ring)
    _close(layers.paged_ring_attend(*map(torch.from_numpy, (q, kp, vp, tbl, pos)), ring=ring),
           want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("S", [12, 32])
def test_torch_dense_sliding_window_forward_matches_jax(S):
    """``transformer.forward`` with a window: the windowed blocks past the
    window (32 tokens, 2 windows), full causal attention within it."""
    jc = dataclasses.replace(jcfg.smoke(jcfg.get_config("deepseek-67b")), sliding_window=16)
    tc = dataclasses.replace(tcfg.smoke(tcfg.get_config("deepseek-67b")), sliding_window=16)
    jparams = jax_get_model(jc).init(jc, jax.random.key(0))
    tparams = params_from_numpy(tc, jax.tree.map(np.asarray, jparams), device="cpu")
    toks = np.random.default_rng(5).integers(0, tc.vocab_size, size=(2, S), dtype=np.int32)
    jl, _, jkv = jax_transformer.forward(jc, jparams, {"tokens": jnp.asarray(toks)}, return_kv=True)
    tl, _, tkv = T.forward(tc, tparams, {"tokens": torch.from_numpy(toks)}, return_kv=True)
    _close(tl, jl)
    _close(tkv["k"], jkv["k"])
    if S > 16:  # not the full causal result: the window cut something
        full = T.forward(dataclasses.replace(tc, sliding_window=None), tparams,
                         {"tokens": torch.from_numpy(toks)})[0]
        assert not torch.allclose(full, tl, **TOL)
    with pytest.raises(ValueError, match="multiple of the window"):
        T.forward(tc, tparams, {"tokens": torch.zeros((2, 20), dtype=torch.int32)})


# ---------------------------------------------------------------------------
# the hybrid model against the reference
# ---------------------------------------------------------------------------


def test_torch_hybrid_layout_producers_and_convert():
    """Producers and consumers as the reference counts them (19 of 32 at full
    size), consumer layers without K/V projections in ``param_shapes``,
    ``init`` and the converted tree, and a wrong key refused."""
    full = tcfg.get_config("hymba-1.5b")
    from repro.models import hybrid as jax_hybrid

    assert hybrid.kv_producers(full) == jax_hybrid.kv_producers(jcfg.get_config("hymba-1.5b"))
    assert len(hybrid.kv_producers(full)) == 19
    jc, tc, jparams, tparams = _pair(True)
    assert hybrid.kv_producers(tc) == [0, 1, 2, 4, 5]
    shapes = hybrid.param_shapes(tc)
    for l, lp in enumerate(tparams["layers"]):
        has = ("wk" in lp["attn"], "wv" in lp["attn"], "wk" in shapes["layers"][l]["attn"])
        assert has == (l != 3,) * 3
    init = hybrid.init(tc, generator=torch.Generator().manual_seed(0), device="cpu")
    jleaves = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, jparams))
    tleaves = jax.tree_util.tree_leaves_with_path(layers.tree_map(lambda t: t.numpy(), init))
    assert [p for p, _ in jleaves] == [p for p, _ in tleaves]
    for (path, j), (_, t) in zip(jleaves, tleaves):
        assert j.shape == t.shape, path
    tree = jax.tree.map(np.asarray, jparams)
    bad = dict(tree, layers=list(tree["layers"]))
    bad["layers"][3] = dict(bad["layers"][3], attn=dict(bad["layers"][3]["attn"],
                                                        wk=tree["layers"][2]["attn"]["wk"]))
    with pytest.raises(KeyError, match=r"params\['layers'\]\[3\]\['attn'\]: expected keys"):
        params_from_numpy(tc, bad, device="cpu")


@pytest.mark.parametrize("deep", [False, True])
@pytest.mark.parametrize("S", [9, 29])
def test_torch_hybrid_forward_matches_jax(deep, S):
    """Logits and every producer's K/V (meta included), with and without
    ``return_kv`` and ``last_only``; 29 + 4 meta tokens pad to 48."""
    jc, tc, jparams, tparams = _pair(deep)
    toks = np.random.default_rng(6).integers(0, tc.vocab_size, size=(2, S), dtype=np.int32)
    jl, _, jkv = jax_get_model(jc).forward(jc, jparams, {"tokens": jnp.asarray(toks)},
                                           return_kv=True)
    tl, aux, tkv = hybrid.forward(tc, tparams, {"tokens": torch.from_numpy(toks)}, return_kv=True)
    assert tl.shape == (2, S, tc.vocab_size) and float(aux) == 0.0
    _close(tl, jl)
    assert sorted(tkv) == sorted(jkv) == hybrid.kv_producers(tc)
    for l in jkv:
        _close(tkv[l][0], jkv[l][0])
        _close(tkv[l][1], jkv[l][1])
    last, _ = hybrid.forward(tc, tparams, {"tokens": torch.from_numpy(toks)}, last_only=True)
    jlast, _ = jax_get_model(jc).forward(jc, jparams, {"tokens": jnp.asarray(toks)},
                                         last_only=True)
    _close(last, jlast)
    torch.testing.assert_close(last, tl[:, -1:], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("deep", [False, True])
def test_torch_hybrid_decode_steps_match_jax(deep):
    """``decode_step`` over ring caches (ring 16) from position 0 through
    24 + 4 meta tokens: the ring wraps; every step's logits and the
    caches within TOL."""
    jc, tc, jparams, tparams = _pair(deep)
    toks = np.random.default_rng(7).integers(0, tc.vocab_size, size=(2, 24), dtype=np.int32)
    jcache = jax_get_model(jc).init_cache(jc, 2, 32, dtype=jnp.float32)
    tcache = hybrid.init_cache(tc, 2, 32, device="cpu", dtype=torch.float32)
    assert {n: tuple(t.shape) for n, t in tcache.items()} == {n: a.shape for n, a in jcache.items()}
    jstep = jax.jit(functools.partial(jax_get_model(jc).decode_step, jc, jparams))
    for pos in range(toks.shape[1]):
        tok = toks[:, pos:pos + 1]
        jl, jcache = jstep(jcache, jnp.asarray(tok), jnp.int32(pos))
        tl, tcache = hybrid.decode_step(tc, tparams, tcache, torch.from_numpy(tok), pos)
        _close(tl, jl)
    for n in tcache:
        _close(tcache[n], jcache[n])


def _pool(spec, rng, lengths):
    """Random (Lp, N, P, K, D) slabs, and a table giving row b the pages
    for lengths[b] + 1 tokens in order from 1."""
    P = spec.page_size
    need = [-(-(n + 1) // P) for n in lengths]
    shape = (spec.layers, 2 + sum(need), P, spec.kv_heads, spec.head_dim)
    kp, vp = _rand(rng, *shape), _rand(rng, *shape)
    tbl = np.zeros((len(lengths), max(need)), np.int32)
    nxt = 1
    for b, n in enumerate(need):
        tbl[b, :n] = np.arange(nxt, nxt + n)
        nxt += n
    return kp, vp, tbl, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("deep", [False, True])
def test_torch_hybrid_paged_triple_matches_jax(deep):
    """``paged_spec``; ``paged_prefill``'s k, v (meta paged in), state and
    logits over 25 + 4 tokens (the pad path); one ragged
    ``paged_decode_step`` at absolute positions 40 (ring wrapped), 9 and
    16 (a page boundary): logits, slabs and state.  The gather path
    (``impl="ref"``) is the CPU path itself."""
    from repro.models.model import paged_surface as jax_paged_surface

    jc, tc, jparams, tparams = _pair(deep)
    jspec = jax_paged_surface(jc)[0](jc)
    spec = hybrid.paged_spec(tc)
    assert (spec.layers, spec.page_size, spec.kv_heads, spec.head_dim, spec.page_bytes) == (
        jspec.layers, jspec.page_size, jspec.kv_heads, jspec.head_dim, jspec.page_bytes)
    jm = jax_get_model(jc)
    rng = np.random.default_rng(8)
    toks = rng.integers(1, tc.vocab_size, size=(2, 25), dtype=np.int32)
    jk, jv, jstate, jlogits = jm.paged_prefill(jc, jparams, jnp.asarray(toks))
    k, v, state, logits = hybrid.paged_prefill(tc, tparams, torch.from_numpy(toks))
    assert k.shape == (2, spec.layers, 29, spec.kv_heads, spec.head_dim)
    for got, want in ((logits, jlogits), (k, jk), (v, jv), *((state[n], jstate[n]) for n in state)):
        _close(got, want)
    assert sorted(state) == sorted(jstate) == ["ssm_conv", "ssm_state"]

    kp, vp, tbl, lens = _pool(spec, rng, [40, 9, 16])
    st = {n: _rand(rng, 3, *t.shape[1:]) for n, t in state.items()}
    tok = rng.integers(1, tc.vocab_size, size=(3,), dtype=np.int32)
    jout = jm.paged_decode_step(jc, jparams, jnp.asarray(kp), jnp.asarray(vp),
                                {n: jnp.asarray(a) for n, a in st.items()}, jnp.asarray(tok),
                                jnp.asarray(lens), jnp.asarray(tbl), jnp.asarray(lens))
    for impl in ("auto", "ref"):
        tkp, tvp = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
        args = [torch.from_numpy(a) for a in (tok, lens, tbl, lens)]
        kp2, vp2, st2, l2 = hybrid.paged_decode_step(
            tc, tparams, tkp, tvp, {n: torch.from_numpy(a) for n, a in st.items()}, *args,
            impl=impl)
        assert kp2 is tkp and vp2 is tvp  # the slabs are updated in place
        _close(l2, jout[3])
        _close(kp2, jout[0])
        _close(vp2, jout[1])
        for n in st2:
            _close(st2[n], jout[2][n])


# ---------------------------------------------------------------------------
# greedy tokens: the paged engine, the padded oracle, the JAX engine
# ---------------------------------------------------------------------------


def _prompts(cfg):
    rng = np.random.default_rng(3)
    return [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32) for n in PROMPT_LENS]


def port_oracle(cfg, params, prompt, max_new, max_seq):
    """Greedy tokens from the port's padded path: the shared
    ``paged_prefill``, its rows seeded into an ``init_cache`` of ``max_seq``
    slots (``hybrid.seed_cache``: ring layout for SWA producers), then
    ``decode_step``, whose ``pos`` counts content tokens."""
    k, v, state, logits = hybrid.paged_prefill(cfg, params, torch.from_numpy(prompt)[None])
    cache = hybrid.init_cache(cfg, 1, max_seq, device="cpu", dtype=torch.float32)
    hybrid.seed_cache(cfg, cache, k, v, state)
    out = [int(torch.argmax(logits[0]))]
    for g in range(max_new - 1):
        logits, cache = hybrid.decode_step(cfg, params, cache, torch.tensor([[out[-1]]]),
                                           len(prompt) + g)
        out.append(int(torch.argmax(logits[0, 0])))
    return out


def test_torch_hybrid_seed_cache_is_the_ring_written_in_order():
    """``seed_cache`` leaves what ``cache_update(ring=)`` leaves when every
    prefill token is written in order (the reference test's seeding)."""
    _, tc, _, tparams = _pair(True)
    k, v, state, _ = hybrid.paged_prefill(tc, tparams, torch.arange(1, 27)[None])
    cache = hybrid.seed_cache(tc, hybrid.init_cache(tc, 1, MAX_SEQ, device="cpu",
                                                    dtype=torch.float32), k, v, state)
    want = hybrid.init_cache(tc, 1, MAX_SEQ, device="cpu", dtype=torch.float32)
    ring = want["swa_k"].shape[2]
    for t in range(k.shape[2]):
        for i, li in enumerate([1, 2, 3]):  # producers 1, 2, 4: the SWA ones
            layers.cache_update(want["swa_k"][i], want["swa_v"][i], k[:, li, t:t + 1],
                                v[:, li, t:t + 1], t, ring=ring)
    for n in ("swa_k", "swa_v"):
        assert torch.equal(cache[n], want[n]), n
    T = k.shape[2]
    assert torch.equal(cache["glob_k"][1, :, :T], k[:, 4]) and not cache["glob_k"][:, :, T:].any()
    assert torch.equal(cache["ssm_state"][:, 0], state["ssm_state"][0])


@pytest.fixture(scope="module")
def device():
    return get_all_devices(platform="cpu").get()[0]


def test_torch_hybrid_paged_engine_greedy_tokens_bit_identical(device):
    """The port's case of ``test_zoo_greedy_parity_bitwise`` on ``DEEP``:
    tokens through ``PagedServeEngine.from_config`` (pages of 16, a table of
    3 pages) equal the port's padded oracle and the JAX engine's, bit for
    bit; every page comes back; no kernel launches on the CPU."""
    jc, tc, jparams, tparams = _pair(True)
    prompts = _prompts(tc)
    want = [port_oracle(tc, tparams, p, MAX_NEW, MAX_SEQ) for p in prompts]
    reset_launch_counts()
    eng = PagedServeEngine.from_config(tc, params=tparams, devices=[device], max_seq_len=MAX_SEQ,
                                       name="t-hybrid")
    try:
        assert eng.max_pages == MAX_PAGES and eng.kv.spec.page_size == PAGE
        futs = [eng.submit(p, MAX_NEW) for p in prompts]
        got = [list(np.asarray(f.get(timeout=600))) for f in futs]
        eng.drain()
        m = eng.metrics()
    finally:
        eng.close()
    assert got == want, f"paged {got} != padded oracle {want}"
    assert m["requests_completed"] == 3 and m["kv"][device.key]["used_pages"] == 0
    assert sum(launch_counts().values()) == 0
    jeng = JaxPagedServeEngine.from_config(jc, params=jparams, max_seq_len=MAX_SEQ,
                                           name="t-hybrid-jax")
    try:
        jgot = [list(np.asarray(f.get(timeout=600)))
                for f in [jeng.submit(p, MAX_NEW) for p in prompts]]
    finally:
        jeng.close()
    assert got == jgot, f"port {got} != JAX engine {jgot}"


# ---------------------------------------------------------------------------
# the smoke's serve_paged_hybrid phase, rehearsed on the CPU at smoke size
# ---------------------------------------------------------------------------


@pytest.fixture()
def smoke(monkeypatch):
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_torch_smoke_serve_paged_hybrid_phase_rehearsed_on_cpu(smoke, monkeypatch, device):
    """``phase_serve_paged_hybrid`` on ``DEEP`` with prompts of 9 and 20
    tokens (13 fit the window of 16 with the meta tokens, 24 do not): the
    engine's tokens equal the plain run's and the oracle's; every check
    passes but the launch counts (CPU tensors take the plain versions)."""
    monkeypatch.setattr(smoke, "get_config",
                        lambda name: dataclasses.replace(tcfg.smoke(tcfg.get_config(name)), **DEEP))
    monkeypatch.setattr(smoke, "SERVE_BATCH", 2)
    monkeypatch.setattr(smoke, "HYBRID_PROMPTS", (9, 20))
    monkeypatch.setattr(smoke, "HYBRID_NEW", 6)
    monkeypatch.setattr(smoke, "PAGED_WARMUP", 4)
    failed = []
    monkeypatch.setattr(smoke, "require", lambda ok, msg: ok or failed.append(msg))
    out = smoke.phase_serve_paged_hybrid(device)
    # paged_attention, flash and ssd_scan: counted where the card launches them
    assert len(failed) == 3 and all("launch" in m for m in failed), failed
    assert out["requests"] == 4 and out["new_tokens"] == 6
    assert sorted({T for _, T in out["prefill_batch_shapes"]}) == [9, 20]
    assert out["near_tie_cuts_kernel_vs_plain"] <= 4
    assert all(out[impl]["near_tie_cuts_vs_oracle"] <= 4 for impl in ("auto", "ref"))
    assert out["kv_layers"] == 5 and out["meta_tokens"] == 4 and out["window"] == 16
    # 6 layers x (8 heads x 16 x 16 state + 3 x (128 + 2 x 16) conv) f32
    assert out["state_bytes_per_request"] == 4 * 6 * (8 * 16 * 16 + 3 * 160)
    assert out["launches"]["ref"]["ssd_scan"] == out["launches"]["ref"]["flash_attention"] == 0


def test_torch_smoke_launch_rules_for_hybrid(smoke):
    """The launches the smoke asks of a hybrid: flash on all 32 layers of a
    prefill that fits the window with its 128 meta tokens, on the 3 global
    layers of a longer one; paged_attention on the 3 global layers."""
    cfg = tcfg.get_config("hymba-1.5b")
    assert [smoke.prefill_kernel_layers(cfg, T) for T in (700, 896, 897, 2000)] == [32, 32, 3, 3]
    assert smoke.paged_attention_layers(cfg) == 3
    olmo, mamba = tcfg.get_config("olmo-1b"), tcfg.get_config("mamba2-130m")
    assert smoke.prefill_kernel_layers(olmo, 5000) == smoke.paged_attention_layers(olmo) == 16
    assert smoke.prefill_kernel_layers(mamba, 4000) == 24
    assert smoke.paged_attention_layers(mamba) == 0


def test_torch_smoke_checks_kernels_at_hymba_shapes(smoke, monkeypatch):
    """paged_attention is held at serve_paged_hybrid's decode geometry: 8
    rows of 25 heads over 5 of 64, lengths across the decode of the 700-
    and 2000-token prompts with 128 meta tokens, 135 pages a row."""
    seen = {}
    monkeypatch.setattr(smoke, "paged_entry",
                        lambda name, shape, lengths, launches, device: seen.update(
                            name=name, shape=shape, lengths=lengths, launches=launches))
    smoke.check_paged_hybrid(93, "cpu")
    assert seen["name"] == "paged_attention_hybrid" and seen["launches"] == 93
    assert seen["shape"] == (8, 25, 5, 64, 16, 135)
    assert seen["lengths"] == [828, 838, 848, 859, 2128, 2138, 2148, 2159]
