"""The port's paged serving contract and ``PagedServeEngine``, held against
the JAX package on the CPU.

* The paged triple (``paged_spec``/``paged_prefill``/``paged_decode_step``)
  of the olmo-1b, stablelm-1.6b and mamba2-130m smoke configs against the
  JAX triple on the same weights (the JAX init carried across with
  ``params_from_numpy``) and the same pools: prefill KV, state and logits,
  then one ragged decode step's logits, slabs and state, within 1e-4 (f32
  on both sides, summed in other orders).
* The decode lane's warm row counts, stepped by hand on both engines over
  a sequence of batch sizes (with and without a ``decode_shapes``
  palette): the same padding step by step, the same warm set, the same
  tokens; pad rows change no real row's tokens, pages or state.
* ``PagedServeEngine.from_config`` on the CPU device: greedy tokens over
  prompts of 5, 14 and 17 tokens (a partial page, a boundary crossed
  mid-decode, one crossed at prefill; page 16, a table of 3 pages, 6
  tokens) are BIT-IDENTICAL to the port's own padded ``decode_step``
  oracle over a cache of the same width (48 slots), as
  ``tests/test_paged_models.py`` asserts for the JAX package, and
  identical to the JAX padded oracle's tokens; for olmo-1b, stablelm-1.6b,
  mamba2-130m, qwen2-moe-a2.7b (MoE dispatched per row), whisper-tiny
  (each request with its frames as ``extras``, the cross K/V its state) and
  hymba-1.5b (meta tokens paged in with the prompt, ring caches seeded for
  the sliding-window layers; its deeper smoke is in
  ``tests/test_torch_hybrid.py``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfg
from repro.core.futures import Promise as JaxPromise
from repro.models.model import get_model as jax_get_model
from repro.serving.paged import PagedServeEngine as JaxPagedServeEngine
from repro.serving.paged import _PagedRequest as JaxPagedRequest
from repro.models.model import paged_surface as jax_paged_surface
from repro_torch import configs as tcfg
from repro_torch.core import Promise, get_all_devices
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.models import get_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import paged_surface
from repro_torch.serving import PagedServeEngine
from repro_torch.serving.paged import _PagedRequest

ARCHS = ["olmo-1b", "stablelm-1.6b", "mamba2-130m"]
TOL = dict(rtol=1e-4, atol=1e-4)
PAGE = 16
MAX_PAGES = 3
MAX_SEQ = MAX_PAGES * PAGE  # oracle cache width == engine table width * P
PROMPT_LENS = (5, 14, 17)
MAX_NEW = 6


@pytest.fixture(scope="module")
def device():
    return get_all_devices(platform="cpu").get()[0]


@functools.lru_cache(maxsize=None)
def _pair(arch):
    jc = jcfg.smoke(jcfg.get_config(arch))
    tc = tcfg.smoke(tcfg.get_config(arch))
    jparams = jax_get_model(jc).init(jc, jax.random.key(0))
    tparams = params_from_numpy(tc, jax.tree.map(np.asarray, jparams), device="cpu")
    return jc, tc, jparams, tparams


def _pool(spec, rng, lengths):
    """Random (L, N, P, K, D) slabs, and a table giving row b the pages
    for lengths[b] + 1 tokens in order from 1."""
    P = spec.page_size
    need = [-(-(n + 1) // P) for n in lengths]
    N = 1 + sum(need) + 1
    shape = (spec.layers, N, P, spec.kv_heads, spec.head_dim)
    kp = rng.normal(size=shape).astype(np.float32)
    vp = rng.normal(size=shape).astype(np.float32)
    tbl = np.zeros((len(lengths), max(need)), np.int32)
    nxt = 1
    for b, n in enumerate(need):
        tbl[b, :n] = np.arange(nxt, nxt + n)
        nxt += n
    return kp, vp, tbl, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_torch_paged_triple_matches_jax(arch):
    jc, tc, jparams, tparams = _pair(arch)
    (jspec_fn, jpre, jdec), (spec_fn, pre, dec) = jax_paged_surface(jc), paged_surface(tc)
    spec, jspec = spec_fn(tc), jspec_fn(jc)
    assert (spec.layers, spec.page_size, spec.kv_heads, spec.head_dim, spec.page_bytes) == (
        jspec.layers, jspec.page_size, jspec.kv_heads, jspec.head_dim, jspec.page_bytes)
    assert spec.dtype == torch.float32
    rng = np.random.default_rng(11)
    toks = rng.integers(1, tc.vocab_size, size=(2, 13), dtype=np.int32)
    jk, jv, jstate, jlogits = jpre(jc, jparams, jnp.asarray(toks))
    k, v, state, logits = pre(tc, tparams, torch.from_numpy(toks))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), **TOL)
    assert (state is None) == (jstate is None)
    if state is not None:
        for n in state:
            np.testing.assert_allclose(state[n].numpy(), np.asarray(jstate[n]), **TOL)

    # one ragged decode step: a row on a page boundary and one inside a page
    lengths = [16, 9]
    kp, vp, tbl, lens = _pool(spec, rng, lengths)
    tok = rng.integers(1, tc.vocab_size, size=(2,), dtype=np.int32)
    jargs = (jnp.asarray(tok), jnp.asarray(lens), jnp.asarray(tbl), jnp.asarray(lens))
    jst = None if jstate is None else jax.tree.map(jnp.asarray, jstate)
    jkp2, jvp2, jst2, jl2 = jdec(jc, jparams, jnp.asarray(kp), jnp.asarray(vp), jst, *jargs)
    tkp, tvp = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    st = None if state is None else {n: t.clone() for n, t in state.items()}
    targs = [torch.from_numpy(a) for a in (tok, lens, tbl, lens)]
    kp2, vp2, st2, l2 = dec(tc, tparams, tkp, tvp, st, *targs)
    assert kp2 is tkp and vp2 is tvp  # the slabs are updated in place
    np.testing.assert_allclose(l2.numpy(), np.asarray(jl2), **TOL)
    np.testing.assert_allclose(kp2.numpy(), np.asarray(jkp2), **TOL)
    np.testing.assert_allclose(vp2.numpy(), np.asarray(jvp2), **TOL)
    if st2 is not None:
        for n in st2:
            np.testing.assert_allclose(st2[n].numpy(), np.asarray(jst2[n]), **TOL)
    # the gather path through ``impl="ref"`` is the CPU path itself
    tkp3, tvp3 = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    st3 = None if state is None else {n: t.clone() for n, t in state.items()}
    l3 = dec(tc, tparams, tkp3, tvp3, st3, *targs, impl="ref")[3]
    assert torch.equal(l3, l2)


def _prompts(cfg):
    rng = np.random.default_rng(3)
    return [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32) for n in PROMPT_LENS]


def _extras(cfg):
    """whisper's frames, drawn after the prompts from the same stream, as
    ``tests/test_paged_models.py`` draws them; None for the other families."""
    if cfg.family != "encdec":
        return None
    rng = np.random.default_rng(3)
    for n in PROMPT_LENS:
        rng.integers(1, cfg.vocab_size, size=n)
    e = cfg.encdec
    return {"frames": rng.normal(0, 0.02, (e.encoder_seq, cfg.d_model)).astype(np.float32)}


def _port_oracle(cfg, params, prompt, extras=None):
    """Greedy tokens from the port's padded path: the shared
    ``paged_prefill``, its KV (or state) seeded into an ``init_cache`` of
    MAX_SEQ slots, then ``decode_step``."""
    m = get_model(cfg)
    ex = None if extras is None else {n: torch.from_numpy(x)[None] for n, x in extras.items()}
    k, v, state, logits = m.paged_prefill(cfg, params, torch.from_numpy(prompt)[None], ex)
    out = [int(torch.argmax(logits[0]))]
    if cfg.family in ("dense", "moe", "vlm"):
        cache = m.init_cache(cfg, 1, MAX_SEQ, device="cpu", dtype=torch.float32)
        cache["k"][:, 0, :len(prompt)] = k[0]
        cache["v"][:, 0, :len(prompt)] = v[0]
    elif cfg.family == "encdec":
        cache = m.init_cache(cfg, 1, MAX_SEQ, device="cpu", dtype=torch.float32)
        cache["self_k"][:, 0, :len(prompt)] = k[0]
        cache["self_v"][:, 0, :len(prompt)] = v[0]
        cache["cross_k"][:, 0] = state["cross_k"][0]
        cache["cross_v"][:, 0] = state["cross_v"][0]
    elif cfg.family == "hybrid":
        cache = m.init_cache(cfg, 1, MAX_SEQ, device="cpu", dtype=torch.float32)
        m.seed_cache(cfg, cache, k, v, state)
    else:
        cache = {n: state[n].movedim(0, 1).clone() for n in state}
    for g in range(MAX_NEW - 1):
        logits, cache = m.decode_step(cfg, params, cache, torch.tensor([[out[-1]]]),
                                      len(prompt) + g)
        out.append(int(torch.argmax(logits[0, 0])))
    return out


def _jax_hybrid_cache(cfg, cache, k, v, state):
    """The reference test's seeding (``tests/test_paged_models.py``): one
    prefill row (k/v (producers, T', K, hd)) written token by token, slot
    t % ring of a sliding-window producer, [0, T') of a global one."""
    from repro.models.hybrid import _is_global, kv_producers

    out = {n: np.asarray(x).copy() for n, x in cache.items()}
    ring, swa, glob = out["swa_k"].shape[2], 0, 0
    for li, l in enumerate(kv_producers(cfg)):
        if _is_global(cfg, l):
            out["glob_k"][glob, 0, :k.shape[1]] = k[li]
            out["glob_v"][glob, 0, :v.shape[1]] = v[li]
            glob += 1
            continue
        for t in range(k.shape[1]):
            out["swa_k"][swa, 0, t % ring] = k[li, t]
            out["swa_v"][swa, 0, t % ring] = v[li, t]
        swa += 1
    out["ssm_state"] = np.asarray(state["ssm_state"])[0][:, None]
    out["ssm_conv"] = np.asarray(state["ssm_conv"])[0][:, None]
    return {n: jnp.asarray(x) for n, x in out.items()}


def _jax_oracle(cfg, params, prompt, extras=None):
    """The JAX package's padded oracle (``tests/test_paged_models.py``):
    its ``paged_prefill``, then ``decode_step`` over a MAX_SEQ cache."""
    m = jax_get_model(cfg)
    ex = None if extras is None else {n: jnp.asarray(x)[None] for n, x in extras.items()}
    k, v, state, logits = jax.jit(functools.partial(m.paged_prefill, cfg, params))(
        jnp.asarray(prompt)[None], ex)
    out = [int(np.argmax(np.asarray(logits)[0]))]
    if cfg.family in ("dense", "moe", "vlm"):
        cache = m.init_cache(cfg, 1, MAX_SEQ, dtype=jnp.float32)
        cache = {n: cache[n].at[:, 0, :len(prompt)].set(x[0]) for n, x in (("k", k), ("v", v))}
    elif cfg.family == "encdec":
        cache = m.init_cache(cfg, 1, MAX_SEQ, dtype=jnp.float32)
        cache = {"self_k": cache["self_k"].at[:, 0, :len(prompt)].set(k[0]),
                 "self_v": cache["self_v"].at[:, 0, :len(prompt)].set(v[0]),
                 "cross_k": jnp.asarray(state["cross_k"])[0][:, None],
                 "cross_v": jnp.asarray(state["cross_v"])[0][:, None]}
    elif cfg.family == "hybrid":
        cache = _jax_hybrid_cache(cfg, m.init_cache(cfg, 1, MAX_SEQ, dtype=jnp.float32),
                                  np.asarray(k)[0], np.asarray(v)[0], state)
    else:
        cache = {n: jnp.moveaxis(state[n], 0, 1) for n in state}
    dec = jax.jit(functools.partial(m.decode_step, cfg, params))
    for g in range(MAX_NEW - 1):
        logits, cache = dec(cache, jnp.asarray([[out[-1]]], jnp.int32), jnp.int32(len(prompt) + g))
        out.append(int(np.argmax(np.asarray(logits)[0, 0])))
    return out


@pytest.mark.parametrize("arch", ARCHS + ["qwen2-moe-a2.7b", "whisper-tiny", "hymba-1.5b"])
def test_torch_paged_engine_greedy_tokens_bit_identical(arch, device):
    jc, tc, jparams, tparams = _pair(arch)
    prompts, extras = _prompts(tc), _extras(tc)
    want = [_port_oracle(tc, tparams, p, extras) for p in prompts]
    reset_launch_counts()
    eng = PagedServeEngine.from_config(tc, params=tparams, devices=[device], max_seq_len=MAX_SEQ,
                                       name=f"t-zoo-{arch}")
    try:
        assert eng.max_pages == MAX_PAGES and eng.kv.spec.page_size == PAGE
        futs = [eng.submit(p, MAX_NEW, extras=extras) for p in prompts]
        got = [list(np.asarray(f.get(timeout=600))) for f in futs]
        eng.drain()
        m = eng.metrics()
    finally:
        eng.close()
    for p, w, g in zip(prompts, want, got):
        assert g == w, f"{arch} T={len(p)}: paged {g} != padded oracle {w}"
    # Batches pad to warm row counts (the reference's rule): at most the
    # real rows a step, and the tokens above are those of the unpadded oracle.
    assert m["requests_completed"] == 3 and 0 <= m["padded_rows"] <= m["decode_rows"]
    assert m["padding_waste"] == m["padded_rows"] / m["rows"]
    assert m["decode_rows"] == 3 * (MAX_NEW - 1)
    assert m["kv"][device.key]["used_pages"] == 0  # every page back
    assert sum(launch_counts().values()) == 0  # CPU tensors: the plain versions
    jax_want = [_jax_oracle(jc, jparams, p, extras) for p in prompts]
    assert got == jax_want, f"{arch}: port {got} != JAX padded oracle {jax_want}"


@pytest.mark.parametrize("q_block", [None, 2])
@pytest.mark.parametrize("causal", [False, True])
def test_torch_attention_per_row_valid_len_matches_jax(q_block, causal):
    """``layers.attention`` with a (B,) ``valid_len`` (each row its own
    prefix) against the JAX ``attention``; a scalar keeps its old path."""
    from repro.models import layers as jax_layers
    from repro_torch.models import layers

    rng = np.random.default_rng(8)
    B, Sq, Skv, H, K, D = 3, 3, 11, 4, 2, 8
    q = rng.normal(size=(B, Sq, H, D)).astype(np.float32)
    k = rng.normal(size=(B, Skv, K, D)).astype(np.float32)
    v = rng.normal(size=(B, Skv, K, D)).astype(np.float32)
    for vl in (np.asarray([1, 7, 11], np.int32), 6):
        jvl = jnp.asarray(vl) if isinstance(vl, np.ndarray) else vl
        tvl = torch.from_numpy(vl) if isinstance(vl, np.ndarray) else vl
        want = jax_layers.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                                    q_offset=8, q_block=q_block, valid_len=jvl)
        got = layers.attention(*map(torch.from_numpy, (q, k, v)), causal=causal, q_offset=8,
                               q_block=q_block, valid_len=tvl)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_torch_page_helpers_match_jax():
    """``page_scatter`` (in place), ``page_gather`` and the gather path of
    ``paged_decode_attend`` against the JAX layers."""
    from repro.models import layers as jax_layers
    from repro_torch.models import layers

    rng = np.random.default_rng(9)
    N, P, K, D, H = 7, 4, 2, 8, 4
    kp = rng.normal(size=(N, P, K, D)).astype(np.float32)
    vp = rng.normal(size=(N, P, K, D)).astype(np.float32)
    tbl = np.asarray([[1, 2, 0], [3, 4, 5]], np.int32)
    lens = np.asarray([4, 9], np.int32)  # a row on a page boundary, one inside a page
    kn = rng.normal(size=(2, 1, K, D)).astype(np.float32)
    vn = rng.normal(size=(2, 1, K, D)).astype(np.float32)
    q = rng.normal(size=(2, 1, H, D)).astype(np.float32)
    jkp, jvp = jax_layers.page_scatter(*map(jnp.asarray, (kp, vp, kn, vn, tbl, lens)))
    tkp, tvp = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    out = layers.page_scatter(tkp, tvp, *map(torch.from_numpy, (kn, vn, tbl, lens)))
    assert out[0] is tkp and out[1] is tvp
    np.testing.assert_array_equal(tkp.numpy(), np.asarray(jkp))
    np.testing.assert_array_equal(tvp.numpy(), np.asarray(jvp))
    np.testing.assert_array_equal(layers.page_gather(tkp, torch.from_numpy(tbl)).numpy(),
                                  np.asarray(jax_layers.page_gather(jkp, jnp.asarray(tbl))))
    want = jax_layers.paged_decode_attend(jnp.asarray(q), jkp, jvp, jnp.asarray(tbl),
                                          jnp.asarray(lens))
    for impl in ("auto", "ref"):
        got = layers.paged_decode_attend(torch.from_numpy(q), tkp, tvp, torch.from_numpy(tbl),
                                         torch.from_numpy(lens), impl=impl)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="impl="):
        layers.paged_decode_attend(torch.from_numpy(q), tkp, tvp, torch.from_numpy(tbl),
                                   torch.from_numpy(lens), impl="cuda")


@pytest.fixture(scope="module")
def smoke():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch,prompts", [("olmo-1b", (12, 20)), ("mamba2-130m", (12, 40))])
def test_torch_smoke_serve_paged_phase_rehearsed_on_cpu(smoke, device, monkeypatch, arch, prompts):
    """``chip_smoke.phase_serve_paged`` end to end on the CPU device at smoke
    size, held against the serve flow's plain tokens: every check passes
    but the launch counts (CPU tensors take the plain versions)."""
    monkeypatch.setattr(smoke, "get_config", lambda name: tcfg.smoke(tcfg.get_config(name)))
    monkeypatch.setattr(smoke, "SERVE_BATCH", 2)
    monkeypatch.setattr(smoke, "SERVE_NEW", 4)
    monkeypatch.setattr(smoke, "PAGED_WARMUP", 4)
    failed = []
    monkeypatch.setattr(smoke, "require", lambda ok, msg: ok or failed.append(msg))
    cfg = tcfg.smoke(tcfg.get_config(arch))
    params = get_model(cfg).init(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    groups = [rng.integers(0, cfg.vocab_size, size=(2, s), dtype=np.int32) for s in prompts]
    plain = smoke.serve_flow(device, cfg, params, groups, [device.create_stream() for _ in groups],
                             4, impl="ref")
    out = smoke.phase_serve_paged(device, arch, prompts, {
        "tokens": np.concatenate([g["tokens"] for g in plain]),
        "gaps": np.concatenate([g["gaps"] for g in plain])})
    launch_checks = [m for m in failed if "launched" in m]
    # the card's counts: paged_attention (dense only) and the prefill kernel
    assert failed == launch_checks and len(launch_checks) == (2 if cfg.family == "dense" else 1)
    assert out["requests"] == 4 and out["auto"]["decode_steps"] >= 4
    assert out["auto"]["near_tie_cuts_vs_serve_plain"] <= out["requests"]  # cut, never differing
    assert out["launches"]["ref"]["paged_attention"] == 0


def test_torch_smoke_paged_bytes_and_inputs(smoke):
    q, kp, vp, tbl, lens = smoke.paged_inputs(3, 4, 2, 8, 4, 4, [5, 0, 16], "cpu")
    assert tbl.tolist() == [[1, 2, 0, 0], [0, 0, 0, 0], [3, 4, 5, 6]]
    assert (kp[0] == 1e6).all() and (vp[2, 1:] == -1e6).all() and (kp[1] != 1e6).all()
    # 21 valid tokens x (k + v) x 2 kv heads x 8 x 4 bytes; q and o; 6 table entries and 3 lengths
    assert smoke.paged_bytes(q, kp, tbl, lens) == 21 * 2 * 2 * 8 * 4 + 2 * 3 * 4 * 8 * 4 + 4 * 6 + 4 * 3
    assert smoke.paged_flops(q, lens, 16) == 4 * 8 * 4 * 21
    fq, fk, *_ = smoke.paged_inputs(3, 4, 2, 8, 4, 4, [5, 0, 16], "cpu", layers=2)
    assert fq.shape == (2, 3, 4, 8) and fk.shape == (2, 9, 4, 2, 8)
    assert smoke.paged_bytes(fq, fk, tbl, lens) == 2 * 21 * 2 * 2 * 8 * 4 + 2 * 2 * 3 * 4 * 8 * 4 + 4 * 6 + 4 * 3
    assert smoke.paged_flops(fq, lens, 16) == 2 * 4 * 8 * 4 * 21


# ---------------------------------------------------------------------------
# warm row counts: the decode lane stepped by hand on both engines
# ---------------------------------------------------------------------------


def _resident(eng, prompts, jax_side: bool):
    """Requests prefilled and paged in as each engine's prefill lane does
    (one prompt a call), never admitted: the test steps the lane itself."""
    reqs = []
    for rid, p in enumerate(prompts):
        if jax_side:
            k, v, state, logits = eng.prefill_fn(jnp.asarray(p)[None], None)
            r = JaxPagedRequest(p, 1000, JaxPromise(), 0.0, rid=rid)
            r.seq = eng.kv.new_seq(next(iter(eng.kv.pools.values())).device)
            eng.kv.append(r.seq, np.asarray(k[0]), np.asarray(v[0]))
            if state is not None:
                r.seq.set_state(jax.tree.map(lambda a: np.asarray(a)[0], state))
            r.out.append(int(np.argmax(np.asarray(logits)[0])))
        else:
            k, v, state, logits = eng.prefill_fn(torch.from_numpy(p)[None], None)
            r = _PagedRequest(p, 1000, Promise(), 0.0, rid=rid)
            r.seq = eng.kv.new_seq(eng.device)
            eng.kv.append(r.seq, k[0], v[0])
            if state is not None:
                r.seq.set_state({n: t[0] for n, t in state.items()})
            r.out.append(int(torch.argmax(logits[0])))
        reqs.append(r)
    return reqs


def _step_by_hand(eng, reqs, rows, jax_side: bool):
    """Step the decode lane over ``reqs[:b]`` for each b of ``rows``;
    returns the rows each step padded and the lane's warm set."""
    lane = eng._lane_for(next(iter(eng.kv.pools.values())).device)
    pads = []
    for b in rows:
        before = eng.metrics()["padded_rows"]
        lane._step(reqs[:b])
        pads.append(eng.metrics()["padded_rows"] - before)
    return pads, set(lane._warm)


def _slab_rows(eng, reqs, jax_side: bool):
    """Each request's resident K/V tokens (L, length, K, D) and its state."""
    pool = next(iter(eng.kv.pools.values()))
    ks, vs = pool.arrays()
    ks, vs = (np.asarray(x) if jax_side else x.numpy() for x in (ks, vs))
    P = eng.kv.spec.page_size
    out = []
    for r in reqs:
        t = np.arange(r.seq.length)
        pages = np.asarray(r.seq.pages)[t // P]
        state = r.seq.state
        if state is not None:
            state = {n: np.asarray(x) if jax_side else x.numpy() for n, x in state.items()}
        out.append((ks[:, pages, t % P], vs[:, pages, t % P], state))
    return out, ks[:, 0], vs[:, 0]


def _engines(arch, device, shapes, port_shapes=None):
    jc, tc, jparams, tparams = _pair(arch)
    jeng = JaxPagedServeEngine.from_config(jc, params=jparams, max_seq_len=MAX_SEQ,
                                           decode_shapes=shapes, name=f"t-warm-jax-{arch}")
    teng = PagedServeEngine.from_config(tc, params=tparams, devices=[device], max_seq_len=MAX_SEQ,
                                        decode_shapes=shapes if port_shapes is None else port_shapes,
                                        name=f"t-warm-{arch}")
    return jc, tc, jeng, teng


@pytest.mark.parametrize("shapes", [None, (2, 4, 8)])
def test_torch_warm_rows_follow_the_reference_lane(device, shapes):
    """Over one sequence of batch sizes (the 2x cap taken and refused, a
    shrinking tail, a new high-water mark), the port's lane pads every step
    as the reference's does, ends with the same warm set and decodes the
    same tokens."""
    rows = (3, 1, 2, 6, 4, 5, 2, 1, 7, 3)
    jc, tc, jeng, teng = _engines("olmo-1b", device, shapes)
    try:
        rng = np.random.default_rng(17)
        prompts = [rng.integers(1, tc.vocab_size, size=n).astype(np.int32)
                   for n in (5, 9, 14, 16, 17, 3, 11)]
        jreqs, treqs = _resident(jeng, prompts, True), _resident(teng, prompts, False)
        jpads, jwarm = _step_by_hand(jeng, jreqs, rows, True)
        tpads, twarm = _step_by_hand(teng, treqs, rows, False)
        m = teng.metrics()
    finally:
        jeng.close()
        teng.close()
    assert tpads == jpads and twarm == jwarm
    assert sum(tpads) > 0 and m["padded_rows"] == sum(tpads)
    assert m["decode"]["warm_counts"] == sorted(twarm)
    assert m["decode"]["eager_steps"] == len(rows) and m["decode"]["graphs_captured"] == 0  # CPU
    assert [r.out for r in treqs] == [r.out for r in jreqs]


@pytest.mark.parametrize("arch", ["olmo-1b", "mamba2-130m"])
def test_torch_decode_shapes_pad_rows_change_no_real_row(device, arch):
    """``decode_shapes=(2, 4, 8)`` with 3 live requests: 3 rows run at 4,
    1 at 2.  Tokens identical to the reference engine's with the same
    palette and to the port's exact-row run; each real row's pages and
    state as the reference's (within TOL) and as the exact-row run's;
    the reserved page 0 never written."""
    rows = (3, 3, 1, 2, 3, 3)
    _, tc, jeng, teng = _engines(arch, device, (2, 4, 8))
    exact = PagedServeEngine.from_config(tc, params=_pair(arch)[3], devices=[device],
                                         max_seq_len=MAX_SEQ, decode_shapes=(3, 1, 2),
                                         name=f"t-exact-{arch}")
    try:
        prompts = _prompts(tc)
        got = {}
        for key, eng, jax_side in (("jax", jeng, True), ("port", teng, False),
                                   ("exact", exact, False)):
            reqs = _resident(eng, prompts, jax_side)
            pads, _ = _step_by_hand(eng, reqs, rows, jax_side)
            got[key] = (pads, [r.out for r in reqs], _slab_rows(eng, reqs, jax_side))
    finally:
        for eng in (jeng, teng, exact):
            eng.close()
    assert got["port"][0] == got["jax"][0] == [1, 1, 1, 0, 1, 1]
    assert got["exact"][0] == [0] * len(rows)
    assert got["port"][1] == got["jax"][1] == got["exact"][1]
    (prows, pk0, pv0), (jrows, _, _), (erows, _, _) = (got[k][2] for k in ("port", "jax", "exact"))
    assert not pk0.any() and not pv0.any()  # page 0: the padding target, never written
    for (pk, pv, ps), (jk, jv, js), (ek, ev, es) in zip(prows, jrows, erows):
        for a, b, c in [(pk, jk, ek), (pv, jv, ev)] + [(ps[n], js[n], es[n]) for n in (ps or {})]:
            np.testing.assert_allclose(a, b, **TOL)
            np.testing.assert_allclose(a, c, rtol=1e-6, atol=1e-6)
