"""The port's moe, vlm and encdec families (and starcoder2-7b's dense
config) held against the JAX package on the CPU.

For the smoke configs of qwen2-moe-a2.7b (60 -> 8 experts top-2, a shared
expert, qkv bias), phi3.5-moe (16 -> 8 experts top-2, GQA), starcoder2-7b
(LayerNorm, gelu MLP with biases, GQA), qwen2-vl-72b (M-RoPE at sections
(4, 2, 2), the patch-embedding stub) and whisper-tiny (encoder-decoder,
cross-attention, learned positions), the JAX params (``init(cfg,
jax.random.key(0))``) are carried across with ``params_from_numpy`` and
both packages run the same inputs in f32: forward logits, KV and aux,
teacher-forced ``decode_step`` and the paged triple, within 1e-4 (the
``TOL`` of ``tests/test_torch_models.py``: the same f32 operations summed
in other orders).  The MoE router's top-k indices are compared exactly
where the k-th and (k+1)-th probabilities are apart; ``make_batch`` is
bit-equal to the reference's.  The smoke's serve_moe, serve_paged_moe and
serve_paged_encdec phases are rehearsed at smoke size on the CPU.
"""
import dataclasses
import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfg
from repro.configs.base import ShapeConfig as JaxShape
from repro.models import layers as jax_layers
from repro.models import moe as jax_moe
from repro.models.model import get_model as jax_get_model
from repro.models.model import make_batch as jax_make_batch
from repro.models.model import paged_surface as jax_paged_surface
from repro_torch import configs as tcfg
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import get_all_devices, reset_runtime
from repro_torch.models import get_model, layers, moe
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import make_batch, paged_surface

ZOO = ["qwen2-moe-a2.7b", "phi3.5-moe", "starcoder2-7b", "qwen2-vl-72b", "whisper-tiny"]
TOL = dict(rtol=1e-4, atol=1e-4)


@functools.lru_cache(maxsize=None)
def _pair(arch):
    jc = jcfg.smoke(jcfg.get_config(arch))
    tc = tcfg.smoke(tcfg.get_config(arch))
    jparams = jax_get_model(jc).init(jc, jax.random.key(0))
    tparams = params_from_numpy(tc, jax.tree.map(np.asarray, jparams), device="cpu")
    return jc, tc, jparams, tparams


def _batch(cfg, B, S, seed):
    """Tokens and the family's stub inputs, as numpy arrays."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, size=(B, S), dtype=np.int32)}
    if cfg.family == "encdec":
        b["frames"] = rng.normal(0, 0.02, (B, cfg.encdec.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        b["patch_embeds"] = rng.normal(0, 0.02, (B, cfg.num_patches, cfg.d_model)).astype(np.float32)
        b["positions"] = rng.integers(0, S, size=(3, B, S), dtype=np.int32)
    return b


def _kv_pairs(cfg, kv):
    """(name, array) of a forward's KV: stacked k/v, or whisper's lists."""
    if cfg.family == "encdec":
        return [(f"{part}[{i}].{n}", x) for part in ("self", "cross")
                for i, pair in enumerate(kv[part]) for n, x in zip("kv", pair)]
    return list(kv.items())


def test_torch_qwen2_moe_full_size_param_count():
    """The smoke's full-size model: 14,315,487,232 parameters, as laid out."""
    cfg = tcfg.get_config("qwen2-moe-a2.7b")
    shapes = []
    layers.tree_map(shapes.append, get_model(cfg).param_shapes(cfg))
    assert cfg.param_count() == 14_315_487_232
    # param_count leaves out the norm scales, the qkv biases and the shared
    # expert's (d, 1) gate
    L, d = cfg.num_layers, cfg.d_model
    uncounted = (2 * L + 1) * d + L * 3 * d + L * d
    assert sum(int(np.prod(s)) for s in shapes) == cfg.param_count() + uncounted


@pytest.mark.parametrize("arch", ZOO)
def test_torch_zoo_forward_matches_reference(arch):
    jc, tc, jparams, tparams = _pair(arch)
    b = _batch(tc, 2, 24, seed=1)
    jl, jaux, jkv = jax_get_model(jc).forward(jc, jparams, jax.tree.map(jnp.asarray, b),
                                              q_block=8, return_kv=True)
    tl, taux, tkv = get_model(tc).forward(tc, tparams, {k: torch.from_numpy(v) for k, v in b.items()},
                                          q_block=8, return_kv=True)
    assert tl.dtype == torch.float32 and tl.shape == jl.shape
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    assert (float(taux) > 0) == (tc.moe is not None)  # the routers' aux loss, 0 without MoE
    jpairs, tpairs = _kv_pairs(jc, jkv), _kv_pairs(tc, tkv)
    assert [n for n, _ in tpairs] == [n for n, _ in jpairs]
    for (n, t), (_, j) in zip(tpairs, jpairs):
        assert tuple(t.shape) == j.shape, n
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL, err_msg=n)
    # last_only keeps the final position; q_block does not change the math
    tlast, _ = get_model(tc).forward(tc, tparams, {k: torch.from_numpy(v) for k, v in b.items()},
                                     q_block=None, last_only=True)
    np.testing.assert_allclose(tlast.numpy(), tl[:, -1:].numpy(), rtol=1e-5, atol=1e-5)


def _seeded_caches(jc, tc, jparams, tparams, b, B, width):
    """Both packages' decode caches; whisper's cross K/V from its encoder."""
    jm, tm = jax_get_model(jc), get_model(tc)
    jcache = jm.init_cache(jc, B, width, dtype=jnp.float32)
    tcache = tm.init_cache(tc, B, width, dtype=torch.float32, device="cpu")
    if tc.family == "encdec":
        from repro.models import encdec as jax_encdec
        from repro_torch.models import encdec

        jx = jax_encdec._cross_kv(jc, jparams, jax_encdec.encode(jc, jparams, jnp.asarray(b["frames"])))
        tx = encdec._cross_kv(tc, tparams, encdec.encode(tc, tparams, torch.from_numpy(b["frames"])))
        jcache = dict(jcache, cross_k=jnp.stack([k for k, _ in jx]),
                      cross_v=jnp.stack([v for _, v in jx]))
        tcache["cross_k"][:] = torch.stack([k for k, _ in tx])
        tcache["cross_v"][:] = torch.stack([v for _, v in tx])
    return jcache, tcache


@pytest.mark.parametrize("arch", ZOO)
def test_torch_zoo_decode_steps_match_reference(arch):
    jc, tc, jparams, tparams = _pair(arch)
    B, steps = 2, 12
    b = _batch(tc, B, steps, seed=2)
    toks = b["tokens"]
    jm, tm = jax_get_model(jc), get_model(tc)
    jcache, tcache = _seeded_caches(jc, tc, jparams, tparams, b, B, steps)
    for pos in range(steps):  # teacher-forced decode over the whole sequence
        jl, jcache = jm.decode_step(jc, jparams, jcache, jnp.asarray(toks[:, pos:pos + 1]),
                                    jnp.int32(pos))
        tl, tcache = tm.decode_step(tc, tparams, tcache, torch.from_numpy(toks[:, pos:pos + 1]), pos)
        assert tl.shape == (B, 1, tc.vocab_size)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for n in tcache:
        np.testing.assert_allclose(tcache[n].numpy(), np.asarray(jcache[n]), **TOL, err_msg=n)


def _pool(spec, rng, lengths):
    P = spec.page_size
    need = [-(-(n + 1) // P) for n in lengths]
    shape = (spec.layers, 2 + sum(need), P, spec.kv_heads, spec.head_dim)
    kp, vp = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    tbl = np.zeros((len(lengths), max(need)), np.int32)
    nxt = 1
    for r, n in enumerate(need):
        tbl[r, :n] = np.arange(nxt, nxt + n)
        nxt += n
    return kp, vp, tbl, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("arch", ZOO)
def test_torch_zoo_paged_triple_matches_jax(arch):
    """The paged triple on the same weights and pools: prefill KV, state
    (whisper's cross K/V) and logits, then one ragged decode step's logits,
    slabs and state."""
    jc, tc, jparams, tparams = _pair(arch)
    (jspec_fn, jpre, jdec), (spec_fn, pre, dec) = jax_paged_surface(jc), paged_surface(tc)
    spec, jspec = spec_fn(tc), jspec_fn(jc)
    assert (spec.layers, spec.page_size, spec.kv_heads, spec.head_dim, spec.page_bytes) == (
        jspec.layers, jspec.page_size, jspec.kv_heads, jspec.head_dim, jspec.page_bytes)
    rng = np.random.default_rng(11)
    b = _batch(tc, 2, 13, seed=11)
    ex = {k: v for k, v in b.items() if k != "tokens"} or None
    jk, jv, jstate, jlogits = jpre(jc, jparams, jnp.asarray(b["tokens"]),
                                  None if ex is None else jax.tree.map(jnp.asarray, ex))
    k, v, state, logits = pre(tc, tparams, torch.from_numpy(b["tokens"]),
                              None if ex is None else {n: torch.from_numpy(x) for n, x in ex.items()})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), **TOL)
    assert (state is None) == (jstate is None) == (tc.family != "encdec")
    for n in state or {}:
        np.testing.assert_allclose(state[n].numpy(), np.asarray(jstate[n]), **TOL)

    lengths = [16, 9]  # a row on a page boundary and one inside a page
    kp, vp, tbl, lens = _pool(spec, rng, lengths)
    tok = rng.integers(1, tc.vocab_size, size=(2,), dtype=np.int32)
    jst = None if jstate is None else jax.tree.map(jnp.asarray, jstate)
    jkp2, jvp2, jst2, jl2 = jdec(jc, jparams, jnp.asarray(kp), jnp.asarray(vp), jst,
                                 *map(jnp.asarray, (tok, lens, tbl, lens)))
    tkp, tvp = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    st = None if state is None else {n: t.clone() for n, t in state.items()}
    kp2, vp2, st2, l2 = dec(tc, tparams, tkp, tvp, st, *map(torch.from_numpy, (tok, lens, tbl, lens)))
    assert kp2 is tkp and vp2 is tvp  # the slabs are updated in place
    np.testing.assert_allclose(l2.numpy(), np.asarray(jl2), **TOL)
    np.testing.assert_allclose(kp2.numpy(), np.asarray(jkp2), **TOL)
    np.testing.assert_allclose(vp2.numpy(), np.asarray(jvp2), **TOL)
    for n in st2 or {}:
        np.testing.assert_allclose(st2[n].numpy(), np.asarray(jst2[n]), **TOL)


# ---------------------------------------------------------------------------
# the MoE block
# ---------------------------------------------------------------------------


def _margins(probs, k):
    top = -np.sort(-probs, axis=-1)
    return top[:, k - 1] - top[:, k]


@pytest.mark.parametrize("T,D,E,k", [(64, 64, 8, 2), (256, 128, 60, 4), (96, 32, 16, 2)])
def test_torch_route_matches_reference(T, D, E, k):
    """Indices equal to ``jax.lax.top_k``'s wherever the k-th and (k+1)-th
    probabilities differ by more than f32 summation noise (1e-6); a
    decision closer than that is a named near-tie, and these seeds have
    none.  Weights and the aux loss within 1e-6."""
    rng = np.random.default_rng(T + E)
    x = rng.normal(size=(T, D)).astype(np.float32)
    wr = (rng.normal(size=(D, E)) * 0.3).astype(np.float32)
    jw, ji, jaux = jax_moe.route(jnp.asarray(x), jnp.asarray(wr), k, True)
    tw, ti, taux = moe.route(torch.from_numpy(x), torch.from_numpy(wr), k, True)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(wr), axis=-1))
    near = np.flatnonzero(_margins(probs, k) < 1e-6)
    assert near.size == 0, f"near-ties at tokens {near.tolist()}"
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6, atol=1e-6)


def test_torch_route_breaks_exact_ties_as_jax():
    """Experts with equal router columns tie exactly: the lower index
    ranks first, as ``jax.lax.top_k`` ranks it (``torch.topk`` promises no
    order)."""
    rng = np.random.default_rng(5)
    # small integers over powers of two: every product and sum is exact in
    # f32, in any order, so equal columns give equal logits
    x = rng.integers(-3, 4, size=(32, 16)).astype(np.float32)
    col = rng.integers(-2, 3, size=(16, 1)).astype(np.float32) / 8
    other = rng.integers(-1, 2, size=(16, 2)).astype(np.float32) / 64
    wr = np.concatenate([col / 4, col, other, col, col], axis=1)  # experts 1, 4 and 5 tie
    jw, ji, _ = jax_moe.route(jnp.asarray(x), jnp.asarray(wr), 2, False)
    tw, ti, _ = moe.route(torch.from_numpy(x), torch.from_numpy(wr), 2, False)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-6)  # softmax's ulps
    ties = (np.asarray(ji) == [1, 4]).all(axis=1)
    assert ties.sum() > 0  # the tie is taken, lower index first


@pytest.mark.parametrize("groups", [None, 3])
def test_torch_moe_block_matches_reference_with_drops(groups):
    """qwen2-moe's smoke block (8 experts top-2, a shared expert) on 3 rows
    of 20 tokens, globally and per row: capacity drops happen (asserted
    from the routing) and the outputs and aux loss agree within TOL."""
    jc, tc, jparams, tparams = _pair("qwen2-moe-a2.7b")
    jp = jax.tree.map(lambda a: a[0], jparams["layers"]["moe"])
    tp = layers.tree_map(lambda t: t[0], tparams["layers"]["moe"])
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(3, 20, tc.d_model)) + rng.normal(size=(1, 1, tc.d_model)) * 2)
    x = x.astype(np.float32)  # a shared offset crowds the same experts: drops
    jy, jaux = jax_moe.moe_block(jc, jp, jnp.asarray(x), groups=groups)
    ty, taux = moe.moe_block(tc, tp, torch.from_numpy(x), groups=groups)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    # the drops, counted as moe_block counts them
    e = tc.moe
    G = 1 if groups is None else groups
    _, idx, _ = moe.route(torch.from_numpy(x).reshape(-1, tc.d_model), tp["router"], e.top_k, True)
    ef = idx.reshape(G, -1).numpy()
    cap = max(int(moe.CAPACITY_FACTOR * e.top_k * (60 // G) / e.num_experts), e.top_k)
    counts = np.stack([np.bincount(r, minlength=e.num_experts) for r in ef])
    assert (counts > cap).any(), f"no drops at capacity {cap}: {counts}"


def test_torch_moe_block_has_no_host_sync_or_data_shapes():
    """What lets a paged decode step be captured into a CUDA graph: no
    boolean-mask indexing, ``nonzero``, ``.item()`` or host read in the
    block's source, and its outputs' shapes do not depend on the routing."""
    import inspect

    src = inspect.getsource(moe.moe_block) + inspect.getsource(moe.route)
    for bad in (".item(", "nonzero", ".cpu(", ".tolist(", ".numpy(", "masked_select"):
        assert bad not in src, bad
    _, tc, _, tparams = _pair("qwen2-moe-a2.7b")
    tp = layers.tree_map(lambda t: t[0], tparams["layers"]["moe"])
    for seed in range(3):
        x = torch.from_numpy(np.random.default_rng(seed).normal(size=(4, 1, tc.d_model)) * 3).float()
        y, aux = moe.moe_block(tc, tp, x, groups=4)
        assert y.shape == x.shape and aux.shape == ()


# ---------------------------------------------------------------------------
# layers: M-RoPE, softcap, the flash route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sections,rot", [((4, 2, 2), 16), ((16, 24, 24), 128)])
def test_torch_mrope_angles_match_reference(sections, rot):
    pos = np.random.default_rng(6).integers(0, 3000, size=(3, 2, 17)).astype(np.int32)
    jc, js = jax_layers.rope_angles(jnp.asarray(pos), rot, 1_000_000.0, sections)
    tc_, ts = layers.rope_angles(torch.from_numpy(pos), rot, 1_000_000.0, sections)
    assert tc_.shape == (2, 17, rot)
    np.testing.assert_allclose(tc_.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)
    with pytest.raises(AssertionError, match="mrope needs"):
        layers.rope_angles(torch.from_numpy(pos[0]), rot, 1e6, sections)
    with pytest.raises(AssertionError):
        layers.rope_angles(torch.from_numpy(pos), rot + 2, 1e6, sections)


@pytest.mark.parametrize("causal,q_block", [(True, None), (True, 8), (False, None)])
def test_torch_softcap_attention_matches_reference(causal, q_block):
    rng = np.random.default_rng(7)
    q = (rng.normal(size=(2, 20, 4, 16)) * 4).astype(np.float32)  # scores well past the cap
    k, v = (rng.normal(size=(2, 20, 2, 16)).astype(np.float32) for _ in range(2))
    want = jax_layers.attention(*map(jnp.asarray, (q, k, v)), causal=causal, softcap=5.0,
                                q_block=q_block)
    got = layers.attention(*map(torch.from_numpy, (q, k, v)), causal=causal, softcap=5.0,
                           q_block=q_block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    plain = layers.attention(*map(torch.from_numpy, (q, k, v)), causal=causal)
    assert not torch.allclose(got, plain, atol=1e-3)  # the cap changed the result


def test_torch_softcap_model_matches_reference():
    """A smoke config with a logit softcap (no zoo config sets one): the
    forward on the plain path, as ``impl="auto"`` takes for a softcap."""
    jc = dataclasses.replace(jcfg.smoke(jcfg.get_config("olmo-1b")), attn_logit_softcap=2.0)
    tc = dataclasses.replace(tcfg.smoke(tcfg.get_config("olmo-1b")), attn_logit_softcap=2.0)
    jparams = jax_get_model(jc).init(jc, jax.random.key(0))
    tparams = params_from_numpy(tc, jax.tree.map(np.asarray, jparams), device="cpu")
    toks = np.random.default_rng(8).integers(0, tc.vocab_size, size=(2, 30), dtype=np.int32)
    jl, _ = jax_get_model(jc).forward(jc, jparams, {"tokens": jnp.asarray(toks)}, q_block=8)
    tl, _ = get_model(tc).forward(tc, tparams, {"tokens": torch.from_numpy(toks)}, q_block=8)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_torch_attention_flash_route_rules():
    """Which calls ``impl="auto"`` sends to the flash kernel on a CUDA
    tensor: self-attention from position 0 with Sq == Skv, causal or not;
    never a softcap, a valid length, an offset or a cross length.  Checked
    on CPU tensors that report ``is_cuda``, with the kernel replaced."""
    called = []

    def fake_flash(q, k, v, *, causal):
        called.append(causal)
        return torch.empty_like(q)

    class Cuda(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    def qkv(sq, skv):
        return [torch.zeros(1, s, 2, 16).as_subclass(Cuda) for s in (sq, skv, skv)]

    orig = layers.flash_attention
    layers.flash_attention = fake_flash
    try:
        layers.attention(*qkv(8, 8), causal=False)
        layers.attention(*qkv(8, 8), causal=True)
        assert called == [False, True]
        for kw in (dict(softcap=3.0), dict(valid_len=4), dict(q_offset=2), dict(impl="ref")):
            layers.attention(*qkv(8, 8), causal=False, **kw)
        layers.attention(*qkv(4, 8), causal=False)  # cross-attention
        assert called == [False, True]
    finally:
        layers.flash_attention = orig


# ---------------------------------------------------------------------------
# make_batch, the param trees, extras through the engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ZOO)
def test_torch_make_batch_bit_equal_to_reference(arch, kind):
    jc, tc = jcfg.smoke(jcfg.get_config(arch)), tcfg.smoke(tcfg.get_config(arch))
    want = jax_make_batch(jc, JaxShape("t", 12, 3, kind), seed=5)
    got = make_batch(tc, ShapeConfig("t", 12, 3, kind), seed=5, device="cpu")
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = np.asarray(w)
        g = got[k]
        assert tuple(g.shape) == w.shape, k
        if g.dtype == torch.bfloat16:
            assert str(w.dtype) == "bfloat16", k
            np.testing.assert_array_equal(g.view(torch.int16).numpy(), w.view(np.int16), err_msg=k)
        else:
            assert g.dtype == torch.int32 and w.dtype == np.int32, k
            np.testing.assert_array_equal(g.numpy(), w, err_msg=k)


@pytest.mark.parametrize("arch", ZOO)
def test_torch_zoo_init_tree_matches_reference(arch):
    """``init``'s names, shapes and order are the JAX tree's (whisper's
    layer lists included); the router stays f32 in a bf16 init."""
    jc, tc = jcfg.smoke(jcfg.get_config(arch)), tcfg.smoke(tcfg.get_config(arch))
    jparams = jax.tree.map(np.asarray, jax_get_model(jc).init(jc, jax.random.key(0), jnp.bfloat16))
    tparams = get_model(tc).init(tc, generator=torch.Generator().manual_seed(0), device="cpu",
                                 dtype=torch.bfloat16)
    jleaves = jax.tree_util.tree_leaves_with_path(jparams)
    tleaves = jax.tree_util.tree_leaves_with_path(layers.tree_map(lambda t: t, tparams))
    assert [p for p, _ in jleaves] == [p for p, _ in tleaves]
    for (path, j), (_, t) in zip(jleaves, tleaves):
        assert j.shape == tuple(t.shape), path
        assert str(j.dtype) == str(t.dtype).split(".")[-1], path


@pytest.fixture()
def two_devices(monkeypatch):
    """Two logical CPU devices; the device cache is dropped afterwards, so
    no later test sees a split device."""
    monkeypatch.setenv("REPRO_LOGICAL_DEVICES", "2")
    yield get_all_devices(platform="cpu").get()
    reset_runtime()


def test_torch_state_of_whisper_size_spills_refetches_and_migrates(two_devices):
    """A sequence whose resident state is whisper-tiny's cross K/V at full
    size (2 x 4 layers x 1500 frames x 6 heads x 64, f32: 18.4 MB) spills
    to host memory and back, and migrates between logical devices, bit for
    bit, its bytes declared to AGAS."""
    from repro_torch.core import agas
    from repro_torch.serving import PagedKVCache

    devs = two_devices
    cfg = tcfg.get_config("whisper-tiny")
    spec = get_model(cfg).paged_spec(cfg)
    kv = PagedKVCache(spec, devices=devs[:2], pool_pages=8)
    seq = kv.new_seq(devs[0])
    shape = (cfg.num_layers, cfg.encdec.encoder_seq, cfg.num_kv_heads, cfg.hd)
    g = torch.Generator().manual_seed(0)
    state = {n: torch.randn(shape, generator=g) for n in ("cross_k", "cross_v")}
    k = torch.randn((spec.layers, 20, spec.kv_heads, spec.head_dim), generator=g)
    kv.append(seq, k, -k)
    seq.set_state({n: t.clone() for n, t in state.items()})
    state_bytes = sum(t.numel() * 4 for t in state.values())
    assert state_bytes == 18_432_000 and seq.nbytes >= state_bytes
    assert agas.registry.resident_bytes(devs[0].key) >= state_bytes
    seq.spill().get()
    assert seq.spilled and seq.nbytes < state_bytes  # the state left the device's bytes
    seq.ensure_resident()
    for n in state:
        assert torch.equal(seq.state[n], state[n])
    kv.migrate(seq, devs[1])
    assert seq.device is devs[1] and agas.registry.resident_bytes(devs[1].key) >= state_bytes
    for n in state:
        assert torch.equal(seq.state[n], state[n])
    kv.free_seq(seq)


# ---------------------------------------------------------------------------
# the smoke's new phases, rehearsed on the CPU at smoke size
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke():
    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture()
def small(smoke, monkeypatch):
    monkeypatch.setattr(smoke, "get_config", lambda name: tcfg.smoke(tcfg.get_config(name)))
    monkeypatch.setattr(smoke, "SERVE_BATCH", 2)
    monkeypatch.setattr(smoke, "SERVE_NEW", 4)
    monkeypatch.setattr(smoke, "SERVE_PROMPTS", (12, 20))
    monkeypatch.setattr(smoke, "PAGED_WARMUP", 4)
    monkeypatch.setattr(smoke, "ENCDEC_PROMPTS", (6, 10))
    monkeypatch.setattr(smoke, "ENCDEC_NEW", 5)
    failed = []
    monkeypatch.setattr(smoke, "require", lambda ok, msg: ok or failed.append(msg))
    return smoke, get_all_devices(platform="cpu").get()[0], failed


def test_torch_smoke_serve_moe_phase_rehearsed_on_cpu(small):
    """``phase_serve_moe`` at smoke size: the routing recorded, replayed and
    compared; every check passes but the flash launch counts."""
    smoke, dev, failed = small
    out = smoke.phase_serve_moe(dev)
    assert failed and all("launched" in m for m in failed)
    assert out["routing"]["decisions"] == 2 * (2 * 12 + 2 * 20) + 2 * 2 * 2 * 4  # prefill + steps
    assert out["routing"]["differing_decisions"] == 0  # the CPU's two runs are the same math
    for g in out["groups"]:
        assert g["max_abs_logit_err_pinned"] == 0 and g["near_tie_cuts_pinned"] == 0
        assert g["bf16_tokens_equal_f32"] <= g["tokens"] == 2 * 5
    assert smoke.moe_model.route is moe.route  # the wrapper is gone


def test_torch_smoke_route_log_replays_and_counts_flips(smoke):
    """``RouteLog`` replays a recorded run's indices (weights and aux as
    ``route`` gives them for those indices) and ``route_flips`` finds a
    decision that changed, with the router margin of the other run."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.normal(size=(10, 16)).astype(np.float32))
    wr = torch.from_numpy(rng.normal(size=(16, 6)).astype(np.float32))
    with smoke.RouteLog() as log:
        log.start("record")
        w, idx, aux = moe.route(x, wr, 2, True)
        rec = log.calls
        log.start("replay", rec)
        w2, idx2, aux2 = moe.route(x, wr, 2, True)
        log.start("record")
        moe.route(x, wr * 1.01, 2, True)
        other = log.calls
    assert torch.equal(idx2, idx) and torch.allclose(w2, w) and torch.allclose(aux2, aux)
    assert moe.route(x, wr, 2, True)[1].shape == (10, 2)
    flips = smoke.route_flips(rec, rec, 2)
    assert flips == []
    changed = {None: [(rec[None][0][0].flip(0), rec[None][0][1])]}
    flips = smoke.route_flips(rec, changed, 2)
    assert flips and all(f["step"] == 0 and f["layer"] == 0 for f in flips)
    assert smoke.first_flips(flips) == {None: flips}
    assert other[None][0][1].shape == (10,) and (other[None][0][1] >= 0).all()


def test_torch_smoke_serve_paged_moe_phase_rehearsed_on_cpu(small):
    smoke, dev, failed = small
    out = smoke.phase_serve_paged_moe(dev)
    launch_checks = [m for m in failed if "launched" in m]
    assert failed == launch_checks and len(launch_checks) == 2  # paged_attention, flash
    assert out["requests"] == 4 and out["requests_differing_kernel_vs_plain"] == 0
    assert out["launches"]["ref"] == {"paged_attention": 0, "flash_attention": 0}


def test_torch_smoke_serve_paged_encdec_phase_rehearsed_on_cpu(small):
    smoke, dev, failed = small
    out = smoke.phase_serve_paged_encdec(dev)
    launch_checks = [m for m in failed if "launched" in m]
    assert failed == launch_checks and len(launch_checks) == 2
    assert out["requests"] == 4 and out["new_tokens"] == 5
    assert out["auto"]["near_tie_cuts_vs_oracle"] <= 4
    assert out["state_bytes_per_request"] == 2 * 2 * 24 * 64 * 4  # smoke: 2 layers, 24 frames


def test_torch_smoke_serve_paged_moe_explains_a_difference(small, monkeypatch):
    """A request whose kernel-run tokens differ from the plain run's is run
    again alone both ways with its routing recorded; with neither a logit
    nor a router near-tie behind it the phase fails, naming the request."""
    smoke, dev, failed = small
    runs_fn = smoke.paged_phase_runs

    def altered(*args, **kwargs):
        out, runs = runs_fn(*args, **kwargs)
        toks = runs["auto"]["tokens"]
        toks[1, 3:] = (toks[1, 3:] + 1) % 256  # request 1 differs from its fourth token
        return out, runs

    monkeypatch.setattr(smoke, "paged_phase_runs", altered)
    out = smoke.phase_serve_paged_moe(dev)
    (case,) = out["explained"]
    assert case["request"] == 1 and case["first_differing_token"] == 3
    assert case["flips"] == 0 and not case["alone_tokens_differ"]  # the CPU's two ways agree
    assert case["logit_near_tie"] == (case["plain_gap_there"] < smoke.NEAR_TIE)
    assert not case["router_near_tie"]
    assert any("request 1 decodes other tokens" in m for m in failed) != case["logit_near_tie"]


def test_torch_reset_launch_counts_zeroes_the_noncausal_count():
    """The flash wrapper counts its non-causal launches apart (the smoke
    holds whisper's encoder to them); ``reset_launch_counts`` zeroes that
    count with the others."""
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    flash_kernel.launches, flash_kernel.noncausal_launches = 7, 3
    reset_launch_counts()
    assert flash_kernel.launches == 0 and flash_kernel.noncausal_launches == 0


def test_torch_smoke_checks_paged_attention_at_whisper_decode_shape(smoke, monkeypatch):
    """The smoke's kernel checks hold paged_attention at serve_paged_encdec's
    decode geometry: 8 rows of whisper-tiny's 6 heads of 64, lengths
    across the decode of the 64- and 256-token prompts, 18 pages a row."""
    seen = {}
    monkeypatch.setattr(smoke, "paged_entry",
                        lambda name, shape, lengths, launches, device: seen.update(
                            name=name, shape=shape, lengths=lengths, launches=launches))
    smoke.check_paged_encdec(136, "cpu")
    assert seen["name"] == "paged_attention_encdec" and seen["launches"] == 136
    assert seen["shape"] == (8, 6, 6, 64, 16, 18)
    assert seen["lengths"] == [64, 74, 84, 95, 256, 266, 276, 287]
