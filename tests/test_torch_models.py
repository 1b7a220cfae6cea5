"""The port's dense transformer held against the JAX package's.

For the smoke configs of olmo-1b (non-parametric LayerNorm, tied
embeddings), stablelm-1.6b (LayerNorm with bias, qkv bias, partial rotary)
and deepseek-67b (RMSNorm, GQA: 4 heads over 2 kv heads), the JAX params
(``init(cfg, jax.random.key(0))``) are carried across with
``params_from_numpy`` and both packages run the same tokens.  All in f32
on the CPU.  Tolerance 1e-4 (absolute and relative) on logits and KV: both
compute the same f32 operations, summed in other orders by XLA and by
PyTorch's CPU kernels, which moves logits of order 1 by about 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfg
from repro.models import get_model as jax_get_model
from repro.models import layers as jax_layers
from repro_torch import configs as tcfg
from repro_torch.models import get_model, layers
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_numpy

ARCHS = ["olmo-1b", "stablelm-1.6b", "deepseek-67b"]
TOL = dict(rtol=1e-4, atol=1e-4)


def _pair(arch):
    jc = jcfg.smoke(jcfg.get_config(arch))
    tc = tcfg.smoke(tcfg.get_config(arch))
    jparams = jax_get_model(jc).init(jc, jax.random.key(0))
    tparams = params_from_numpy(tc, jax.tree.map(np.asarray, jparams), device="cpu")
    return jc, tc, jparams, tparams


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(B, S), dtype=np.int32)


@pytest.mark.parametrize("arch", ARCHS + ["starcoder2-7b", "qwen2-moe", "mamba2-130m", "phi3.5-moe",
                                  "qwen2-vl-72b", "whisper-tiny", "hymba-1.5b"])
def test_torch_configs_match_reference(arch):
    assert dataclasses.asdict(tcfg.get_config(arch)) == dataclasses.asdict(jcfg.get_config(arch))
    assert (dataclasses.asdict(tcfg.smoke(tcfg.get_config(arch)))
            == dataclasses.asdict(jcfg.smoke(jcfg.get_config(arch))))
    assert tcfg.get_config(arch).param_count() == jcfg.get_config(arch).param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_torch_forward_and_kv_match_reference(arch):
    jc, tc, jparams, tparams = _pair(arch)
    toks = _tokens(tc, 2, 40, seed=1)
    jl, _aux, jkv = jax_get_model(jc).forward(jc, jparams, {"tokens": jnp.asarray(toks)},
                                              q_block=16, return_kv=True)
    tl, aux, tkv = get_model(tc).forward(tc, tparams, {"tokens": torch.from_numpy(toks)},
                                         q_block=16, return_kv=True)
    assert tl.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for name in ("k", "v"):
        assert tkv[name].shape == jkv[name].shape  # (L, B, S, K, hd)
        np.testing.assert_allclose(tkv[name].numpy(), np.asarray(jkv[name]), **TOL)
    # last_only keeps the final position, q_block does not change the math
    tlast, _ = get_model(tc).forward(tc, tparams, {"tokens": torch.from_numpy(toks)},
                                     q_block=None, last_only=True)
    np.testing.assert_allclose(tlast.numpy(), tl[:, -1:].numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_torch_decode_steps_match_reference(arch):
    jc, tc, jparams, tparams = _pair(arch)
    B, prompt, steps = 2, 6, 8
    toks = _tokens(tc, B, prompt + steps, seed=2)
    jm, tm = jax_get_model(jc), get_model(tc)
    jcache = jm.init_cache(jc, B, prompt + steps, dtype=jnp.float32)
    tcache = tm.init_cache(tc, B, prompt + steps, dtype=torch.float32, device="cpu")
    for pos in range(prompt + steps):  # teacher-forced decode over the whole sequence
        jl, jcache = jm.decode_step(jc, jparams, jcache, jnp.asarray(toks[:, pos:pos + 1]),
                                    jnp.int32(pos))
        tl, tcache = tm.decode_step(tc, tparams, tcache, torch.from_numpy(toks[:, pos:pos + 1]), pos)
        assert tl.shape == (B, 1, tc.vocab_size)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]), **TOL)


@pytest.mark.parametrize("arch", ARCHS + ["qwen2-moe-a2.7b", "phi3.5-moe", "starcoder2-7b",
                                  "qwen2-vl-72b", "whisper-tiny"])
def test_torch_init_matches_reference_tree_and_scale(arch):
    jc, tc = jcfg.smoke(jcfg.get_config(arch)), tcfg.smoke(tcfg.get_config(arch))
    jparams = jax.tree.map(np.asarray, jax_get_model(jc).init(jc, jax.random.key(0)))
    tparams = get_model(tc).init(tc, generator=torch.Generator().manual_seed(0), device="cpu")
    jleaves = jax.tree_util.tree_leaves_with_path(jparams)
    tleaves = jax.tree_util.tree_leaves_with_path(T.tree_map(lambda t: t.numpy(), tparams))
    assert [p for p, _ in jleaves] == [p for p, _ in tleaves]  # same names, same order
    for (path, j), (_, t) in zip(jleaves, tleaves):
        assert j.shape == t.shape and t.dtype == np.float32, path
        if j.std() == 0:  # norm scales and biases: exactly the constants
            np.testing.assert_array_equal(t, j)
        else:  # truncated-normal weights: the same spread as ninit's
            assert abs(t.std() / j.std() - 1) < 0.10, path
            assert np.abs(t).max() <= 1.05 * np.abs(j).max(), path  # truncated at 2 sigma


def test_torch_convert_refuses_a_wrong_tree():
    jc, tc = jcfg.smoke(jcfg.get_config("olmo-1b")), tcfg.smoke(tcfg.get_config("olmo-1b"))
    tree = jax.tree.map(np.asarray, jax_get_model(jc).init(jc, jax.random.key(0)))
    bad = dict(tree, embed={"table": tree["embed"]["table"][:, :8]})
    with pytest.raises(ValueError, match="expected shape"):
        params_from_numpy(tc, bad, device="cpu")
    with pytest.raises(KeyError, match="expected keys"):
        params_from_numpy(tc, dict(tree, extra={}), device="cpu")


@pytest.mark.parametrize("mlp_type", ["swiglu", "geglu", "gelu_mlp"])
def test_torch_mlp_matches_reference(mlp_type):
    jc = dataclasses.replace(jcfg.smoke(jcfg.get_config("starcoder2-7b")), mlp_type=mlp_type)
    tc = tcfg.smoke(tcfg.get_config("olmo-1b"))
    tc = dataclasses.replace(tc, mlp_type=mlp_type, mlp_bias=True, d_ff=jc.d_ff)
    p = jax.tree.map(np.asarray, jax_layers.init_mlp(jc, jax.random.key(3), jnp.float32))
    rng = np.random.default_rng(3)
    p = {k: v + 0.1 * rng.standard_normal(v.shape).astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((2, 5, jc.d_model)).astype(np.float32)
    want = jax_layers.mlp(jc, p, jnp.asarray(x))
    got = layers.mlp(tc, {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("norm_type", ["rmsnorm", "layernorm", "layernorm_nobias",
                                       "nonparam_layernorm"])
def test_torch_norms_match_reference(norm_type):
    jc = dataclasses.replace(jcfg.smoke(jcfg.get_config("olmo-1b")), norm_type=norm_type)
    tc = dataclasses.replace(tcfg.smoke(tcfg.get_config("olmo-1b")), norm_type=norm_type)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3, jc.d_model)).astype(np.float32) * 3 + 1
    p = {"scale": rng.standard_normal(jc.d_model).astype(np.float32),
         "bias": rng.standard_normal(jc.d_model).astype(np.float32)}
    want = jax_layers.apply_norm(jc, jnp.asarray(x), p)
    got = layers.apply_norm(tc, torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("q_offset,valid_len,q_block", [(0, None, None), (0, None, 8),
                                                        (5, None, 4), (7, 8, None)])
def test_torch_plain_attention_matches_reference(q_offset, valid_len, q_block):
    rng = np.random.default_rng(5)
    Sq = 1 if valid_len is not None else 20
    q = rng.standard_normal((2, Sq, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 24, 2, 16)).astype(np.float32) for _ in range(2))
    want = jax_layers.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                                q_offset=q_offset, valid_len=valid_len, q_block=q_block)
    got = layers.attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=True,
                           q_offset=q_offset, valid_len=valid_len, q_block=q_block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_torch_model_refuses_unported_parts():
    """Nothing of the model zoo is refused any more: sliding windows, the
    hybrid family and hymba-1.5b's config (``tests/test_torch_hybrid.py``),
    the softcap, the vision stub and M-RoPE (``tests/test_torch_zoo.py``)
    all load; an unknown arch and an unknown ``impl`` are still refused."""
    from repro_torch.models import hybrid

    base = tcfg.smoke(tcfg.get_config("olmo-1b"))
    gen = torch.Generator().manual_seed(0)
    windowed = dataclasses.replace(base, sliding_window=16)
    params = T.init(windowed, generator=gen, device="cpu")
    logits, _ = T.forward(windowed, params, {"tokens": torch.zeros((1, 32), dtype=torch.int32)})
    assert logits.shape == (1, 32, base.vocab_size) and bool(torch.isfinite(logits).all())
    assert get_model(dataclasses.replace(base, family="hybrid")) is hybrid
    assert tcfg.get_config("hymba-1.5b").family == "hybrid"
    assert tcfg.get_config("hymba") is tcfg.get_config("hymba-1.5b")
    with pytest.raises(KeyError, match="unknown arch"):
        tcfg.get_config("hymba-2b")
    for change in (dict(attn_logit_softcap=30.0), dict(vision_stub=True, num_patches=4),
                   dict(rope_type="mrope", mrope_sections=(4, 2, 2))):
        T.init(dataclasses.replace(base, **change), generator=gen, device="cpu")
    with pytest.raises(ValueError, match="impl="):
        layers.attention(*(torch.zeros(1, 4, 2, 16) for _ in range(3)), impl="cuda")
