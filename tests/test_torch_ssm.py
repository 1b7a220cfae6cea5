"""The port's Mamba-2 model held against the JAX package's, on the CPU.

On mamba2-130m's smoke config (d_model 64, N 16, P 16, chunk 16, 2
layers), the JAX params (``init(cfg, jax.random.key(0))``) are carried
across with ``params_from_numpy``, and the same numpy inputs go through
both packages' ``ssm_block``, ``ssm_prefill``, ``ssm_decode_step``,
``forward`` and ``decode_step``.  The port's prefill cache is held against
the JAX ``paged_prefill`` state (moved to layer-major): the reference's
``forward(return_kv=True)`` returns an all-zero cache instead, which the
port does not copy.  All in f32; tolerance 1e-4 (the same operations,
summed in other orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfg
from repro.models import get_model as jax_get_model
from repro.models import ssm as jax_ssm
from repro.models import ssm_lm as jax_ssm_lm
from repro_torch import configs as tcfg
from repro_torch.models import get_model
from repro_torch.models import ssm as S
from repro_torch.models import ssm_lm
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.layers import tree_map

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def pair():
    jc = jcfg.smoke(jcfg.get_config("mamba2-130m"))
    tc = tcfg.smoke(tcfg.get_config("mamba2-130m"))
    jparams = jax_get_model(jc).init(jc, jax.random.key(0))
    tparams = params_from_numpy(tc, jax.tree.map(np.asarray, jparams), device="cpu")
    return jc, tc, jparams, tparams


def _layer0(jparams, tparams):
    return (jax.tree.map(lambda t: t[0], jparams["layers"]["ssm"]),
            {k: v[0] for k, v in tparams["layers"]["ssm"].items()})


def _x(cfg, B, S_, seed):
    return np.random.default_rng(seed).standard_normal((B, S_, cfg.d_model)).astype(np.float32)


def _tokens(cfg, B, S_, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(B, S_), dtype=np.int32)


def test_torch_ssm_config_and_family(pair):
    jc, tc, _, _ = pair
    full = tcfg.get_config("mamba2-130m")
    assert get_model(full) is ssm_lm and full.family == "ssm"
    assert (full.num_layers, full.d_model, full.vocab_size) == (24, 768, 50280)
    s = full.ssm
    assert (s.d_state, s.expand, s.head_dim, s.n_groups, s.d_conv, s.chunk) == (128, 2, 64, 1, 4, 256)
    assert s.n_heads(full.d_model) == 24 and s.d_inner(full.d_model) == 1536
    assert full.param_count() == 128_882_688
    assert ssm_lm.param_shapes(tc) == jax.tree.map(lambda a: tuple(a.shape),
                                                   jax_get_model(jc).init(jc, jax.random.key(0)))


def test_torch_ssm_block_matches_reference(pair):
    jc, tc, jparams, tparams = pair
    jp, tp = _layer0(jparams, tparams)
    x = _x(tc, 2, 40, seed=1)  # 40 = 2.5 chunks of 16: a ragged tail
    jy, jstate = jax_ssm.ssm_block(jc, jp, jnp.asarray(x), return_state=True)
    ty, tstate = S.ssm_block(tc, tp, torch.from_numpy(x), return_state=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(tstate.numpy(), np.asarray(jstate), **TOL)
    np.testing.assert_array_equal(S.ssm_block(tc, tp, torch.from_numpy(x)).numpy(), ty.numpy())


@pytest.mark.parametrize("S_", [2, 3, 40])  # shorter than the conv window, equal, longer
def test_torch_ssm_prefill_matches_reference(pair, S_):
    jc, tc, jparams, tparams = pair
    jp, tp = _layer0(jparams, tparams)
    x = _x(tc, 2, S_, seed=S_)
    jy, jcache = jax_ssm.ssm_prefill(jc, jp, jnp.asarray(x))
    ty, tcache = S.ssm_prefill(tc, tp, torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    for name in ("state", "conv"):
        assert tuple(tcache[name].shape) == jcache[name].shape, name
        np.testing.assert_allclose(tcache[name].numpy(), np.asarray(jcache[name]), **TOL)


def test_torch_ssm_decode_step_matches_reference(pair):
    jc, tc, jparams, tparams = pair
    jp, tp = _layer0(jparams, tparams)
    rng = np.random.default_rng(3)
    cache = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in S.init_ssm_cache(tc, 2, device="cpu").items()}
    x = _x(tc, 2, 1, seed=4)
    jy, jnew = jax_ssm.ssm_decode_step(jc, jp, jnp.asarray(x),
                                       {k: jnp.asarray(v) for k, v in cache.items()})
    ty, tnew = S.ssm_decode_step(tc, tp, torch.from_numpy(x),
                                 {k: torch.from_numpy(v) for k, v in cache.items()})
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    for name in ("state", "conv"):
        np.testing.assert_allclose(tnew[name].numpy(), np.asarray(jnew[name]), **TOL)


def test_torch_ssm_forward_matches_reference(pair):
    jc, tc, jparams, tparams = pair
    toks = _tokens(tc, 2, 40, seed=5)
    jl, _ = jax_ssm_lm.forward(jc, jparams, {"tokens": jnp.asarray(toks)})
    tl, aux = ssm_lm.forward(tc, tparams, {"tokens": torch.from_numpy(toks)})
    assert tl.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    tlast, _ = ssm_lm.forward(tc, tparams, {"tokens": torch.from_numpy(toks)}, last_only=True)
    np.testing.assert_allclose(tlast.numpy(), tl[:, -1:].numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("S_", [2, 37])
def test_torch_ssm_prefill_cache_matches_paged_prefill(pair, S_):
    """``forward(return_kv=True)``'s cache is the real prompt state: JAX
    ``paged_prefill``'s, batch-leading there, layer-major here."""
    jc, tc, jparams, tparams = pair
    toks = _tokens(tc, 2, S_, seed=6)
    _k, _v, jstate, jlast = jax_ssm_lm.paged_prefill(jc, jparams, jnp.asarray(toks))
    tl, _, cache = ssm_lm.forward(tc, tparams, {"tokens": torch.from_numpy(toks)},
                                  return_kv=True, last_only=True)
    np.testing.assert_allclose(tl[:, 0].numpy(), np.asarray(jlast), **TOL)
    for name in ("state", "conv"):
        want = np.moveaxis(np.asarray(jstate[name]), 0, 1)
        assert tuple(cache[name].shape) == want.shape, name
        np.testing.assert_allclose(cache[name].numpy(), want, **TOL)
    assert float(np.abs(want).max()) > 0  # not the reference forward's zero cache


def test_torch_ssm_decode_steps_match_reference(pair):
    """Prefill, then 6 teacher-forced decode steps: logits and the whole
    cache against JAX ``decode_step`` from the same prefill state."""
    jc, tc, jparams, tparams = pair
    toks = _tokens(tc, 2, 20 + 6, seed=7)
    _k, _v, jstate, _ = jax_ssm_lm.paged_prefill(jc, jparams, jnp.asarray(toks[:, :20]))
    jcache = {k: jnp.moveaxis(v, 0, 1) for k, v in jstate.items()}
    _, _, tcache = ssm_lm.forward(tc, tparams, {"tokens": torch.from_numpy(toks[:, :20])},
                                  return_kv=True, last_only=True)
    for pos in range(20, 26):
        jl, jcache = jax_ssm_lm.decode_step(jc, jparams, jcache, jnp.asarray(toks[:, pos:pos + 1]),
                                            jnp.int32(pos))
        tl, tcache = ssm_lm.decode_step(tc, tparams, tcache, torch.from_numpy(toks[:, pos:pos + 1]),
                                        pos)
        assert tl.shape == (2, 1, tc.vocab_size)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for name in ("state", "conv"):
        np.testing.assert_allclose(tcache[name].numpy(), np.asarray(jcache[name]), **TOL)


def test_torch_ssm_init_cache_matches_reference(pair):
    jc, tc, _, _ = pair
    jcache = jax_ssm_lm.init_cache(jc, 3, 10, dtype=jnp.float32)
    tcache = ssm_lm.init_cache(tc, 3, 10, device="cpu", dtype=torch.float32)
    for name in ("state", "conv"):
        assert tuple(tcache[name].shape) == jcache[name].shape
        assert tcache[name].dtype == torch.float32 and not tcache[name].any()
    assert ssm_lm.init_cache(tc, 1, 1, device="cpu")["state"].dtype == torch.float32


def test_torch_ssm_init_distributions(pair):
    """The port's own init: the reference's names and shapes; A = -(1..H),
    D = 1 and softplus(dt_bias) in [1e-3, 1e-1], all f32 even in bf16;
    the projections truncated normals with the reference's spread."""
    jc, tc, jparams, _ = pair
    H = tc.ssm.n_heads(tc.d_model)
    params = ssm_lm.init(tc, generator=torch.Generator().manual_seed(0), device="cpu",
                         dtype=torch.bfloat16)
    p = params["layers"]["ssm"]
    for name in ("A_log", "D", "dt_bias"):
        assert p[name].dtype == torch.float32, name
    assert p["w_z"].dtype == torch.bfloat16
    A = -torch.exp(p["A_log"])
    torch.testing.assert_close(A, -torch.arange(1, H + 1.0).expand(tc.num_layers, H))
    assert bool((p["D"] == 1).all())
    dt = torch.nn.functional.softplus(p["dt_bias"])
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5) and float(dt.max()) <= 1e-1 * (1 + 1e-5)
    jflat = dict(jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, jparams)))
    tflat = dict(jax.tree_util.tree_leaves_with_path(
        tree_map(lambda t: t.float().numpy(), params)))
    assert list(jflat) == list(tflat)  # same names, same order
    for path in ("w_z", "w_xbc", "w_out", "conv_w"):
        key = next(k for k in jflat if jax.tree_util.keystr(k).endswith(f"['{path}']"))
        j, t = jflat[key], tflat[key]
        assert abs(t.std() / j.std() - 1) < 0.10, path
        assert np.abs(t).max() <= 1.05 * np.abs(j).max(), path


def test_torch_ssm_refuses_a_bad_impl(pair):
    _, tc, _, tparams = pair
    with pytest.raises(ValueError, match="impl="):
        ssm_lm.forward(tc, tparams, {"tokens": torch.zeros(1, 4, dtype=torch.int64)}, impl="cuda")
