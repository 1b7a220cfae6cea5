"""The serve flow that ``chip_smoke.py`` drives on the card, run here on the
CPU device at smoke size and held against the JAX package's serving steps.

Two groups of requests (prompts of 12 and 20 tokens, 2 requests each), each
one future on its own port ``Stream``: ``make_prefill``, then 6 greedy
``make_serve_step`` calls from its cache (dense: the KV written into an
``init_cache`` of prompt + 6 slots; mamba2: the prefill's recurrent
cache).  The JAX side runs, on the same tokens and the same weights (the
JAX init carried across with ``params_from_numpy``),
``repro.serving.serve_step``'s ``make_prefill`` and ``make_serve_step``
for the dense archs, and for mamba2 the package's own greedy oracle
(``tests/test_paged_models.py``): ``paged_prefill``, then ``decode_step``
from its state, since the reference ``make_prefill`` hands mamba2 a zero
cache.  The prefill logits agree within 1e-4 (f32 on both sides, summed
in other orders) and the greedy tokens are identical.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfg
from repro.models import get_model as jax_get_model
from repro.serving.serve_step import make_prefill as jax_make_prefill
from repro.serving.serve_step import make_serve_step as jax_make_serve_step
from repro_torch import configs as tcfg
from repro_torch.core import get_all_devices
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.models import get_model
from repro_torch.models.convert import params_from_numpy

ROOT = os.path.join(os.path.dirname(__file__), "..")
PROMPTS, BATCH, NEW = (12, 20), 2, 6


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def device():
    return get_all_devices(platform="cpu").get()[0]


def _jax_serve(cfg, params, prompt):
    """Prefill, its decode cache, NEW greedy steps, in JAX."""
    B, S = prompt.shape
    m = jax_get_model(cfg)
    if cfg.family == "ssm":  # the real prompt state, layer-major
        _k, _v, state, last = m.paged_prefill(cfg, params, jnp.asarray(prompt))
        logits = last[:, None]
        cache = {n: jnp.moveaxis(state[n], 0, 1) for n in ("state", "conv")}
    else:
        logits, kv = jax_make_prefill(cfg)(params, {"tokens": jnp.asarray(prompt)})
        cache = m.init_cache(cfg, B, S + NEW, dtype=jnp.float32)
        cache = {n: cache[n].at[:, :, :S].set(kv[n]) for n in ("k", "v")}
    step = jax.jit(jax_make_serve_step(cfg))
    tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    toks = [tok]
    for i in range(NEW):
        tok, _logits, cache = step(params, cache, tok, jnp.int32(S + i))
        toks.append(tok)
    return np.asarray(logits[:, -1]), np.concatenate([np.asarray(t) for t in toks], axis=1)


@pytest.mark.parametrize("arch", ["olmo-1b", "deepseek-67b", "mamba2-130m"])
def test_torch_serve_flow_matches_reference(smoke, device, arch):
    jc = jcfg.smoke(jcfg.get_config(arch))
    tc = tcfg.smoke(tcfg.get_config(arch))
    jparams = jax_get_model(jc).init(jc, jax.random.key(0))
    tparams = params_from_numpy(tc, jax.tree.map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tc.vocab_size, size=(BATCH, s), dtype=np.int32) for s in PROMPTS]
    streams = [device.create_stream() for _ in prompts]
    reset_launch_counts()
    got = smoke.serve_flow(device, tc, tparams, prompts, streams, NEW)
    assert launch_counts()["flash_attention"] == launch_counts()["ssd_scan"] == 0  # CPU: plain
    for g, prompt in zip(got, prompts):
        want_logits, want_tokens = _jax_serve(jc, jparams, prompt)
        assert g["on_stream"] and g["tokens"].shape == (BATCH, NEW + 1)
        assert g["gaps"].shape == (BATCH, NEW + 1) and (g["gaps"] >= 0).all()
        np.testing.assert_allclose(g["logits_last"], want_logits, rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(g["tokens"], want_tokens)
        assert smoke.greedy_cuts(g["tokens"], want_tokens, np.ones_like(g["gaps"])) == (0, 0)
        assert g["prefill_s"] > 0 and g["decode_ms_per_step"] > 0


def test_torch_serve_flow_plain_attention_is_the_same_math_on_cpu(smoke, device):
    tc = tcfg.smoke(tcfg.get_config("olmo-1b"))
    params = get_model(tc).init(tc, generator=torch.Generator().manual_seed(1), device="cpu")
    prompts = [np.random.default_rng(1).integers(0, tc.vocab_size, size=(BATCH, 16), dtype=np.int32)]
    streams = [device.create_stream()]
    auto = smoke.serve_flow(device, tc, params, prompts, streams, 3, impl="auto")[0]
    ref = smoke.serve_flow(device, tc, params, prompts, streams, 3, impl="ref")[0]
    np.testing.assert_array_equal(auto["tokens"], ref["tokens"])
    np.testing.assert_array_equal(auto["logits_last"], ref["logits_last"])


def test_torch_greedy_cuts_stop_at_the_first_near_tie(smoke):
    want = np.array([[1, 2, 3], [1, 2, 3], [1, 2, 3]])
    got = np.array([[1, 2, 3], [1, 9, 3], [1, 2, 9]])
    gaps = np.array([[1.0, 1.0, 1.0], [1.0, 1.0, 1.0], [1.0, 1e-5, 1.0]])
    # row 1 differs at step 1; row 2 differs only after its near-tie at step 1
    assert smoke.greedy_cuts(got, want, gaps) == (1, 1)


def test_torch_smoke_attention_pairs_and_bf16_bound(smoke):
    assert smoke.attention_pairs(2, 3, 4, 4, False) == 2 * 3 * 16
    assert smoke.attention_pairs(1, 1, 4, 4, True) == 1 + 2 + 3 + 4
    assert smoke.attention_pairs(1, 1, 4, 2, True) == 1 + 2 + 2 + 2
    t, by = smoke.bound(1.0, 989e9, smoke.BF16_FLOP_PER_S)
    assert by == "operations" and t == pytest.approx(1.0)
