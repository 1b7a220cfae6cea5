"""The port's int8 stochastic-rounding gradient compression
(``repro_torch.training.grad_compression``) on the CPU: the port of
``tests/test_grad_compression.py`` (error within one quantization step,
unbiasedness, the property sweep, trees, zero gradients).  The rounding
bits come from a ``torch.Generator`` where the reference draws from
``jax.random``, so the port is held to the reference by statistics and by
its own bounds, and to itself bit for bit: the same generator state gives
the same int8 values.
"""
import numpy as np
import torch

try:
    from hypothesis import given, settings, strategies as st
except ModuleNotFoundError:  # minimal container: seeded fallback sweeps
    from _hypothesis_compat import given, settings, strategies as st

from repro_torch.pytree import tree_flatten
from repro_torch.training.grad_compression import (compress, compress_tree, decompress,
                                                   decompress_tree)


def _gen(seed: int) -> "torch.Generator":
    return torch.Generator().manual_seed(seed)


def test_torch_roundtrip_error_bounded_by_scale():
    g = torch.randn((1024,), generator=_gen(0)) * 3.0
    q, s = compress(g, _gen(1))
    err = (decompress(q, s) - g).abs()
    assert float(err.max()) <= float(s) + 1e-6  # one quantization step


def test_torch_stochastic_rounding_is_unbiased():
    g = torch.full((2000,), 0.3337)  # deliberately between grid points
    outs = []
    for i in range(50):
        q, s = compress(g, _gen(i))
        outs.append(decompress(q, s).numpy())
    mean = np.mean(outs)
    assert abs(mean - 0.3337) < 2e-4, mean


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 2**16), scale=st.floats(1e-3, 1e3))
def test_torch_compression_property(seed, scale):
    g = torch.randn((256,), generator=_gen(seed)) * scale
    q, s = compress(g, _gen(seed + 1))
    back = decompress(q, s)
    assert bool(torch.all((back - g).abs() <= float(s) * 1.0001))
    assert q.dtype == torch.int8


def test_torch_tree_roundtrip():
    grads = {"a": torch.ones((8, 8)), "b": {"c": torch.linspace(-1, 1, 64)}}
    qt, st_ = compress_tree(grads, _gen(7))
    back = decompress_tree(qt, st_)
    for o, r in zip(tree_flatten(grads)[0], tree_flatten(back)[0]):
        np.testing.assert_allclose(o.numpy(), r.numpy(), atol=0.02)


def test_torch_zero_gradient_safe():
    g = torch.zeros((16,))
    q, s = compress(g, _gen(0))
    np.testing.assert_array_equal(decompress(q, s).numpy(), 0.0)


def test_torch_same_generator_state_gives_identical_bits():
    """Recovery within the port is bit-identical: the same seed gives the
    same int8 tree and scales; another seed rounds some elements the other
    way; a grid point (an integer multiple of the scale) never moves."""
    g = torch.randn((4, 300), generator=_gen(3))
    tree = {"w": g, "b": [g[0] * 0.1, g[1, :7]]}
    q1, s1 = compress_tree(tree, _gen(9))
    q2, s2 = compress_tree(tree, _gen(9))
    q3, _ = compress_tree(tree, _gen(10))
    for a, b in zip(tree_flatten((q1, s1))[0], tree_flatten((q2, s2))[0]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert any(bool((a != b).any()) for a, b in zip(tree_flatten(q1)[0], tree_flatten(q3)[0]))
    on_grid = torch.arange(-127, 128, dtype=torch.float32) * 0.01
    q, s = compress(on_grid, _gen(1))
    torch.testing.assert_close(q.to(torch.int64), torch.arange(-127, 128), rtol=0, atol=0)


def test_torch_rounding_frequency_matches_the_fraction():
    """Each element rounds up with probability frac(x): over 4000 draws of
    a vector of fractions, the frequency of rounding up is within 4 sigma
    of the fraction (the law the reference's ``bernoulli`` keeps)."""
    frac = torch.linspace(0.05, 0.95, 19)
    g = torch.cat([torch.tensor([127.0]), 3.0 + frac])  # scale 1: x = g
    ups = torch.zeros(19)
    n = 4000
    gen = _gen(21)
    for _ in range(n):
        q, s = compress(g, gen)
        assert float(s) == 1.0
        ups += (q[1:].float() == 4.0).float()
    sigma = torch.sqrt(frac * (1 - frac) / n)
    assert bool(torch.all((ups / n - frac).abs() <= 4 * sigma)), (ups / n, frac)


def test_torch_compress_matches_reference_but_the_rounding_bits():
    """Against the JAX package on the same seeded numpy gradients: the scale
    is bit-equal, and each int8 value is the reference's or one step from
    it (only the random bits differ); the mean of 200 draws of both lies
    within 4 sigma of the gradient."""
    import jax
    import jax.numpy as jnp

    from repro.training.grad_compression import compress as jax_compress
    from repro.training.grad_compression import decompress as jax_decompress

    g = np.random.default_rng(4).normal(0, 2.0, (512,)).astype(np.float32)
    q, s = compress(torch.from_numpy(g), _gen(0))
    jq, js = jax_compress(jnp.asarray(g), jax.random.key(0))
    assert np.float32(s) == np.float32(js)
    assert int(np.abs(q.numpy().astype(np.int32) - np.asarray(jq).astype(np.int32)).max()) <= 1
    gen = _gen(1)
    ours = np.mean([decompress(*compress(torch.from_numpy(g), gen)).numpy()
                    for _ in range(200)], axis=0)
    theirs = np.mean([np.asarray(jax_decompress(*jax_compress(jnp.asarray(g), jax.random.key(i))))
                      for i in range(200)], axis=0)
    bound = 4 * float(s) * 0.5 / np.sqrt(200)  # a Bernoulli's sigma is at most 1/2 a step
    assert np.abs(ours - g).max() <= bound and np.abs(theirs - g).max() <= bound
