"""The hand-written kernels inside autograd (``repro_torch.kernels.
_autograd``), on the CPU with stand-in "kernels": the forward's values
come from the kernel callable and the gradients from the plain callable's
recomputation; tuple outputs with an unused part; no autograd node when
nothing needs a gradient; the kernel runs again in each remat recompute.
Each raw CUDA wrapper raises ``RuntimeError`` on an input that requires
grad before any check or launch (reachable with CPU tensors).  The plain
attention the flash kernel's backward differentiates, in query blocks of
``GRAD_Q_BLOCK``, has the unblocked version's values and gradients.  The
call sites on the card are in ``tests/test_torch_cuda.py``.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.kernels._autograd import kernel_with_plain_grad, refuse_grad
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.paged_attention import kernel as paged_kernel
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.models import layers as L


def _x(*shape, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32))


class Stand:
    """A "kernel": the plain math plus an offset that marks its values."""

    def __init__(self, plain, offset=100.0):
        self.plain, self.offset, self.calls = plain, offset, 0

    def __call__(self, *xs):
        self.calls += 1
        with torch.no_grad():
            out = self.plain(*xs)
        return tuple(o + self.offset for o in out) if isinstance(out, tuple) else out + self.offset


def plain2(a, b):
    return torch.tanh(a) * b.sum(0, keepdim=True)


def test_torch_forward_from_kernel_gradients_from_plain():
    a, b = _x(4, 5).requires_grad_(), _x(3, 5, seed=1).requires_grad_()
    kern = Stand(plain2)
    out = kernel_with_plain_grad(kern, plain2, a, b)
    torch.testing.assert_close(out, plain2(a, b).detach() + 100.0, rtol=0, atol=0)
    w = _x(4, 5, seed=2)
    ga, gb = torch.autograd.grad((out * w).sum(), [a, b])
    wa, wb = torch.autograd.grad((plain2(a, b) * w).sum(), [a, b])
    torch.testing.assert_close(ga, wa, rtol=0, atol=0)
    torch.testing.assert_close(gb, wb, rtol=0, atol=0)
    assert kern.calls == 1


def test_torch_tuple_output_with_an_unused_part_and_a_frozen_input():
    def plain(a, b):
        return a * b, (a + b).sum(-1)

    a, b = _x(3, 4).requires_grad_(), _x(3, 4, seed=1)  # b needs no grad
    y, s = kernel_with_plain_grad(Stand(plain), plain, a, b)
    (ga,) = torch.autograd.grad(y.sum(), [a])  # the state-like part unused
    torch.testing.assert_close(ga, b, rtol=0, atol=0)
    y, s = kernel_with_plain_grad(Stand(plain), plain, a, b)
    (ga2,) = torch.autograd.grad((y.sum() + 3 * s.sum()), [a])
    torch.testing.assert_close(ga2, b + 3, rtol=0, atol=0)


def test_torch_no_node_without_grad():
    a, b = _x(4, 5), _x(3, 5, seed=1)
    out = kernel_with_plain_grad(Stand(plain2), plain2, a, b)
    assert out.grad_fn is None
    with torch.no_grad():
        out = kernel_with_plain_grad(Stand(plain2), plain2, a.requires_grad_(), b)
    assert out.grad_fn is None


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_torch_kernel_runs_again_in_each_recompute(remat):
    a, b = _x(4, 5).requires_grad_(), _x(3, 5, seed=1).requires_grad_()
    w = _x(5, 5, seed=3).requires_grad_()
    kern = Stand(plain2, offset=0.0)

    def layer(a, b, w):
        return torch.matmul(kernel_with_plain_grad(kern, plain2, torch.matmul(a, w), b), w)

    out = L.remat_call(remat, layer, a, b, w)
    assert kern.calls == 1
    grads = torch.autograd.grad(out.square().sum(), [a, b, w])
    assert kern.calls == 2  # forward + the backward's recompute
    want = torch.autograd.grad(torch.matmul(plain2(torch.matmul(a, w), b), w).square().sum(),
                               [a, b, w])
    for g, h in zip(grads, want):
        torch.testing.assert_close(g, h, rtol=1e-6, atol=1e-6)


def test_torch_refuse_grad():
    refuse_grad("k", _x(2), None, 3)
    with torch.no_grad():
        refuse_grad("k", _x(2).requires_grad_())
    with pytest.raises(RuntimeError, match="no backward"):
        refuse_grad("k", _x(2), _x(2).requires_grad_())


def test_torch_raw_wrappers_raise_on_an_input_that_requires_grad():
    """Before any check or launch: CPU tensors reach the refusal, and under
    ``no_grad`` the same call fails the device check instead."""
    q, k, v = _x(1, 64, 2, 16), _x(1, 64, 2, 16, seed=1), _x(1, 64, 2, 16, seed=2)
    x, dt, A = _x(1, 64, 2, 16), _x(1, 64, 2).abs(), -_x(2).abs()
    Bm, Cm = _x(1, 64, 1, 8, seed=3), _x(1, 64, 1, 8, seed=4)
    qd, kp, vp = _x(2, 2, 16), _x(4, 16, 2, 16, seed=5), _x(4, 16, 2, 16, seed=6)
    table = torch.zeros((2, 2), dtype=torch.int32)
    lengths = torch.tensor([5, 9], dtype=torch.int32)
    calls = {
        "flash_attention": (lambda t: flash_kernel.flash_attention(t, k, v), q),
        "ssd_scan": (lambda t: ssd_kernel.ssd_scan(t, dt, A, Bm, Cm), x),
        "paged_attention": (lambda t: paged_kernel.paged_attention(t, kp, vp, table, lengths), qd),
        "paged_attention_layers": (lambda t: paged_kernel.paged_attention_layers(
            t[None], kp[None], vp[None], table, lengths), qd),
    }
    for name, (call, t) in calls.items():
        with pytest.raises(RuntimeError, match="no backward"):
            call(t.clone().requires_grad_())
        with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
            call(t.clone().requires_grad_())


def test_torch_blocked_plain_attention_is_the_unblocked_one():
    """The flash kernel's backward differentiates ``attention(q_block=
    GRAD_Q_BLOCK, impl="ref")``: row by row the unblocked math, so its
    values and gradients are those of one block (causal, GQA, S past two
    blocks)."""
    S = 2 * L.GRAD_Q_BLOCK + 37
    q = _x(1, S, 4, 16).requires_grad_()
    k, v = _x(1, S, 2, 16, seed=1).requires_grad_(), _x(1, S, 2, 16, seed=2).requires_grad_()
    w = _x(1, S, 4, 16, seed=3)
    outs = {}
    for qb in (L.GRAD_Q_BLOCK, None):
        o = L.attention(q, k, v, causal=True, q_block=qb, impl="ref")
        outs[qb] = (o.detach(), torch.autograd.grad((o * w).sum(), [q, k, v]))
    torch.testing.assert_close(outs[L.GRAD_Q_BLOCK][0], outs[None][0], rtol=0, atol=0)
    for g, h in zip(outs[L.GRAD_Q_BLOCK][1], outs[None][1]):
        torch.testing.assert_close(g, h, rtol=1e-5, atol=1e-6)


def test_torch_ssd_chunked_gradient_finite_past_the_decay_overflow():
    """The SSD scan's backward differentiates ``ssd_chunked``.  Over a chunk
    of 256 with dt * A near -1 a step, exp(cum_i - cum_j) for j > i (masked
    out) overflows f32: the reference masks the product, so its gradient is
    0 * inf = NaN there; the port masks the exponent, so its gradient is
    finite and equals the sequential recurrence's (rtol 1e-3: the chunked
    form's exponents are differences of f32 cumsums reaching -380, which
    carry ~3e-5 of absolute error)."""
    import jax
    import jax.numpy as jnp

    from repro.models.ssm import ssd_chunked as jax_ssd_chunked
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models.ssm import ssd_chunked

    Bz, S, H, P, G, N = 1, 256, 2, 4, 1, 4
    x, Bm, Cm = _x(Bz, S, H, P), _x(Bz, S, G, N, seed=1), _x(Bz, S, G, N, seed=2)
    dt = (_x(Bz, S, H, seed=3).abs() + 0.5).clamp(max=1.5)
    A = torch.tensor([-1.0, -0.4])
    w = _x(Bz, S, H, P, seed=4)
    grads = {}
    for name, fn in (("chunked", lambda *t: ssd_chunked(*t, 256)),
                     ("sequential", lambda *t: ssd_ops.ssd(*t, impl="ref", return_state=True))):
        ins = [t.clone().requires_grad_() for t in (x, dt, A, Bm, Cm)]
        y, state = fn(*ins)
        grads[name] = torch.autograd.grad((y * w).sum() + state.sum(), ins)
    for g, h in zip(grads["chunked"], grads["sequential"]):
        assert bool(torch.isfinite(g).all())
        torch.testing.assert_close(g, h, rtol=1e-3, atol=1e-5)

    def jax_loss(*t):
        y, state = jax_ssd_chunked(*t, 256)
        return (y * jnp.asarray(w.numpy())).sum() + state.sum()

    jgrads = jax.grad(jax_loss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(t.numpy()) for t in (x, dt, A, Bm, Cm)))
    assert not all(bool(jnp.isfinite(g).all()) for g in jgrads)
