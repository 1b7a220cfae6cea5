"""The port's SSD scan held against the reference's, on the CPU.

The same numpy inputs (made from a seed) go through the JAX package's
sequential oracle ``ssd_ref``, its Pallas kernel ``ssd_scan``
(``interpret=True``) and its model's ``ssd_chunked``, and through the
port's ``ssd_ref`` and ``ssd_chunked``.  Tolerances: the reference's own
(``tests/test_kernels.py``), 2e-3 at its cases and 5e-3 for its property
sweep; 1e-5 between the two ``ssd_chunked`` (the same f32 operations,
summed in other orders).  The kernel's three-pass decomposition in plain
PyTorch, ``ssd_three_pass``, is held to the Pallas kernel at 1e-5 where
the chunks are whole and to ``ssd_ref`` at 2e-3 elsewhere.  The CUDA
kernel runs only on the card (``tests/test_torch_cuda.py``); here its
wrapper's refusals are checked, each before any build is attempted.
"""
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ModuleNotFoundError:  # minimal container: seeded fallback sweeps
    from _hypothesis_compat import given, settings, strategies as st

from repro.kernels.ssd_scan.kernel import ssd_scan as pallas_ssd_scan
from repro.kernels.ssd_scan.ref import ssd_ref as jax_ssd_ref
from repro.models.ssm import ssd_chunked as jax_ssd_chunked
from repro_torch.kernels import _build, launch_counts, reset_launch_counts
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import ssd_ref, ssd_three_pass
from repro_torch.models.ssm import ssd_chunked

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _softplus(a):
    return np.logaddexp(a, 0.0)


def _rows(G, S, P, N, seed, dt_scale=0.1, a_scale=0.3, bc_scale=0.5):
    """(G, S) rows with the reference test's distributions, from numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((G, S, P))
    dt = _softplus(rng.standard_normal((G, S))) * dt_scale
    A = -np.exp(rng.standard_normal(G) * a_scale)
    B = rng.standard_normal((G, S, N)) * bc_scale
    C = rng.standard_normal((G, S, N)) * bc_scale
    return [a.astype(np.float32) for a in (x, dt, A, B, C)]


def _check_rows(G, S, P, N, chunk, seed, tol, **scales):
    arrs = _rows(G, S, P, N, seed, **scales)
    got = ssd_ref(*(torch.from_numpy(a) for a in arrs)).numpy()
    want = np.asarray(jax_ssd_ref(*(jnp.asarray(a) for a in arrs)))
    kern = np.asarray(pallas_ssd_scan(*(jnp.asarray(a) for a in arrs), chunk=chunk, interpret=True))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    np.testing.assert_allclose(got, kern, rtol=tol, atol=tol)


@pytest.mark.parametrize("G,S,P,N,chunk", [
    (2, 64, 16, 8, 16),
    (4, 128, 32, 16, 64),
    (1, 256, 64, 128, 64),   # mamba2-130m-like head
])
def test_torch_ssd_ref_matches_reference(G, S, P, N, chunk):
    _check_rows(G, S, P, N, chunk, seed=11, tol=2e-3)


@settings(max_examples=8, deadline=None)
@given(
    G=st.integers(1, 3),
    nc=st.integers(1, 4),
    chunk=st.sampled_from([8, 16, 32]),
    P=st.sampled_from([8, 16]),
    N=st.sampled_from([4, 16]),
    seed=st.integers(0, 2**16),
)
def test_torch_ssd_ref_property(G, nc, chunk, P, N, seed):
    _check_rows(G, nc * chunk, P, N, chunk, seed, tol=5e-3, dt_scale=0.2, a_scale=0.2,
                bc_scale=0.3)


def _model_layout(Bz, S, H, G, P, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((Bz, S, H, P))
    dt = _softplus(rng.standard_normal((Bz, S, H))) * 0.1
    A = -np.exp(rng.standard_normal(H) * 0.3)
    B = rng.standard_normal((Bz, S, G, N)) * 0.5
    C = rng.standard_normal((Bz, S, G, N)) * 0.5
    return [a.astype(np.float32) for a in (x, dt, A, B, C)]


@pytest.mark.parametrize("Bz,S,H,G,P,N,chunk", [
    (2, 50, 4, 2, 8, 16, 16),   # ragged S, two groups over four heads
    (1, 64, 3, 1, 16, 8, 16),   # whole chunks, one group
    (2, 7, 2, 2, 8, 4, 16),     # one ragged chunk shorter than ``chunk``
])
def test_torch_ssd_chunked_matches_reference(Bz, S, H, G, P, N, chunk):
    arrs = _model_layout(Bz, S, H, G, P, N, seed=13)
    y, state = ssd_chunked(*(torch.from_numpy(a) for a in arrs), chunk)
    jy, jstate = jax_ssd_chunked(*(jnp.asarray(a) for a in arrs), chunk)
    assert y.dtype == state.dtype == torch.float32
    assert tuple(y.shape) == (Bz, S, H, P) and tuple(state.shape) == (Bz, H, N, P)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(state.numpy(), np.asarray(jstate), rtol=1e-5, atol=1e-5)


def _rows_of(x, dt, A, B, C):
    """Model layout -> the reference kernel's rows (Bz*H, S, .), groups
    expanded over their heads."""
    Bz, S, H, P = x.shape
    R = H // B.shape[2]
    rows = lambda t: np.ascontiguousarray(  # noqa: E731
        t.transpose(0, 2, 1, 3).reshape(Bz * H, S, -1))
    return (rows(x), np.ascontiguousarray(dt.transpose(0, 2, 1).reshape(Bz * H, S)),
            np.tile(A, Bz), rows(np.repeat(B, R, axis=2)), rows(np.repeat(C, R, axis=2)))


def _check_three_pass(arrs, chunk):
    """y against the Pallas kernel at ``chunk`` (interpret mode) at 1e-5
    where S is whole chunks (the same chunking, the same f32 operations),
    else against the sequential ``ssd_ref`` at 2e-3, the reference's
    tolerance; the final state against the JAX model's ``ssd_chunked`` at
    the same chunk, 1e-5.  Both must be finite."""
    Bz, S, H, P = arrs[0].shape
    N = arrs[3].shape[3]
    y, state = ssd_three_pass(*(torch.from_numpy(a) for a in arrs), chunk)
    assert y.dtype == state.dtype == torch.float32
    assert tuple(y.shape) == (Bz, S, H, P) and tuple(state.shape) == (Bz, H, N, P)
    assert bool(y.isfinite().all()) and bool(state.isfinite().all())
    rows = [jnp.asarray(a) for a in _rows_of(*arrs)]
    y_rows = y.numpy().transpose(0, 2, 1, 3).reshape(Bz * H, S, P)
    if S % chunk == 0:
        want = np.asarray(pallas_ssd_scan(*rows, chunk=chunk, interpret=True))
        np.testing.assert_allclose(y_rows, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(y_rows, np.asarray(jax_ssd_ref(*rows)), rtol=2e-3, atol=2e-3)
    _, jstate = jax_ssd_chunked(*(jnp.asarray(a) for a in arrs), chunk)
    np.testing.assert_allclose(state.numpy(), np.asarray(jstate), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("chunk", [64, 128])
@pytest.mark.parametrize("at", ["1", "l-1", "l", "l+1", "3l+5"])
def test_torch_ssd_three_pass_at_chunk_edges(at, chunk):
    S = {"1": 1, "l-1": chunk - 1, "l": chunk, "l+1": chunk + 1, "3l+5": 3 * chunk + 5}[at]
    _check_three_pass(_model_layout(2, S, 3, 1, 8, 16, seed=17), chunk)


@pytest.mark.parametrize("Bz,S,H,G,P,N,chunk", [
    (2, 150, 4, 2, 8, 16, 64),    # two groups over four heads, ragged
    (1, 256, 6, 3, 16, 8, 128),   # three groups over six heads, whole chunks
])
def test_torch_ssd_three_pass_reads_groups(Bz, S, H, G, P, N, chunk):
    _check_three_pass(_model_layout(Bz, S, H, G, P, N, seed=19), chunk)


@pytest.mark.parametrize("S,chunk", [(128, 64), (263, 128)])
def test_torch_ssd_three_pass_strong_decay(S, chunk):
    """dt * A = -2.4 a token: cum reaches -153 (l 64) or -307 (l 128)
    within a chunk, where exp(-cum) is inf in f32.  y and the state stay
    finite and within tolerance."""
    Bz, H, G, P, N = 1, 2, 1, 8, 8
    x, _, _, B, C = _model_layout(Bz, S, H, G, P, N, seed=23)
    dt = np.full((Bz, S, H), 0.1, np.float32)
    A = np.full(H, -24.0, np.float32)
    with np.errstate(over="ignore"):  # exp(-cum) at the chunk's end overflows
        assert np.isinf(np.exp(np.float32(2.4 * min(S, chunk))))
    _check_three_pass([x, dt, A, B, C], chunk)


def test_torch_ssd_op_takes_the_plain_path_on_cpu():
    """``auto`` on CPU tensors is the sequential recurrence, y and state,
    with D added, and equal to the chunked form up to rounding."""
    arrs = [torch.from_numpy(a) for a in _model_layout(2, 50, 4, 2, 8, 16, seed=5)]
    D = torch.linspace(0.5, 1.5, 4)
    reset_launch_counts()
    y, state = ssd_ops.ssd(*arrs, D, return_state=True)
    y_ref = ssd_ops.ssd(*arrs, D, impl="ref")
    assert launch_counts()["ssd_scan"] == 0
    torch.testing.assert_close(y, y_ref, rtol=0, atol=0)
    y_chunk, state_chunk = ssd_chunked(*arrs, 16)
    x = arrs[0]
    torch.testing.assert_close(y, y_chunk + x * D[:, None], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(state, state_chunk, rtol=1e-5, atol=1e-5)
    assert ssd_ops.ssd.cuda_library == "ssd_scan"
    for bad in ("pallas", "triton", ""):
        with pytest.raises(ValueError, match="impl="):
            ssd_ops.ssd(*arrs, impl=bad)
    torch.testing.assert_close(ssd_ops.ssd(*arrs, D, chunk=64), y, rtol=0, atol=0)
    for bad in (16, 256):  # no chunk length of its own to take: refused, not ignored
        with pytest.raises(ValueError, match="chunk="):
            ssd_ops.ssd(*arrs, chunk=bad)


def test_torch_ssd_wrapper_refuses_before_building(monkeypatch):
    def no_build(name):
        raise AssertionError(f"tried to build {name}")

    monkeypatch.setattr(_build, "load", no_build)
    x, dt, A, B, C = (torch.from_numpy(a) for a in _model_layout(1, 16, 4, 2, 8, 16, seed=1))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_kernel.ssd_scan(x, dt, A, B, C)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_ops.ssd(x, dt, A, B, C, impl="cuda")
    with pytest.raises(TypeError, match="float32"):
        ssd_kernel.ssd_scan(x.bfloat16(), dt, A, B, C)
    big_n = torch.zeros(1, 16, 2, 257)
    with pytest.raises(ValueError, match="N=257"):
        ssd_kernel.ssd_scan(x, dt, A, big_n, big_n)
    with pytest.raises(ValueError, match="P=129"):
        ssd_kernel.ssd_scan(torch.zeros(1, 16, 4, 129), dt, A, B, C)
    with pytest.raises(ValueError, match="do not fit"):
        ssd_kernel.ssd_scan(x, dt[:, :8], A, B, C)
    with pytest.raises(ValueError, match="not a multiple"):
        ssd_kernel.ssd_scan(x, dt, A, torch.zeros(1, 16, 3, 16), torch.zeros(1, 16, 3, 16))


def test_torch_ssd_flop_count_at_the_serve_shape():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.ssd_flops(4, 24, 4000, 64, 128, 256) == 31_247_892_480
    assert smoke.ssd_flops(4, 24, 1000, 64, 128, 256) == 7_780_122_624
    # one whole chunk: (N + P) l (l + 1) + 4 l N P
    assert smoke.ssd_flops(1, 1, 8, 2, 3, 8) == (3 + 2) * 8 * 9 + 4 * 8 * 3 * 2
    t, by = smoke.bound(218e6, 31_247_892_480)
    assert by == "operations" and t == pytest.approx(0.4664, rel=1e-3)
    # the bound's count: least at l = 1, 4 N P + 2 (N + P) a token and row
    least = smoke.ssd_least_flops(4, 24, 4000, 64, 128)
    assert least == 4 * 24 * 4000 * (4 * 128 * 64 + 2 * (128 + 64)) == 12_730_368_000
    assert least == min(smoke.ssd_flops(4, 24, 4000, 64, 128, l) for l in (1, 2, 7, 32, 256))
    t, by = smoke.bound(217_673_824, least)
    assert by == "operations" and t == pytest.approx(0.190006, rel=1e-5)
