"""The port's flash attention on the CPU, held against the JAX package's.

The port's plain version (``flash_attention_ref``) and its op
(``ops.flash_attention``, which takes the plain version for CPU tensors)
run on the same numpy inputs as the JAX Pallas kernel
(``flash_attention_bhsd(..., interpret=True)``) and the JAX oracle
``flash_attention_ref``, at the reference's own cases and tolerances
(``tests/test_kernels.py:115-167``): 2e-4 in f32, 3e-4 in the property
sweep, 5e-2 in bf16 (the softmax weights are rounded to bf16 before P·V).
The card's tighter bf16 limit, ``bf16_bound`` (about 2**-7 of each
output's scale, per element), is held against the Pallas kernel too.
Ragged lengths, which the Pallas kernel does not take (``ops.py:15`` falls
back to the oracle there), are held against the JAX oracle.  The CUDA
kernel itself runs only on the card, in ``tests/test_torch_cuda.py``; its
f32 arithmetic, 3xTF32 on the tensor cores, is modelled here by
``flash_attention_tf32`` and held to the same 2e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ModuleNotFoundError:  # minimal container: seeded fallback sweeps
    from _hypothesis_compat import given, settings, strategies as st

from repro.kernels.flash_attention.kernel import flash_attention_bhsd
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_flash_ref
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import (bf16_bound, flash_attention_ref,
                                                    flash_attention_tf32, split_tf32)


def _inputs(B, Sq, Skv, H, K, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, dtype=np.float32)
            for s in ((B, Sq, H, D), (B, Skv, K, D), (B, Skv, K, D))]


def _pallas(q, k, v, causal, bq, bk):
    out = flash_attention_bhsd(*(jnp.asarray(a).swapaxes(1, 2) for a in (q, k, v)),
                               causal=causal, bq=bq, bk=bk, interpret=True)
    return np.asarray(out.swapaxes(1, 2))


def _port(fn, q, k, v, causal, dtype=torch.float32):
    return fn(*(torch.from_numpy(a).to(dtype) for a in (q, k, v)), causal=causal).float().numpy()


@pytest.mark.parametrize("B,Sq,Skv,H,K,D,bq,bk", [
    (1, 128, 128, 4, 4, 64, 64, 64),     # MHA
    (2, 256, 256, 8, 2, 32, 128, 64),    # GQA R=4
    (1, 128, 256, 4, 1, 64, 64, 128),    # MQA, cross Skv>Sq
])
@pytest.mark.parametrize("causal", [True, False])
def test_torch_flash_attention_matches_pallas(B, Sq, Skv, H, K, D, bq, bk, causal):
    q, k, v = _inputs(B, Sq, Skv, H, K, D, seed=3)
    want = np.asarray(jax_flash_ref(*(jnp.asarray(a) for a in (q, k, v)), causal=causal))
    if not (causal and Sq != Skv):  # the Pallas kernel takes causal only square here
        np.testing.assert_allclose(_pallas(q, k, v, causal, bq, bk), want, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(_port(flash_attention_ref, q, k, v, causal),
                                   _pallas(q, k, v, causal, bq, bk), rtol=2e-4, atol=2e-4)
    for fn in (flash_attention_ref, ops.flash_attention):
        np.testing.assert_allclose(_port(fn, q, k, v, causal), want, rtol=2e-4, atol=2e-4)


@settings(max_examples=8, deadline=None)
@given(
    B=st.integers(1, 2),
    nq=st.integers(1, 4),
    K=st.sampled_from([1, 2, 4]),
    R=st.sampled_from([1, 2, 4]),
    D=st.sampled_from([16, 64]),
    seed=st.integers(0, 2**16),
)
def test_torch_flash_attention_property(B, nq, K, R, D, seed):
    S = nq * 32
    q, k, v = _inputs(B, S, S, K * R, K, D, seed)
    want = _pallas(q, k, v, True, 32, 32)
    np.testing.assert_allclose(_port(ops.flash_attention, q, k, v, True), want,
                               rtol=3e-4, atol=3e-4)


def test_torch_flash_attention_bf16():
    q, k, v = _inputs(1, 128, 128, 4, 2, 32, seed=5)
    qj, kj, vj = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(flash_attention_bhsd(qj.swapaxes(1, 2), kj.swapaxes(1, 2), vj.swapaxes(1, 2),
                                           causal=True, bq=64, bk=64, interpret=True)
                      .swapaxes(1, 2), np.float32)
    for fn in (flash_attention_ref, ops.flash_attention):
        got = fn(*(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)), causal=True)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want, rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("causal", [True, False])
def test_torch_flash_attention_bf16_bound(causal):
    """``bf16_bound``, the card tests' bf16 limit, admits the Pallas kernel
    (weights rounded at its running max, as the CUDA kernel rounds them)
    against the port's plain version (weights rounded normalized), and does
    not admit the plain version with the last 64-key tile dropped."""
    q, k, v = _inputs(1, 256, 256, 4, 2, 64, seed=8)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    want = flash_attention_ref(tq, tk, tv, causal=causal)
    bound = bf16_bound(tq, tk, tv, want, causal=causal)
    qj, kj, vj = (jnp.asarray(a).astype(jnp.bfloat16).swapaxes(1, 2) for a in (q, k, v))
    got = np.asarray(flash_attention_bhsd(qj, kj, vj, causal=causal, bq=64, bk=64, interpret=True)
                     .swapaxes(1, 2), np.float32)
    assert bool(((torch.from_numpy(got) - want.float()).abs() <= bound).all())
    dropped = flash_attention_ref(tq, tk[:, :-64], tv[:, :-64], causal=causal)
    assert bool(((dropped.float() - want.float()).abs() > bound).any())


@pytest.mark.parametrize("B,Sq,Skv,H,K,D", [
    (2, 100, 100, 4, 2, 16),
    (1, 200, 200, 4, 4, 128),
    (1, 100, 200, 8, 2, 64),   # causal with Sq != Skv: kpos <= qpos, both from 0
    (1, 200, 100, 4, 1, 32),
])
@pytest.mark.parametrize("causal", [True, False])
def test_torch_flash_attention_ragged_matches_reference(B, Sq, Skv, H, K, D, causal):
    q, k, v = _inputs(B, Sq, Skv, H, K, D, seed=6)
    want = np.asarray(jax_flash_ref(*(jnp.asarray(a) for a in (q, k, v)), causal=causal))
    reset_launch_counts()
    for fn in (flash_attention_ref, ops.flash_attention):
        np.testing.assert_allclose(_port(fn, q, k, v, causal), want, rtol=2e-4, atol=2e-4)
    assert launch_counts()["flash_attention"] == 0  # CPU tensors take the plain version


def test_torch_flash_attention_op_refuses_unknown_impl_and_cpu_kernel():
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="impl="):
        ops.flash_attention(q, q, q, impl="pallas")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.flash_attention(q, q, q, impl="cuda")  # never a silent CPU fallback


def test_torch_split_tf32_rounds_to_nearest_ties_away():
    """hi keeps 10 mantissa bits, rounded to nearest with ties away from
    zero (``cvt.rna.tf32.f32``): off ties it is JAX's ``reduce_precision``
    to tf32; lo is x - hi rounded the same way, and hi + lo is x within
    2**-21 of |x|."""
    x = np.random.default_rng(11).standard_normal(1 << 14).astype(np.float32)
    x = np.concatenate([(x * 10.0 ** np.random.default_rng(12).integers(-20, 20, x.size))
                        .astype(np.float32),
                        np.float32([1 + 2**-11, -(1 + 2**-11), 3 + 2**-10, 1 + 2**-11 - 2**-23])])
    hi, lo = (t.numpy() for t in split_tf32(torch.from_numpy(x)))
    assert not ((hi.view(np.int32) | lo.view(np.int32)) & 0x1FFF).any()  # tf32 values
    ties = (x.view(np.int32) & 0x1FFF) == 0x1000
    even = np.asarray(jax.lax.reduce_precision(x, exponent_bits=8, mantissa_bits=10))
    np.testing.assert_array_equal(hi[~ties], even[~ties])
    # a tie lies half a tf32 ulp from both neighbours: it goes to the larger magnitude
    down = (x[ties].view(np.int32) & ~0x1FFF).view(np.float32)
    np.testing.assert_array_equal(np.abs(hi[ties] - x[ties]), np.abs(x[ties] - down))
    assert (np.abs(hi[ties]) > np.abs(x[ties])).all() and (np.sign(hi[ties]) == np.sign(x[ties])).all()
    assert hi[-4] == np.float32(1 + 2**-10) and hi[-3] == -np.float32(1 + 2**-10)
    assert hi[-1] == 1.0
    np.testing.assert_array_less(np.abs(x.astype(np.float64) - hi - lo),
                                 2.0**-21 * np.abs(x.astype(np.float64)) + 1e-45)


@pytest.mark.parametrize("B,Sq,Skv,H,K,D,bq,bk", [
    (1, 128, 128, 4, 4, 64, 64, 64),     # MHA
    (2, 256, 256, 8, 2, 32, 128, 64),    # GQA R=4
    (1, 128, 256, 4, 1, 64, 64, 128),    # MQA, cross Skv>Sq
])
@pytest.mark.parametrize("causal", [True, False])
def test_torch_flash_attention_3xtf32_matches_pallas(B, Sq, Skv, H, K, D, bq, bk, causal):
    """The f32 kernel's arithmetic (both products in 3xTF32) meets the
    reference's 2e-4 against the Pallas kernel and the JAX oracle."""
    q, k, v = _inputs(B, Sq, Skv, H, K, D, seed=3)
    want = np.asarray(jax_flash_ref(*(jnp.asarray(a) for a in (q, k, v)), causal=causal))
    got = _port(flash_attention_tf32, q, k, v, causal)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    if not (causal and Sq != Skv):  # the Pallas kernel takes causal only square here
        np.testing.assert_allclose(got, _pallas(q, k, v, causal, bq, bk), rtol=2e-4, atol=2e-4)


def test_torch_flash_attention_plain_tf32_misses_the_f32_tolerance():
    """At D 128 and S 1000 3xTF32 stays within 2e-4 of the JAX oracle and
    plain TF32 (hi*hi only) does not: about 1e-3 off."""
    q, k, v = _inputs(1, 1000, 1000, 2, 2, 128, seed=4)
    want = np.asarray(jax_flash_ref(*(jnp.asarray(a) for a in (q, k, v)), causal=True))
    err3 = np.abs(_port(flash_attention_tf32, q, k, v, True) - want).max()
    err1 = np.abs(_port(lambda *a, **kw: flash_attention_tf32(*a, **kw, passes=1), q, k, v, True)
                  - want).max()
    assert err3 <= 2e-4 < err1, (err3, err1)
    with pytest.raises(ValueError, match="passes=2"):
        flash_attention_tf32(*(torch.from_numpy(a) for a in (q, k, v)), passes=2)


def test_torch_flash_sweep_rewrites_only_the_tile_constants():
    """``tools/sweep_torch_flash.py`` builds variants of the kernel source
    with other ``Tiles`` constants; every default variant names real fields
    and leaves the rest of the source as it is."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "tools" / "sweep_torch_flash.py"
    spec = importlib.util.spec_from_file_location("sweep_torch_flash", path)
    sweep = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sweep)
    src = sweep.SOURCE.read_text()
    assert sweep.variant_source(src, {}) == src
    for tiles in sweep.VARIANTS.values():
        out = sweep.variant_source(src, tiles)
        assert len(out.splitlines()) == len(src.splitlines())
    out = sweep.variant_source(src, {"bf16": {"BK": 64}})
    assert "struct Tiles<__nv_bfloat16> {\n  static constexpr int BQ = 128, BK = 64," in out
    assert out.count("BK = 64") == src.count("BK = 64") + 1
    with pytest.raises(ValueError, match="no tile field"):
        sweep.variant_source(src, {"f32": {"WARPS": 4}})
