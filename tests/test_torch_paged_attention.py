"""The port's paged-attention package held against the JAX package's.

The plain PyTorch version (``paged_attention_ref``) runs on the CPU on the
reference's own cases (``tests/test_paged.py``): pools whose unreferenced
pages hold ±1e6, so a masking fault is a blow-up, not a rounding error.
It is held against JAX ``paged_attention_ref`` and the Pallas kernel
``paged_attention_bhd`` in interpret mode at 1e-5 (the property sweep at
1e-4, as the reference's), and against the contiguous flash oracle.  The
fold (``paged_attention_layers``) equals per-layer calls bit for bit, as
in the reference.  The CUDA kernel itself runs only on the card
(``tests/test_torch_cuda.py``); here a CPU tensor takes the plain version
and the wrapper's refusals build nothing.

``paged_attention_split_ref``, the kernel's split-K decomposition in plain
PyTorch, is held here against the same JAX functions at the same
tolerances, over the edges of its page split.
"""
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # minimal container: deterministic fallback sweep
    from tests._hypothesis_compat import given, settings, strategies as st

from repro.kernels.paged_attention.kernel import paged_attention_bhd as jax_paged_bhd
from repro.kernels.paged_attention.ref import paged_attention_ref as jax_paged_ref
from repro_torch import configs as tcfg
from repro_torch.kernels import _build, launch_counts, reset_launch_counts
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.paged_attention import kernel as paged_kernel
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.kernels.paged_attention.ref import (bf16_bound, paged_attention_ref,
                                                    paged_attention_split_ref, split_bounds)
from repro_torch.models.model import paged_surface

TOL = dict(rtol=1e-5, atol=1e-5)


def _random_paged(rng, B, H, K, D, P, M, lengths):
    """The reference's pool: pages covering ``lengths`` in order from 1,
    page 0 and unreferenced pages (and the tails past each length) hold
    +1e6 (k) / -1e6 (v)."""
    N = 1 + sum(-(-n // P) for n in lengths) + 2
    k_pages = np.full((N, P, K, D), 1e6, np.float32)
    v_pages = np.full((N, P, K, D), -1e6, np.float32)
    tbl = np.zeros((B, M), np.int32)
    nxt = 1
    for b, n in enumerate(lengths):
        for j in range(-(-n // P)):
            tbl[b, j] = nxt
            valid = min(P, n - j * P)
            k_pages[nxt, :valid] = rng.normal(size=(valid, K, D))
            v_pages[nxt, :valid] = rng.normal(size=(valid, K, D))
            nxt += 1
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    return q, k_pages, v_pages, tbl, np.asarray(lengths, np.int32)


def _random_layered(rng, Lc, B, H, K, D, P, M, lengths):
    qs, ks, vs = [], [], []
    for _ in range(Lc):
        q, kp, vp, tbl, lens = _random_paged(rng, B, H, K, D, P, M, lengths)
        qs.append(q), ks.append(kp), vs.append(vp)
    return np.stack(qs), np.stack(ks), np.stack(vs), tbl, lens


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _port(q, kp, vp, tbl, lens):
    return paged_attention_ref(*_t(q, kp, vp, tbl, lens)).numpy()


@pytest.mark.parametrize("case", [
    # (B, H, K, D, P, M, lengths): partial page, exact boundary,
    # straddling, full table; then sub-page, straddling, full table
    (4, 4, 2, 8, 4, 6, [3, 4, 7, 24]),
    (3, 4, 2, 8, 4, 5, [1, 6, 20]),
])
def test_torch_paged_ref_matches_jax_ref_and_pallas_kernel(case):
    B, H, K, D, P, M, lengths = case
    q, kp, vp, tbl, lens = _random_paged(np.random.default_rng(sum(lengths)), B, H, K, D, P, M,
                                         lengths)
    got = _port(q, kp, vp, tbl, lens)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(jax_paged_ref(q, kp, vp, tbl, lens)), **TOL)
    np.testing.assert_allclose(
        got, np.asarray(jax_paged_bhd(q, kp, vp, tbl, lens, interpret=True)), **TOL)
    for b, n in enumerate(lengths):  # the contiguous oracle on each row's own tokens
        toks = [(tbl[b, t // P], t % P) for t in range(n)]
        kc = torch.from_numpy(np.stack([kp[p, o] for p, o in toks])[None])
        vc = torch.from_numpy(np.stack([vp[p, o] for p, o in toks])[None])
        want = flash_attention_ref(torch.from_numpy(q[b:b + 1, None]), kc, vc, causal=False)
        np.testing.assert_allclose(got[b], want[0, 0].numpy(), **TOL)


@settings(max_examples=6, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), page=st.sampled_from([2, 4, 8]))
def test_torch_paged_ref_property_ragged(seed, page):
    rng = np.random.default_rng(seed)
    B = int(rng.integers(1, 4))
    K = int(rng.integers(1, 3))
    H = K * int(rng.integers(1, 3))
    D = 4
    M = int(rng.integers(1, 4))
    lengths = [int(rng.integers(1, M * page + 1)) for _ in range(B)]
    q, kp, vp, tbl, lens = _random_paged(rng, B, H, K, D, page, M, lengths)
    got = _port(q, kp, vp, tbl, lens)
    np.testing.assert_allclose(
        got, np.asarray(jax_paged_bhd(q, kp, vp, tbl, lens, interpret=True)), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, np.asarray(jax_paged_ref(q, kp, vp, tbl, lens)),
                               rtol=1e-4, atol=1e-4)


def test_torch_paged_layers_fold_is_bit_equal_to_per_layer_calls():
    rng = np.random.default_rng(3)
    q, kp, vp, tbl, lens = _random_layered(rng, 3, 3, 4, 2, 8, 4, 5, [3, 8, 17])
    got = paged_ops.paged_attention_layers(*_t(q, kp, vp, tbl, lens))
    assert got.shape == (3, 3, 4, 8)
    for i in range(3):
        want = paged_ops.paged_attention(*_t(q[i], kp[i], vp[i], tbl, lens))
        assert torch.equal(got[i], want)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(
            jax_paged_ref(q[i], kp[i], vp[i], tbl, lens)), **TOL)


def test_torch_paged_layers_refuses_mismatched_layer_dims():
    rng = np.random.default_rng(4)
    q, kp, vp, tbl, lens = _random_layered(rng, 2, 2, 2, 1, 4, 4, 3, [5, 9])
    with pytest.raises(ValueError, match="layer dims"):
        paged_ops.paged_attention_layers(*_t(q[:1], kp, vp, tbl, lens))


@pytest.mark.parametrize("arch", ["olmo-1b", "stablelm-1.6b", "deepseek-67b", "mamba2-130m",
                                  "hymba-1.5b"])
def test_torch_paged_zoo_geometries(arch):
    """Every ported family's ``paged_spec`` geometry (multi-layer folds and
    GQA ratios): the port's fold against the JAX reference per layer."""
    cfg = tcfg.smoke(tcfg.get_config(arch))
    spec = paged_surface(cfg)[0](cfg)
    H = cfg.num_heads if cfg.family in ("dense", "hybrid") else 1
    K, D = spec.kv_heads, spec.head_dim
    assert H % K == 0
    q, kp, vp, tbl, lens = _random_layered(np.random.default_rng(6), spec.layers, 2, H, K, D,
                                           4, 4, [3, 10])
    got = paged_ops.paged_attention_layers(*_t(q, kp, vp, tbl, lens)).numpy()
    for i in range(spec.layers):
        np.testing.assert_allclose(got[i], np.asarray(jax_paged_ref(q[i], kp[i], vp[i], tbl, lens)),
                                   **TOL)


def test_torch_paged_length_zero_row_and_bf16():
    """A length-0 row gives what the reference's oracle gives (a uniform
    mix of the gathered slots: every score is masked alike); bf16 inputs
    give a bf16 result within bf16 rounding of the f32 one."""
    rng = np.random.default_rng(5)
    q, kp, vp, tbl, lens = _random_paged(rng, 2, 2, 1, 4, 4, 3, [5, 9])
    lens0 = np.asarray([0, 9], np.int32)
    np.testing.assert_allclose(_port(q, kp, vp, tbl, lens0),
                               np.asarray(jax_paged_ref(q, kp, vp, tbl, lens0)), **TOL)
    tq, tk, tv, tt, tl = _t(q, kp, vp, tbl, lens)
    kb, vb = tk.clone(), tv.clone()
    kb[kb.abs() > 1e5] = 0  # keep the garbage out of bf16 rounding
    vb[vb.abs() > 1e5] = 0
    f32 = paged_attention_ref(tq, kb, vb, tt, tl)
    b16 = paged_attention_ref(tq.bfloat16(), kb.bfloat16(), vb.bfloat16(), tt, tl)
    assert b16.dtype == torch.bfloat16
    torch.testing.assert_close(b16.float(), f32, rtol=3e-2, atol=3e-2)


def test_torch_paged_cpu_tensors_take_the_plain_version():
    rng = np.random.default_rng(2)
    args = _t(*_random_paged(rng, 2, 2, 1, 4, 4, 3, [5, 9]))
    reset_launch_counts()
    auto = paged_ops.paged_attention(*args)
    assert torch.equal(auto, paged_ops.paged_attention(*args, impl="ref"))
    assert torch.equal(auto, paged_attention_ref(*args))
    assert launch_counts()["paged_attention"] == 0
    with pytest.raises(ValueError, match="impl="):
        paged_ops.paged_attention(*args, impl="pallas")
    with pytest.raises(ValueError, match="CUDA tensors"):  # impl="cuda" on the CPU: no fallback
        paged_ops.paged_attention(*args, impl="cuda")


def _cuda_like(monkeypatch):
    """Make every tensor look like a CUDA tensor, so the wrapper's checks
    past the device test run here; ``_build.load`` fails if reached."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))

    def no_build(name):
        raise AssertionError(f"built {name} for inputs the wrapper must refuse")

    monkeypatch.setattr(_build, "load", no_build)


def _good(dtype=torch.float32):
    q = torch.zeros(2, 4, 8, dtype=dtype)
    kp = torch.zeros(5, 4, 2, 8, dtype=dtype)
    return q, kp, kp.clone(), torch.zeros(2, 3, dtype=torch.int32), torch.ones(2, dtype=torch.int32)


@pytest.mark.parametrize("bad,match", [
    (lambda q, k, v, t, n: (q.double(), k.double(), v.double(), t, n), "float32 or all bfloat16"),
    (lambda q, k, v, t, n: (q, k, v, t.long(), n), "int32"),
    (lambda q, k, v, t, n: (q, k, v, t, n.long()), "int32"),
    (lambda q, k, v, t, n: (q[:, :3], k, v, t, n), "not a multiple"),
    (lambda q, k, v, t, n: (q, k, v[:, :, :, :4], t, n), "do not fit"),
    (lambda q, k, v, t, n: (q[:, :, ::2], k[..., ::2], v[..., ::2], t, n), "contiguous last"),
    (lambda q, k, v, t, n: (q, k, v, t[:, ::2], n), "contiguous last"),
    (lambda q, k, v, t, n: (q, k, v, t[:1], n), "do not fit"),
    (lambda q, k, v, t, n: (torch.zeros(2, 4, 300), torch.zeros(5, 4, 2, 300),
                            torch.zeros(5, 4, 2, 300), t, n), "head dim"),
    (lambda q, k, v, t, n: (q.numpy(), k, v, t, n), "torch.Tensor"),
    (lambda q, k, v, t, n: (q[None], k, v, t, n), "3-D"),
])
def test_torch_paged_wrapper_refuses_before_building(monkeypatch, bad, match):
    args = bad(*_good())
    _cuda_like(monkeypatch)
    with pytest.raises((TypeError, ValueError), match=match):
        paged_kernel.paged_attention(*args)


def test_torch_paged_wrapper_refuses_cpu_tensors_before_building(monkeypatch):
    def no_build(name):
        raise AssertionError("built for CPU tensors")

    monkeypatch.setattr(_build, "load", no_build)
    before = paged_kernel.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        paged_kernel.paged_attention(*_good())
    with pytest.raises(ValueError, match="CUDA tensors"):
        paged_kernel.paged_attention_layers(*[t[None] if i < 3 else t
                                              for i, t in enumerate(_good())])
    assert paged_kernel.launches == before


# (B, H, K, D, P, M, lengths): length 0 and 1; rows of fewer pages than
# splits; lengths ending on a page boundary (4, 36) and on a split
# boundary (32 = 8 splits of one page, 64 of two); uneven last splits
# (9, 11 and 18 pages over 8 splits); GQA R = 9; D 4 with P 2.
SPLIT_CASES = [
    (3, 4, 2, 8, 4, 6, [0, 1, 24]),
    (3, 4, 2, 8, 4, 4, [5, 9, 13]),
    (4, 4, 2, 8, 4, 16, [4, 32, 36, 64]),
    (3, 2, 1, 8, 4, 18, [33, 44, 70]),
    (2, 36, 4, 8, 4, 8, [20, 31]),
    (2, 2, 1, 4, 2, 12, [23, 7]),
]


@pytest.mark.parametrize("case", SPLIT_CASES)
def test_torch_paged_split_ref_matches_jax_ref_and_pallas_kernel(case):
    B, H, K, D, P, M, lengths = case
    q, kp, vp, tbl, lens = _random_paged(np.random.default_rng(7 + sum(lengths)), B, H, K, D, P,
                                         M, lengths)
    got = paged_attention_split_ref(*_t(q, kp, vp, tbl, lens)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(
        got, np.asarray(jax_paged_bhd(q, kp, vp, tbl, lens, interpret=True)), **TOL)
    # The JAX oracle spreads a length-0 row over its masked slots; the
    # Pallas kernel and the split gives 0 there.
    live = lens > 0
    np.testing.assert_allclose(got[live], np.asarray(jax_paged_ref(q, kp, vp, tbl, lens))[live],
                               **TOL)
    np.testing.assert_array_equal(got[~live], 0)
    np.testing.assert_allclose(got[live], _port(q, kp, vp, tbl, lens)[live], **TOL)


@pytest.mark.parametrize("splits", [1, 3, 8])
def test_torch_paged_split_ref_agrees_across_split_counts(splits):
    """The split count moves only the rounding: 1, 3 and 8 splits agree
    with the plain gather version, rows past the table width included."""
    q, kp, vp, tbl, lens = _random_paged(np.random.default_rng(splits), 3, 4, 2, 8, 4, 5,
                                         [3, 17, 20])
    tq, tk, tv, tt, tl = _t(q, kp, vp, tbl, lens)
    want = paged_attention_ref(tq, tk, tv, tt, tl)
    torch.testing.assert_close(paged_attention_split_ref(tq, tk, tv, tt, tl, splits), want,
                               **TOL)
    over = torch.tensor([3, 17, 99], dtype=torch.int32)  # clamped to M * P = 20
    torch.testing.assert_close(paged_attention_split_ref(tq, tk, tv, tt, over, splits), want,
                               **TOL)


def test_torch_paged_split_bounds_cut_pages_as_the_kernel():
    lo, hi = split_bounds(torch.tensor([1000, 2000, 0, 1, 17, 5000]), 16, 128)
    assert lo.shape == hi.shape == (8, 6)
    # 1000 tokens: 63 pages, 8 a split, the last split 7 pages ending at 1000
    assert lo[:, 0].tolist() == [0, 128, 256, 384, 512, 640, 768, 896]
    assert hi[:, 0].tolist() == [128, 256, 384, 512, 640, 768, 896, 1000]
    assert hi[:, 1].tolist() == [256 * (s + 1) for s in range(7)] + [2000]
    assert lo[:, 2].tolist() == hi[:, 2].tolist() == [0] * 8  # length 0: every split empty
    assert hi[:, 3].tolist() == [1] * 8 and lo[1:, 3].tolist() == [1] * 7  # one token, split 0
    assert hi[:, 4].tolist() == [16] + [17] * 7 and lo[2:, 4].tolist() == [17] * 6
    assert hi[-1, 5] == 2048  # clamped to the table's M * P
    # the splits tile [0, n) in rank order
    for b in range(6):
        assert lo[0, b] == 0 and torch.equal(lo[1:, b], hi[:-1, b])


@settings(max_examples=6, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), page=st.sampled_from([2, 4, 8]),
       splits=st.sampled_from([1, 2, 3, 8]))
def test_torch_paged_split_ref_property_ragged(seed, page, splits):
    rng = np.random.default_rng(seed)
    B = int(rng.integers(1, 4))
    K = int(rng.integers(1, 3))
    H = K * int(rng.integers(1, 3))
    M = int(rng.integers(1, 6))
    lengths = [int(rng.integers(1, M * page + 1)) for _ in range(B)]
    q, kp, vp, tbl, lens = _random_paged(rng, B, H, K, 4, page, M, lengths)
    got = paged_attention_split_ref(*_t(q, kp, vp, tbl, lens), splits=splits).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jax_paged_bhd(q, kp, vp, tbl, lens, interpret=True)), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, np.asarray(jax_paged_ref(q, kp, vp, tbl, lens)),
                               rtol=1e-4, atol=1e-4)


def test_torch_paged_split_ref_fold_equals_per_layer_calls():
    rng = np.random.default_rng(8)
    q, kp, vp, tbl, lens = _random_layered(rng, 3, 3, 4, 2, 8, 4, 12, [8, 32, 45])
    got = paged_attention_split_ref(*_t(q, kp, vp, tbl, lens))
    assert got.shape == (3, 3, 4, 8)
    for i in range(3):
        assert torch.equal(got[i], paged_attention_split_ref(*_t(q[i], kp[i], vp[i], tbl, lens)))
        np.testing.assert_allclose(got[i].numpy(), np.asarray(
            jax_paged_ref(q[i], kp[i], vp[i], tbl, lens)), **TOL)


def test_torch_paged_split_ref_bf16_within_the_bound_and_blind_to_nan_tails():
    """bf16 pages whose tails, padding pages and unreferenced pages hold
    NaN: the split version never lets them meet a weight, and it lies
    within ``bf16_bound`` of the plain version on the cleaned pages (GQA
    R 9, rows across split boundaries)."""
    rng = np.random.default_rng(9)
    q, kp, vp, tbl, lens = _random_paged(rng, 3, 36, 4, 16, 4, 20, [32, 75, 1])
    tq, tk, tv, tt, tl = _t(q, kp, vp, tbl, lens)
    junk = tk.abs() > 1e5
    kb, vb = tk.masked_fill(junk, 0).bfloat16(), tv.masked_fill(junk, 0).bfloat16()
    want = paged_attention_ref(tq.bfloat16(), kb, vb, tt, tl)
    got = paged_attention_split_ref(tq.bfloat16(), kb.masked_fill(junk, float("nan")),
                                    vb.masked_fill(junk, float("nan")), tt, tl)
    assert got.dtype == torch.bfloat16 and bool(got.isfinite().all())
    err = (got.float() - want.float()).abs()
    assert bool((err <= bf16_bound(tq.bfloat16(), kb, vb, tt, tl, want)).all())
    # and within bf16 rounding of the f32 JAX reference
    np.testing.assert_allclose(got.float().numpy(), np.asarray(jax_paged_ref(q, kp, vp, tbl, lens)),
                               rtol=3e-2, atol=3e-2)
