"""The port's kernel packages held against the reference's.

On the CPU, each op's plain PyTorch version is compared with the JAX
package's Pallas kernel (``interpret=True``) and its jnp oracle on the
same numpy inputs, at the reference's own tolerances
(``tests/test_kernels.py``): stencil 1e-6 in f32 and 2e-2 in bf16,
partition_map rtol 1e-5 to 1 and 2e-2 in bf16, mandelbrot bit-equal.
The CUDA kernels themselves run only on the card, in
``tests/test_torch_cuda.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ModuleNotFoundError:  # minimal container: seeded fallback sweeps
    from _hypothesis_compat import given, settings, strategies as st

from repro.kernels.mandelbrot.kernel import mandelbrot as pallas_mandelbrot
from repro.kernels.mandelbrot.ref import mandelbrot_ref as jax_mandelbrot_ref
from repro.kernels.partition_map.kernel import partition_map as pallas_partition_map
from repro.kernels.stencil.kernel import stencil as pallas_stencil
from repro.kernels.stencil.ref import stencil_ref as jax_stencil_ref
from repro_torch.kernels import (_build, _launch, all_kernels, launch_counts, note_launch,
                                 reset_launch_counts, tally_launches)
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.mandelbrot import kernel as mandel_kernel
from repro_torch.kernels.mandelbrot import ops as mandel_ops
from repro_torch.kernels.mandelbrot.ref import mandelbrot_blocked_ref, mandelbrot_ref, pixel_step
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.kernels.partition_map import ops as map_ops
from repro_torch.kernels.partition_map.ref import partition_map_ref
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.stencil import kernel as stencil_kernel
from repro_torch.kernels.stencil import ops as stencil_ops
from repro_torch.kernels.stencil.ref import stencil_ref

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _both(x: np.ndarray, dtype: str):
    """The same f32 numpy values as a JAX array and a torch tensor of
    ``dtype`` (both round f32 -> bf16 to nearest even)."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


# ---------------------------------------------------------------------------
# registry surface
# ---------------------------------------------------------------------------


def test_torch_all_kernels_keeps_reference_order():
    from repro.kernels import all_kernels as ref_all_kernels

    ks = all_kernels()
    for name in ("stencil", "partition_map", "mandelbrot", "flash_attention", "ssd",
                 "paged_attention", "paged_attention_layers"):
        assert name in ks and callable(ks[name]), name
    ported = [k for k in ref_all_kernels() if k in ks]
    assert ported == list(ks)  # same names, in the reference's package order
    assert list(ks) == list(all_kernels())


def test_torch_ops_name_their_cuda_library():
    for op, lib in [(stencil_ops.stencil, "stencil"), (map_ops.partition_map, "partition_map"),
                    (mandel_ops.mandelbrot, "mandelbrot"),
                    (flash_ops.flash_attention, "flash_attention"), (ssd_ops.ssd, "ssd_scan"),
                    (paged_ops.paged_attention, "paged_attention"),
                    (paged_ops.paged_attention_layers, "paged_attention")]:
        assert op.cuda_library == lib
        assert (_build.CSRC / f"{lib}.cu").is_file()


_CTYPES = {"p": "c_void_p", "i": "c_int", "L": "c_longlong", "f": "c_float"}


def _c_params(source: str, fn: str) -> list:
    """The ctypes types of a C entry's parameters, read off its definition."""
    import ctypes
    import re

    m = re.search(r"\bint " + fn + r"\((.*?)\)\s*\{", source, re.S)
    assert m, fn
    kinds = []
    for a in (x.strip() for x in m.group(1).split(",")):
        kinds.append("p" if "*" in a else "L" if a.startswith("long long")
                     else "i" if a.startswith("int") else "f" if a.startswith("float") else a)
    return [getattr(ctypes, _CTYPES[k]) for k in kinds]


@pytest.mark.parametrize("pkg,attr,lib,fns", [
    ("flash_attention", "_ARGS", "flash_attention", ("flash_attention_f32",
                                                     "flash_attention_bf16")),
    ("ssd_scan", "_ARGS", "ssd_scan", ("ssd_scan_f32",)),
    ("paged_attention", "_ARGS", "paged_attention", ("paged_attention_f32",
                                                     "paged_attention_bf16")),
    ("mandelbrot", "_ARGS", "mandelbrot", ("mandelbrot_i32",)),
    ("mandelbrot", "_ROUNDS_ARGS", "mandelbrot", ("mandelbrot_warp_rounds",)),
])
def test_torch_wrapper_argtypes_match_the_c_entry(pkg, attr, lib, fns):
    """Each wrapper's ctypes ``argtypes`` are its C entry's parameters, one
    for one: a missing one makes ctypes pass the last arguments by its
    default rule, a C int, which cut paged_attention's stream pointer to 32
    bits (a segfault in a worker process, whose streams lie above 4 GiB)."""
    import importlib

    mod = importlib.import_module(f"repro_torch.kernels.{pkg}.kernel")
    got = list(getattr(mod, attr))
    source = (_build.CSRC / f"{lib}.cu").read_text()
    for fn in fns:
        assert got == _c_params(source, fn), fn


# ---------------------------------------------------------------------------
# stencil
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,block", [(64, 16), (256, 64), (1024, 128), (4096, 1024)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_stencil_matches_pallas(n, block, dtype):
    x = np.random.default_rng(n).normal(size=(n,)).astype(np.float32)
    xj, xt = _both(x, dtype)
    got = stencil_ops.stencil(xt, block=(block, 1, 1))  # CPU tensor -> plain version
    tol = 1e-6 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_f32(got), _f32(pallas_stencil(xj, block=block, interpret=True)),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(_f32(got), _f32(jax_stencil_ref(xj)), rtol=tol, atol=tol)


@settings(max_examples=10, deadline=None)
@given(nb=st.integers(2, 8), block=st.sampled_from([8, 32, 128]), seed=st.integers(0, 2**16))
def test_torch_stencil_property(nb, block, seed):
    x = np.random.default_rng(seed).normal(size=(nb * block,)).astype(np.float32)
    xj, xt = _both(x, "float32")
    np.testing.assert_allclose(stencil_ref(xt).numpy(),
                               np.asarray(pallas_stencil(xj, block=block, interpret=True)),
                               rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# partition map
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,block", [(128, 32), (8192, 2048)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_partition_map_matches_pallas(n, block, dtype):
    x = (np.random.default_rng(7).normal(size=(n,)) * 10).astype(np.float32)
    xj, xt = _both(x, dtype)
    got = map_ops.partition_map(xt, block=(block, 1, 1))
    want = pallas_partition_map(xj, block=block, interpret=True)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


def test_torch_partition_map_is_one():
    x = (np.random.default_rng(0).normal(size=(1024,)) * 100).astype(np.float32)
    np.testing.assert_allclose(partition_map_ref(torch.from_numpy(x)).numpy(), 1.0, rtol=1e-5)


# ---------------------------------------------------------------------------
# mandelbrot
# ---------------------------------------------------------------------------


# The CUDA kernel's warm-up and block lengths (K0 and K of
# csrc/mandelbrot.cu; a card test holds the built library to them).
MANDEL_K0, MANDEL_K = 8, 8


@pytest.mark.parametrize("h,w,blk", [(64, 64, (32, 32)), (128, 256, (64, 128))])
def test_torch_mandelbrot_bit_equal_to_pallas_and_oracle(h, w, blk):
    got = mandelbrot_ref(h, w, 32).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(pallas_mandelbrot(height=h, width=w, max_iter=32, block=blk, interpret=True)))
    np.testing.assert_array_equal(got, np.asarray(jax_mandelbrot_ref(h, w, 32)))
    # the kernel's decomposition gives the same counts
    np.testing.assert_array_equal(
        mandelbrot_blocked_ref(h, w, 32, MANDEL_K0, MANDEL_K).numpy(), got)


# max_iter ends at 0, inside the warm-up, one short of a block, one past
# it, in a tail of single steps (36 = 8 + 3 x 8 + 4), on and off a whole
# number of blocks; 37 x 53 is a multiple of neither the warp tile nor any
# block.
MANDEL_EDGES = sorted({0, 1, MANDEL_K - 1, MANDEL_K + 1, 36})


@pytest.mark.parametrize("h,w", [(64, 64), (128, 256), (37, 53)])
@pytest.mark.parametrize("max_iter", sorted({*MANDEL_EDGES, 64, 100}))
def test_torch_mandelbrot_blocked_ref_bit_equal_to_plain(h, w, max_iter):
    got = mandelbrot_blocked_ref(h, w, max_iter, MANDEL_K0, MANDEL_K)
    np.testing.assert_array_equal(got.numpy(), mandelbrot_ref(h, w, max_iter).numpy())


@pytest.mark.parametrize("h,w,blk", [(64, 64, (32, 32)), (128, 256, (64, 128))])
@pytest.mark.parametrize("max_iter", MANDEL_EDGES)
def test_torch_mandelbrot_blocked_ref_bit_equal_to_pallas(h, w, blk, max_iter):
    want = np.asarray(pallas_mandelbrot(height=h, width=w, max_iter=max_iter, block=blk,
                                        interpret=True))
    np.testing.assert_array_equal(
        mandelbrot_blocked_ref(h, w, max_iter, MANDEL_K0, MANDEL_K).numpy(), want)


def _fma(a: np.float32, b: np.float32, c: np.float32) -> np.float32:
    """a * b + c rounded once to f32 (the f32 product is exact in f64)."""
    return np.float32(np.float64(a) * np.float64(b) + np.float64(c))


def _orbit_count(cr: np.float32, ci: np.float32, max_iter: int, fused: bool = False) -> int:
    """One pixel's count, each operation rounded to f32 on its own, or
    with ``fused`` zi's update 2 zr x zi + ci one FMA."""
    f = np.float32
    zr = zi = f(0)
    for n in range(max_iter):
        zr2, zi2 = f(zr * zr), f(zi * zi)
        if not f(zr2 + zi2) <= 4:
            return n
        two_zr = f(f(2) * zr)
        zr, zi = f(f(zr2 - zi2) + cr), _fma(two_zr, zi, ci) if fused else f(f(two_zr * zi) + ci)
    return max_iter


# At 64 and 100 iterations the Pallas kernel in interpret mode differs
# from the plain version at a few pixels: XLA's CPU compiler fuses each
# pixel coordinate x0 + col * dx, and zi's update 2 zr x zi + ci, into one
# FMA.  Every such pixel has a fused coordinate that differs from the
# separately rounded one, and the orbit with those FMAs gives Pallas's
# count; rounded per operation, the decomposition's.  E.g. (64, 64), 64
# iterations, pixel (19, 49): cr 0.3333335 rounded per operation,
# 0.33333337 fused; counts 41 and 43.
@pytest.mark.parametrize("h,w,blk", [(64, 64, (32, 32)), (128, 256, (64, 128))])
@pytest.mark.parametrize("max_iter", [64, 100])
def test_torch_mandelbrot_pallas_differs_only_by_fused_coordinates(h, w, blk, max_iter):
    got = mandelbrot_blocked_ref(h, w, max_iter, MANDEL_K0, MANDEL_K).numpy()
    pallas = np.asarray(pallas_mandelbrot(height=h, width=w, max_iter=max_iter, block=blk,
                                          interpret=True))
    dx, dy = pixel_step(-2.0, 1.0, w), pixel_step(-1.5, 1.5, h)
    differ = np.argwhere(got != pallas)
    assert 0 < len(differ) < 32
    f = np.float32
    for row, col in differ:
        cr, ci = f(f(-2.0) + f(f(col) * dx)), f(f(-1.5) + f(f(row) * dy))
        cr_fused, ci_fused = _fma(f(col), dx, f(-2.0)), _fma(f(row), dy, f(-1.5))
        assert (cr, ci) != (cr_fused, ci_fused), (row, col)
        assert _orbit_count(cr, ci, max_iter) == got[row, col], (row, col)
        assert _orbit_count(cr_fused, ci_fused, max_iter, fused=True) == pallas[row, col], \
            (row, col)


@pytest.mark.parametrize("K0,K", [(0, 1), (0, 4), (3, 5), (8, 16), (70, 8)])
def test_torch_mandelbrot_blocked_ref_takes_any_split(K0, K):
    """Warm-ups and blocks of other lengths, longer than max_iter among
    them, count the same as the plain version."""
    for max_iter in (0, 5, 64):
        np.testing.assert_array_equal(mandelbrot_blocked_ref(37, 53, max_iter, K0, K).numpy(),
                                      mandelbrot_ref(37, 53, max_iter).numpy())


def test_torch_mandelbrot_blocked_ref_escapes_inside_a_block():
    """The image has pixels that escape at every step of a block after the
    warm-up, so the kept sums' first failing step is exercised."""
    counts = mandelbrot_ref(128, 256, 64)
    assert set(range(MANDEL_K0, MANDEL_K0 + MANDEL_K)) <= set(counts.unique().tolist())


@pytest.mark.parametrize("h,w,block,grid,want", [
    # the default grid: 8 columns x 4 rows of pixels a thread, at least
    # 4 blocks for each of the H100's 132 SMs
    (4096, 4096, (32, 8), None, (16, 128, 32, 8)),
    # fewer pixels a thread where 8 x 4 would leave fewer blocks: 2 x 2
    (1024, 1024, (32, 8), None, (16, 64, 32, 8)),
    # one pixel a thread, and still fewer blocks than 4 an SM
    (100, 300, None, None, (10, 13, 32, 8)),
    (1, 4096, (1024, 1), None, (4, 1, 1024, 1)),
    # a caller's grid and block are taken as they are
    (4096, 4096, (8, 32), (3, 2), (3, 2, 8, 32)),
    (100, 300, (1, 1), (1, 1), (1, 1, 1, 1)),
])
def test_torch_mandelbrot_geometry(h, w, block, grid, want):
    assert mandel_kernel.geometry(h, w, block, grid, sms=132) == want


def test_torch_mandelbrot_geometry_keeps_a_few_blocks_an_sm():
    # 8 x 4 pixels a thread give 2,048 blocks: enough for 132 SMs, not 600;
    # 4 x 4 give 4,096
    assert mandel_kernel.geometry(4096, 4096, (32, 8), sms=600) == (32, 128, 32, 8)


@pytest.mark.parametrize("block,grid", [((0, 1), None), ((1024, 2), None), (None, (0, 1)),
                                        (None, (1, 65536))])
def test_torch_mandelbrot_geometry_refuses_bad_dims(block, grid):
    with pytest.raises(ValueError):
        mandel_kernel.geometry(64, 64, block, grid, sms=132)


def test_torch_mandelbrot_interior_hits_max_iter():
    it = mandel_ops.mandelbrot(torch.tensor([64, 64], dtype=torch.int32), max_iter=24)
    assert it.dtype == torch.int32 and it.shape == (64, 64)
    assert int(it[32, 21]) == 24  # c approx (-1, 0): inside the set


def test_torch_mandelbrot_pixel_step_is_the_reference_f32_quotient():
    assert pixel_step(-2.0, 1.0, 64) == np.float32(3.0 / 63)
    assert pixel_step(-1.5, 1.5, 1) == np.float32(3.0)  # one pixel: no division by 0


def test_torch_mandelbrot_registry_takes_a_size_buffer_value():
    size = torch.tensor([16, 32], dtype=torch.int32)
    np.testing.assert_array_equal(mandel_ops.KERNELS["mandelbrot_ref"](size).numpy(),
                                  mandelbrot_ref(16, 32).numpy())


# ---------------------------------------------------------------------------
# dispatch, wrappers and the build (CPU-side)
# ---------------------------------------------------------------------------


def test_torch_cpu_tensor_takes_plain_version_and_counts_no_launch():
    reset_launch_counts()
    x = torch.linspace(-3, 3, 256)
    torch.testing.assert_close(stencil_ops.stencil(x), stencil_ref(x), rtol=0, atol=0)
    torch.testing.assert_close(map_ops.partition_map(x), partition_map_ref(x), rtol=0, atol=0)
    mandel_ops.mandelbrot(torch.tensor([8, 8], dtype=torch.int32))
    assert launch_counts() == {"flash_attention": 0, "mandelbrot": 0, "paged_attention": 0,
                               "partition_map": 0, "ssd_scan": 0, "stencil": 0}


@pytest.mark.parametrize("impl", ["pallas", "fast", ""])
def test_torch_ops_refuse_unknown_impl(impl):
    x = torch.zeros(8)
    for call in (lambda: stencil_ops.stencil(x, impl=impl),
                 lambda: map_ops.partition_map(x, impl=impl),
                 lambda: mandel_ops.mandelbrot(torch.tensor([8, 8]), impl=impl)):
        with pytest.raises(ValueError, match="impl="):
            call()


def test_torch_wrappers_refuse_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="CUDA tensor"):
        stencil_ops.stencil(torch.zeros(8), impl="cuda")  # never a silent CPU fallback
    with pytest.raises(ValueError, match="CUDA tensor"):
        map_ops.partition_map(torch.zeros(8), impl="cuda")
    with pytest.raises(ValueError, match="CUDA device"):
        mandel_ops.mandelbrot(torch.tensor([8, 8]), impl="cuda")
    with pytest.raises(TypeError, match="torch.Tensor"):
        _launch.check_cuda_1d(np.zeros(8, np.float32), "stencil")
    assert stencil_kernel.launches == 0


@pytest.mark.parametrize("n,block,grid,want", [
    (1000, None, None, (4, 256)),
    (1000, (128, 1, 1), None, (8, 128)),
    (1000, 32, (2, 1, 1), (2, 32)),   # a small grid: the kernel loops
    (1, (1024,), None, (1, 1024)),
])
def test_torch_geometry_1d(n, block, grid, want):
    assert _launch.geometry_1d(n, block, grid) == want


@pytest.mark.parametrize("block,grid", [((0, 1, 1), None), ((2048, 1, 1), None), (None, (0, 1, 1))])
def test_torch_geometry_1d_refuses_bad_dims(block, grid):
    with pytest.raises(ValueError):
        _launch.geometry_1d(64, block, grid)


def test_torch_build_target_follows_source_and_dir(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    t1 = _build._target("stencil")
    assert t1.parent == tmp_path and t1.name.startswith("libstencil-") and t1.suffix == ".so"
    assert _build._target("stencil") == t1  # stable for the same source
    assert _build._target("mandelbrot") != t1
    assert "--use_fast_math" not in _build.FLAGS and "arch=compute_90a,code=sm_90a" in _build.FLAGS


def test_torch_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def test_torch_check_raises_on_cuda_error():
    class _Lib:
        @staticmethod
        def kernel_error_string(err):
            return b"invalid configuration argument"

    _build.check(_Lib, 0, "stencil")
    with pytest.raises(RuntimeError, match="stencil: CUDA error 9 .invalid configuration"):
        _build.check(_Lib, 9, "stencil")


def test_torch_tally_launches_counts_the_named_stream_from_any_thread(monkeypatch):
    """A capture's tally counts the launches made on its stream, by any
    thread (autograd's device thread issues a backward's kernels on the
    stream of their forward), and none made on another stream."""
    import threading
    import types

    current = threading.local()
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=current.handle))
    note_launch("stencil")  # no block open: nothing to tally, and no stream asked for
    cap = types.SimpleNamespace(cuda_stream=7)

    def launch(handle, package):
        current.handle = handle
        note_launch(package)

    with tally_launches(cap) as recorded:
        launch(7, "flash_attention")
        other = threading.Thread(target=launch, args=(7, "ssd_scan"))
        other.start()
        other.join()
        launch(8, "stencil")  # another stream
    launch(7, "flash_attention")  # after the block
    assert recorded == {"flash_attention": 1, "ssd_scan": 1}
