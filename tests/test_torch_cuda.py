"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and ``nvcc`` (the hand-written kernels have
no CPU mode): they carry the ``cuda`` marker and skip without a card.  The
file imports no JAX, so it also runs where only PyTorch is installed
(graph capture and the paged decode lane's CUDA graphs included):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import ctypes
import os
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, smoke
from repro_torch.core import (HOST_KEY, Promise, Scheduler, get_all_devices, registry,
                              reset_runtime, wait_all)
from repro_torch.kernels import _build, launch_counts, reset_launch_counts
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import bf16_bound, flash_attention_ref
from repro_torch.kernels.mandelbrot import kernel as mandel_kernel
from repro_torch.kernels.mandelbrot import ops as mandel_ops
from repro_torch.kernels.mandelbrot.ref import mandelbrot_blocked_ref, mandelbrot_ref
from repro_torch.kernels.paged_attention import kernel as paged_kernel
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.kernels.paged_attention.ref import bf16_bound as paged_bf16_bound
from repro_torch.kernels.paged_attention.ref import paged_attention_ref, paged_attention_split_ref
from repro_torch.kernels.partition_map import ops as map_ops
from repro_torch.kernels.partition_map.ref import partition_map_ref
from repro_torch.kernels.stencil import ops as stencil_ops
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import ssd_ref, ssd_three_pass
from repro_torch.kernels.stencil.ref import stencil_ref
from repro_torch.models import get_model
from repro_torch.models import layers as model_layers
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.ssm import ssd_chunked
from repro_torch.serving import PagedKVCache, PagedServeEngine, PageSpec
from repro_torch.serving.paged import _PagedRequest

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# About 0.1 s of device time on an H100: long enough that work queued
# behind it on one stream is still pending when another stream moves on.
SLEEP_CYCLES = 200_000_000


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_cuda_elementwise_kernels_match_plain(dtype):
    _need_cuda()
    reset_launch_counts()
    td = DTYPES[dtype]
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(1 << 20,)).astype(np.float32))
    x = x.to("cuda", td)
    # f32: the kernel rounds each op as eager PyTorch does.  bf16: the
    # kernel sums in f32 and rounds once, eager PyTorch rounds every op to
    # bf16, so they differ by a few bf16 ulps of terms up to ~5.
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == "float32" else dict(rtol=2e-2, atol=5e-2)
    torch.testing.assert_close(stencil_ops.stencil(x).float(), stencil_ref(x).float(), **tol)
    x100 = x * 100
    y = map_ops.partition_map(x100, block=(128, 1, 1), grid=(64, 1, 1))
    # The kernel computes in f32 with the precise sinf/cosf and rounds each
    # operation once, as the plain version does in f32: bit for bit.  The
    # plain f32 result strays from 1 by up to 1.2e-7, so a kernel that wrote
    # 1 (or left stale ones) fails.
    want = partition_map_ref(x100.float())
    assert bool((want != 1).any())
    torch.testing.assert_close(y, want.to(td), rtol=0, atol=0)
    torch.testing.assert_close(y.float(), torch.ones_like(y, dtype=torch.float32),
                               rtol=0, atol=1e-5 if dtype == "float32" else 2e-2)
    assert launch_counts()["stencil"] == 1 and launch_counts()["partition_map"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,it", [(64, 64, 32), (128, 256, 32), (512, 512, 64)])
def test_torch_cuda_mandelbrot_bit_equal_to_plain(h, w, it):
    _need_cuda()
    size = torch.tensor([h, w], dtype=torch.int32, device="cuda")
    got = mandel_ops.mandelbrot(size, max_iter=it)
    torch.testing.assert_close(got, mandelbrot_ref(h, w, it, device="cuda"), rtol=0, atol=0)
    # and equal to the plain version on the CPU, which the CPU tests hold
    # bit-equal to the JAX package at the reference's sizes
    np.testing.assert_array_equal(got.cpu().numpy(), mandelbrot_ref(h, w, it).numpy())


# The kernel's warm-up and block lengths (K0 and K of csrc/mandelbrot.cu):
# max_iter ends inside the warm-up, one short of a block, one past it, in
# a tail of single steps, on and off a whole number of blocks.
MANDEL_K0, MANDEL_K = 8, 8
MANDEL_ITERS = sorted({0, 1, MANDEL_K - 1, MANDEL_K + 1, 36, 64, 100})


@pytest.mark.cuda
def test_torch_cuda_mandelbrot_library_reports_its_block_steps():
    _need_cuda()
    assert mandel_kernel.block_steps() == (MANDEL_K0, MANDEL_K)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(100, 300), (1, 4096)])
@pytest.mark.parametrize("it", MANDEL_ITERS)
def test_torch_cuda_mandelbrot_max_iter_edges(h, w, it):
    _need_cuda()
    got = mandel_kernel.mandelbrot(h, w, it, device="cuda")
    torch.testing.assert_close(got, mandelbrot_ref(h, w, it, device="cuda"), rtol=0, atol=0)
    np.testing.assert_array_equal(
        got.cpu().numpy(), mandelbrot_blocked_ref(h, w, it, MANDEL_K0, MANDEL_K).numpy())


def _sms() -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


@pytest.mark.cuda
@pytest.mark.parametrize("block", [(1, 1), (1024, 1), (8, 32), (32, 8)])
@pytest.mark.parametrize("grid", [None, (1, 1), (3, 2)])
def test_torch_cuda_mandelbrot_honours_the_callers_geometry(block, grid):
    """Any block, tiled into 8 x 4 warps or not, and grids far smaller than
    the image (the grid-stride loop covers it) give the plain version's
    image."""
    _need_cuda()
    want = mandelbrot_ref(100, 300, 64, device="cuda")
    got = mandel_kernel.mandelbrot(100, 300, 64, device="cuda", block=block, grid=grid)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert mandel_kernel.last_geometry == mandel_kernel.geometry(100, 300, block, grid,
                                                                 sms=_sms())
    if grid is not None:
        assert mandel_kernel.last_geometry[:2] == grid


def _ids(shape, rule) -> "torch.Tensor":
    rows, cols = torch.meshgrid(torch.arange(shape[0]), torch.arange(shape[1]), indexing="ij")
    return rule(rows, cols).to(torch.int64)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,block,grid,rule", [
    # a block of whole 8 x 4 tiles: each warp takes one tile
    ((8, 32), (32, 8), (1, 1), lambda r, c: (r // 4 * 4 + c // 8) << 32),
    ((8, 32), (8, 32), (4, 1), lambda r, c: (c // 8 * 8 + r // 4) << 32),
    # else 32 threads in order along the block's rows
    ((8, 32), (32, 2), (1, 4), lambda r, c: (r // 2 * 2 + r % 2) << 32),
    # rows 8-15 are each thread's second pass of the grid-stride loop
    ((16, 32), (32, 8), (1, 1), lambda r, c: (r % 8 // 4 * 4 + c // 8) << 32 | r // 8),
    # one thread: a pass for each pixel
    ((4, 4), (1, 1), (1, 1), lambda r, c: r * 4 + c),
])
def test_torch_cuda_mandelbrot_library_reports_its_warp_rounds(shape, block, grid, rule):
    _need_cuda()
    got = mandel_kernel.warp_rounds(*shape, device="cuda", block=block, grid=grid)
    torch.testing.assert_close(got.cpu(), _ids(shape, rule), rtol=0, atol=0)


@pytest.mark.cuda
def test_torch_cuda_mandelbrot_repeats_bit_for_bit_one_launch_a_call():
    _need_cuda()
    reset_launch_counts()
    first = mandel_kernel.mandelbrot(512, 768, 64, device="cuda")
    assert launch_counts()["mandelbrot"] == 1
    second = mandel_kernel.mandelbrot(512, 768, 64, device="cuda")
    assert launch_counts()["mandelbrot"] == 2
    torch.testing.assert_close(first, second, rtol=0, atol=0)
    torch.testing.assert_close(first, mandelbrot_ref(512, 768, 64, device="cuda"),
                               rtol=0, atol=0)
    # reading the warp rounds launches no mandelbrot kernel
    mandel_kernel.warp_rounds(512, 768, device="cuda")
    assert launch_counts()["mandelbrot"] == 2


@pytest.mark.cuda
def test_torch_cuda_build_loads_every_library():
    _need_cuda()
    libs = _build.load_all()
    assert set(libs) == set(_build.NAMES)
    assert all(isinstance(lib, ctypes.CDLL) for lib in libs.values())


@pytest.mark.cuda
@pytest.mark.parametrize("reader", ["read", "launch"])
def test_torch_cuda_write_after_read_on_another_stream_sees_old_data(reader):
    """A read or launch dispatched on stream A, held back on the device, is
    not overtaken by an in-place write on stream B."""
    _need_cuda()
    dev = get_all_devices(1, 0).get()[0]
    prog = dev.create_program({"double": lambda x: x * 2.0}, name="war").get()
    a, b = dev.create_stream(), dev.create_stream()
    old = np.arange(1 << 20, dtype=np.float32)
    buf = dev.create_buffer_from(old).get()
    out = dev.create_buffer(1 << 20, np.float32).get()
    a.submit(torch.cuda._sleep, SLEEP_CYCLES)  # hold stream A on the device
    if reader == "read":
        fut = a.enqueue_read(buf)
    else:
        fut = a.launch(prog, [buf], "double", out=[out], sync="dispatch")
    a.submit(lambda: None).get()  # stream A's lane has dispatched the reader
    b.enqueue_write(buf, 0, np.zeros_like(old)).get()
    got = fut.get() if reader == "read" else out.enqueue_read_sync()
    np.testing.assert_array_equal(got, old if reader == "read" else old * 2)
    np.testing.assert_array_equal(buf.enqueue_read_sync(), np.zeros_like(old))


@pytest.mark.cuda
def test_torch_cuda_create_buffer_from_pinned_resolves_after_its_copy():
    _need_cuda()
    dev = get_all_devices(1, 0).get()[0]
    src = torch.arange(1 << 20, dtype=torch.float32).pin_memory()
    want = src.clone()
    dev.default_stream.submit(torch.cuda._sleep, SLEEP_CYCLES)  # hold the copy back
    buf = dev.create_buffer_from(src).get()
    src.zero_()  # the future said the copy is done: the source is free again
    np.testing.assert_array_equal(buf.enqueue_read_sync(), want.numpy())


# ---------------------------------------------------------------------------
# the moe, vlm and encdec families, and starcoder2's GQA, at smoke size
# ---------------------------------------------------------------------------

ZOO_CARD = ["qwen2-moe-a2.7b", "qwen2-vl-72b", "starcoder2-7b", "whisper-tiny"]


def _zoo_cfg(arch):
    cfg = smoke(get_config(arch))
    if arch == "starcoder2-7b":  # StarCoder2-7B's 36 heads over 4 kv heads: R 9 through flash
        import dataclasses

        cfg = dataclasses.replace(cfg, num_heads=36, num_kv_heads=4)
    return cfg


def _zoo_batch(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    b = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))).cuda()}
    if cfg.family == "vlm":
        b["patch_embeds"] = torch.from_numpy(
            rng.normal(0, 0.02, (B, cfg.num_patches, cfg.d_model)).astype(np.float32)).cuda()
        b["positions"] = torch.from_numpy(rng.integers(0, S, (3, B, S))).cuda()
    if cfg.family == "encdec":
        b["frames"] = torch.from_numpy(
            rng.normal(0, 0.02, (B, cfg.encdec.encoder_seq, cfg.d_model)).astype(np.float32)).cuda()
    return b


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ZOO_CARD)
def test_torch_cuda_zoo_prefill_and_paged_decode_match_plain(arch):
    """On the card, smoke size, f32 with TF32 off: the prefill's attention
    runs flash (once a layer; whisper's encoder layers too, non-causal)
    and the paged decode step paged_attention (once a layer), each within
    1e-4 of the plain path (``impl="ref"``), which launches neither."""
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _zoo_cfg(arch)
    m = get_model(cfg)
    params = m.init(cfg, generator=torch.Generator(device="cuda").manual_seed(0), device="cuda")
    b = _zoo_batch(cfg, 2, 40)
    ex = {k: v for k, v in b.items() if k != "tokens"} or None
    reset_launch_counts()
    k, v, state, got = m.paged_prefill(cfg, params, b["tokens"], ex)
    enc = cfg.encdec.encoder_layers if cfg.encdec else 0
    assert launch_counts()["flash_attention"] == cfg.num_layers + enc
    assert flash_kernel.noncausal_launches == enc  # the encoder's, counted apart
    k2, v2, state2, want = m.paged_prefill(cfg, params, b["tokens"], ex, impl="ref")
    assert launch_counts()["flash_attention"] == cfg.num_layers + enc
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(k, k2, rtol=1e-4, atol=1e-4)
    for n in state or {}:
        torch.testing.assert_close(state[n], state2[n], rtol=1e-4, atol=1e-4)

    spec = m.paged_spec(cfg)
    P, T = spec.page_size, k.shape[2]
    n = -(-(T + 1) // P)
    shape = (spec.layers, 1 + 2 * n, P, spec.kv_heads, spec.head_dim)
    kp = torch.zeros(shape, device="cuda")
    vp = torch.zeros(shape, device="cuda")
    tbl = torch.arange(1, 1 + 2 * n, dtype=torch.int32, device="cuda").view(2, n)
    for r in range(2):  # each row's prefill KV into its pages, in order
        for pages, rows in ((kp, k[r]), (vp, v[r])):
            padded = torch.zeros((spec.layers, n * P, *shape[3:]), device="cuda")
            padded[:, :T] = rows
            pages[:, tbl[r].long()] = padded.view(spec.layers, n, P, *shape[3:])
    lens = torch.full((2,), T, dtype=torch.int32, device="cuda")
    tok = torch.argmax(got, dim=-1).to(torch.int32)
    reset_launch_counts()
    outs = {}
    for impl in ("auto", "ref"):
        kpi, vpi = kp.clone(), vp.clone()
        st = None if state is None else {nm: t.clone() for nm, t in state.items()}
        outs[impl] = m.paged_decode_step(cfg, params, kpi, vpi, st, tok, lens, tbl, lens,
                                         impl=impl)
        assert launch_counts()["paged_attention"] == cfg.num_layers
    torch.testing.assert_close(outs["auto"][3], outs["ref"][3], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(outs["auto"][0], outs["ref"][0], rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_torch_cuda_moe_paged_decode_step_captures_into_a_graph():
    """One qwen2-moe paged decode step (4 rows, dispatched per row) records
    into a CUDA graph, which raises on any host sync under capture, and its
    replay gives the eager step's logits and pages bit for bit."""
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = smoke(get_config("qwen2-moe-a2.7b"))
    m = get_model(cfg)
    params = m.init(cfg, generator=torch.Generator(device="cuda").manual_seed(0), device="cuda")
    spec = m.paged_spec(cfg)
    rng = np.random.default_rng(2)
    shape = (spec.layers, 9, spec.page_size, spec.kv_heads, spec.head_dim)
    kp0 = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).cuda()
    vp0 = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).cuda()
    tbl = torch.tensor([[1, 2], [3, 4], [5, 6], [7, 8]], dtype=torch.int32, device="cuda")
    lens = torch.tensor([16, 20, 3, 31], dtype=torch.int32, device="cuda")
    tok = torch.tensor([3, 7, 11, 200], dtype=torch.int32, device="cuda")
    kp, vp = kp0.clone(), vp0.clone()
    m.paged_decode_step(cfg, params, kp, vp, None, tok, lens, tbl, lens)  # warm-up, eager
    kp.copy_(kp0)
    vp.copy_(vp0)
    want = m.paged_decode_step(cfg, params, kp, vp, None, tok, lens, tbl, lens)[3].clone()
    want_k = kp.clone()
    kp.copy_(kp0)
    vp.copy_(vp0)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        graph.capture_begin(capture_error_mode="thread_local")
        out = m.paged_decode_step(cfg, params, kp, vp, None, tok, lens, tbl, lens)
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    kp.copy_(kp0)
    vp.copy_(vp0)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out[3], want) and torch.equal(kp, want_k)


# ---------------------------------------------------------------------------
# the hybrid family (hymba-1.5b): a deeper smoke with a KV-consuming layer
# ---------------------------------------------------------------------------


def _hybrid_cfg():
    """hymba-1.5b's smoke at 6 layers, global layers 0 and 5: producers 0,
    1, 2, 4, 5, consumer 3; 4 meta tokens, window 16."""
    import dataclasses

    return dataclasses.replace(smoke(get_config("hymba-1.5b")), num_layers=6,
                               global_attn_layers=(0, 5))


@pytest.mark.cuda
@pytest.mark.parametrize("S", [10, 40])
def test_torch_cuda_hybrid_prefill_and_paged_decode_match_plain(S):
    """On the card, f32 with TF32 off: a hybrid prefill runs flash on every
    layer while meta + S fits the window (14 tokens) and on the 2 global
    layers past it (44 tokens: the SWA layers pad to windows, plain), and
    ssd_scan on every layer (3 kernels a call); the paged decode step runs
    paged_attention on the global layers only.  Each within 1e-4 of the
    plain path (``impl="ref"``), which launches none of them."""
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _hybrid_cfg()
    m = get_model(cfg)
    params = m.init(cfg, generator=torch.Generator(device="cuda").manual_seed(0), device="cuda")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, S))).cuda()
    reset_launch_counts()
    k, v, state, got = m.paged_prefill(cfg, params, tokens)
    flash = cfg.num_layers if S + cfg.meta_tokens <= cfg.sliding_window else 2
    counts = launch_counts()
    assert counts["flash_attention"] == flash and counts["ssd_scan"] == cfg.num_layers
    assert ssd_kernel.kernel_launches == 3 * cfg.num_layers
    k2, v2, state2, want = m.paged_prefill(cfg, params, tokens, impl="ref")
    assert launch_counts() == counts
    for a, b in ((got, want), (k, k2), (v, v2), *((state[n], state2[n]) for n in state)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)

    spec = m.paged_spec(cfg)
    P, T = spec.page_size, k.shape[2]
    n = -(-(T + 1) // P)
    shape = (spec.layers, 1 + 2 * n, P, spec.kv_heads, spec.head_dim)
    kp = torch.zeros(shape, device="cuda")
    vp = torch.zeros(shape, device="cuda")
    tbl = torch.arange(1, 1 + 2 * n, dtype=torch.int32, device="cuda").view(2, n)
    for r in range(2):  # each row's prefill KV into its pages, in order
        for pages, rows in ((kp, k[r]), (vp, v[r])):
            padded = torch.zeros((spec.layers, n * P, *shape[3:]), device="cuda")
            padded[:, :T] = rows
            pages[:, tbl[r].long()] = padded.view(spec.layers, n, P, *shape[3:])
    lens = torch.full((2,), T, dtype=torch.int32, device="cuda")
    tok = torch.argmax(got, dim=-1).to(torch.int32)
    outs = {}
    for impl in ("auto", "ref"):
        reset_launch_counts()
        st = {nm: t.clone() for nm, t in state.items()}
        outs[impl] = m.paged_decode_step(cfg, params, kp.clone(), vp.clone(), st, tok, lens, tbl,
                                         lens, impl=impl)
        assert launch_counts()["paged_attention"] == (2 if impl == "auto" else 0)
    for a, b in zip(outs["auto"], outs["ref"]):
        for x, y in ((a, b),) if torch.is_tensor(a) else ((a[n], b[n]) for n in a):
            torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_torch_cuda_hybrid_paged_decode_step_captures_into_a_graph():
    """One hybrid paged decode step (4 rows, rings rebuilt from the pages,
    SSM state advanced) records into a CUDA graph, which raises on any host
    sync under capture, and its replay gives the eager step's logits, pages
    and state bit for bit."""
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _hybrid_cfg()
    m = get_model(cfg)
    params = m.init(cfg, generator=torch.Generator(device="cuda").manual_seed(0), device="cuda")
    spec = m.paged_spec(cfg)
    rng = np.random.default_rng(2)
    shape = (spec.layers, 9, spec.page_size, spec.kv_heads, spec.head_dim)
    kp0 = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).cuda()
    vp0 = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).cuda()
    one = m.init_cache(cfg, 4, 32, device="cuda", dtype=torch.float32)
    state = {n: torch.from_numpy(rng.standard_normal(tuple(one[n].movedim(0, 1).shape),
                                                     dtype=np.float32)).cuda()
             for n in ("ssm_state", "ssm_conv")}
    tbl = torch.tensor([[1, 2], [3, 4], [5, 6], [7, 8]], dtype=torch.int32, device="cuda")
    lens = torch.tensor([16, 20, 3, 31], dtype=torch.int32, device="cuda")  # 20, 31 wrap the ring
    tok = torch.tensor([3, 7, 11, 200], dtype=torch.int32, device="cuda")

    def step():
        return m.paged_decode_step(cfg, params, kp, vp, state, tok, lens, tbl, lens)

    kp, vp = kp0.clone(), vp0.clone()
    step()  # warm-up, eager
    kp.copy_(kp0)
    vp.copy_(vp0)
    _, _, want_state, want = step()  # the input state is read, never written
    want_k = kp.clone()
    kp.copy_(kp0)
    vp.copy_(vp0)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        graph.capture_begin(capture_error_mode="thread_local")
        out = step()
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    kp.copy_(kp0)
    vp.copy_(vp0)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out[3], want) and torch.equal(kp, want_k)
    assert all(torch.equal(out[2][n], want_state[n]) for n in want_state)


@pytest.mark.cuda
def test_torch_cuda_hybrid_kernels_at_hymba_heads():
    """The three kernels at Hymba-1.5B's head geometry, at short lengths:
    flash with 25 heads over 5 of 64 (GQA ratio 5, f32, causal, after a
    128-token meta prefix: 300 tokens); ssd_scan with 50 heads, P 64, N 16,
    one group; paged_attention with 25 heads over 5 of 64 in f32, on the
    vector loads.  Each against its plain version."""
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("hymba-1.5b")
    H, K, D = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    g = torch.Generator(device="cuda").manual_seed(3)
    q = torch.randn(2, 300, H, D, device="cuda", generator=g)
    k, v = (torch.randn(2, 300, K, D, device="cuda", generator=g) for _ in range(2))
    torch.testing.assert_close(flash_kernel.flash_attention(q, k, v, causal=True),
                               flash_attention_ref(q, k, v, causal=True), rtol=2e-4, atol=2e-4)
    s = cfg.ssm
    x, dt, A, B, C = _ssd_inputs(2, 300, s.n_heads(cfg.d_model), s.n_groups, s.head_dim, s.d_state,
                                 seed=4)
    y, st = ssd_kernel.ssd_scan(x, dt, A, B, C)
    y2, st2 = ssd_chunked(x, dt, A, B, C, s.chunk)
    torch.testing.assert_close(y, y2, rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(st, st2, rtol=2e-3, atol=2e-3)
    lengths = [828, 859, 2128, 2159]
    P, M = 16, 135
    N = 1 + sum(-(-n // P) for n in lengths)
    kp, vp = (torch.randn(N, P, K, D, device="cuda", generator=g) for _ in range(2))
    tbl = torch.zeros((4, M), dtype=torch.int32)
    nxt = 1
    for b, n in enumerate(lengths):
        pages = -(-n // P)
        tbl[b, :pages] = torch.arange(nxt, nxt + pages)
        nxt += pages
    tbl, lens = tbl.cuda(), torch.tensor(lengths, dtype=torch.int32, device="cuda")
    qd = torch.randn(4, H, D, device="cuda", generator=g)
    got = paged_kernel.paged_attention(qd, kp, vp, tbl, lens)
    assert paged_kernel.last_load_width == 4
    torch.testing.assert_close(got, paged_attention_ref(qd, kp, vp, tbl, lens), rtol=1e-5,
                               atol=1e-5)


# (B, Sq, Skv, H, K, D): the reference's cases (tests/test_kernels.py:115),
# then ragged lengths that are no multiple of the kernel's tiles,
# causal with Sq != Skv, the serving head dim 128, and whisper-tiny's encoder
# (S 1500, H = K = 6, D 64; non-causal in the model).
FLASH_CASES = [
    (1, 128, 128, 4, 4, 64),
    (2, 256, 256, 8, 2, 32),
    (1, 128, 256, 4, 1, 64),
    (2, 100, 100, 4, 2, 16),
    (1, 200, 200, 4, 4, 128),
    (2, 100, 200, 8, 2, 64),
    (1, 200, 100, 4, 1, 32),
    (1, 1000, 1000, 2, 2, 128),
    (4, 1500, 1500, 6, 6, 64),
]


def _qkv(B, Sq, Skv, H, K, D, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to("cuda", DTYPES[dtype])
            for shape in ((B, Sq, H, D), (B, Skv, K, D), (B, Skv, K, D))]


def _assert_within_bf16_bound(got, want, q, k, v, causal):
    """Per element within ``bf16_bound``: the weights are rounded to bf16
    before P.V in both, at different points of the online softmax, and the
    outputs once each."""
    err = (got.float() - want.float()).abs()
    bound = bf16_bound(q, k, v, want, causal=causal)
    assert bool((err <= bound).all()), (
        f"{int((err > bound).sum())} elements past the bf16 bound, up to "
        f"{float((err / bound).max())} of it")


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_cuda_flash_attention_matches_plain(case, causal, dtype):
    """The kernel against its plain version on the same inputs: 2e-4 in f32
    (the reference's tolerance; both sum in f32, in other orders), and in
    bf16 ``bf16_bound`` per element, about 2**-7 of each output's scale."""
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full f32
    q, k, v = _qkv(*case, dtype)
    _assert_flash_close(flash_kernel.flash_attention(q, k, v, causal=causal), q, k, v, causal)


@pytest.mark.cuda
def test_torch_cuda_flash_attention_takes_strided_views():
    """(B, S, H, D) views of a (B, S, H*D) projection and (B, H, S, D)
    tensors seen through a transpose give the contiguous result."""
    _need_cuda()
    q, k, v = _qkv(2, 130, 130, 4, 2, 64, "float32", seed=1)
    want = flash_kernel.flash_attention(q, k, v)
    qt, kt, vt = (x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v))
    assert not qt.is_contiguous()
    torch.testing.assert_close(flash_kernel.flash_attention(qt, kt, vt), want, rtol=0, atol=0)
    kv = torch.cat([k, v], dim=-1)  # k and v as interleaved views of one tensor
    got = flash_kernel.flash_attention(q, kv[..., :64], kv[..., 64:])
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.cuda
def test_torch_cuda_flash_attention_refuses_what_it_does_not_take():
    _need_cuda()
    reset_launch_counts()
    q, k, v = _qkv(1, 64, 64, 4, 2, 64, "float32")
    with pytest.raises(ValueError, match="head dim 256"):
        flash_kernel.flash_attention(*_qkv(1, 64, 64, 2, 2, 256, "float32"))
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_ops.flash_attention(q.cpu(), k.cpu(), v.cpu(), impl="cuda")
    with pytest.raises(ValueError, match="not a multiple"):
        flash_kernel.flash_attention(q[:, :, :3], k, v)
    with pytest.raises(TypeError, match="float32 or all bfloat16"):
        flash_kernel.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="contiguous last dimension"):
        flash_kernel.flash_attention(q, k.transpose(-1, -2), v)
    assert launch_counts()["flash_attention"] == 0


@pytest.mark.cuda
def test_torch_cuda_flash_attention_op_launches_the_kernel():
    _need_cuda()
    reset_launch_counts()
    q, k, v = _qkv(1, 100, 100, 4, 4, 32, "bfloat16")
    got = flash_ops.flash_attention(q, k, v, causal=True)
    assert launch_counts()["flash_attention"] == 1
    plain = flash_ops.flash_attention(q, k, v, causal=True, impl="ref")
    assert launch_counts()["flash_attention"] == 1
    _assert_within_bf16_bound(got, plain, q, k, v, True)


def _assert_flash_close(got, q, k, v, causal):
    """Against the plain version: 2e-4 in f32, ``bf16_bound`` in bf16."""
    want = flash_attention_ref(q, k, v, causal=causal)
    assert got.shape == want.shape and got.dtype == q.dtype and got.is_contiguous()
    assert bool(got.isfinite().all())
    if q.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    else:
        _assert_within_bf16_bound(got, want, q, k, v, causal)


# Lengths on both sides of the kernel's tile edges: 16-row mma tiles,
# 32-row warps, 16- and 32-row kv tiles, 128-row query tiles, and the
# serve prompt.
FLASH_LENGTHS = [1, 15, 16, 17, 63, 64, 65, 127, 128, 129, 2000]


@pytest.mark.cuda
@pytest.mark.parametrize("S", FLASH_LENGTHS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_cuda_flash_attention_tile_edges(S, causal, dtype):
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _qkv(1, S, S, 4, 2, 128, dtype, seed=S)
    _assert_flash_close(flash_kernel.flash_attention(q, k, v, causal=causal), q, k, v, causal)


@pytest.mark.cuda
@pytest.mark.parametrize("Sq,Skv", [(100, 300), (1, 77), (300, 100), (129, 1)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_cuda_flash_attention_cross_lengths(Sq, Skv, causal, dtype):
    """Skv > Sq and Skv < Sq; causal keeps kpos <= qpos, both from 0."""
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _qkv(2, Sq, Skv, 4, 1, 64, dtype, seed=Sq + Skv)
    _assert_flash_close(flash_kernel.flash_attention(q, k, v, causal=causal), q, k, v, causal)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_cuda_flash_attention_head_dims(D, dtype):
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _qkv(2, 200, 200, 4, 2, D, dtype, seed=D)
    for causal in (True, False):
        _assert_flash_close(flash_kernel.flash_attention(q, k, v, causal=causal), q, k, v, causal)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_cuda_flash_attention_gqa_nine_heads_a_group(dtype):
    """StarCoder2-7B's 36 query heads on 4 kv heads: R = 9."""
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _qkv(1, 300, 300, 36, 4, 128, dtype, seed=9)
    for causal in (True, False):
        _assert_flash_close(flash_kernel.flash_attention(q, k, v, causal=causal), q, k, v, causal)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_cuda_flash_attention_more_heads_than_one_wave(dtype):
    """B x H = 320 (batch, head) pairs of 2 query tiles each: more blocks
    than 132 SMs hold at once."""
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _qkv(8, 130, 130, 40, 8, 64, dtype, seed=8)
    _assert_flash_close(flash_kernel.flash_attention(q, k, v, causal=True), q, k, v, True)


@pytest.mark.cuda
@pytest.mark.parametrize("Sq,Skv,causal", [(100, 100, True), (77, 100, False)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_cuda_flash_attention_reads_no_row_past_the_lengths(Sq, Skv, causal, dtype):
    """q, k and v as views ``big[:, :S]`` of tensors holding NaN in every
    row past S: the kernel zero-fills those rows of its tiles without
    reading them, so the output is finite and equal to the contiguous run."""
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _qkv(2, Sq, Skv, 4, 2, 64, dtype, seed=5)
    views = []
    for x in (q, k, v):
        big = torch.full((x.shape[0], x.shape[1] + 37, *x.shape[2:]), float("nan"),
                         dtype=x.dtype, device=x.device)
        big[:, :x.shape[1]] = x
        views.append(big[:, :x.shape[1]])
    got = flash_kernel.flash_attention(*views, causal=causal)
    _assert_flash_close(got, q, k, v, causal)
    torch.testing.assert_close(got, flash_kernel.flash_attention(q, k, v, causal=causal),
                               rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_cuda_flash_attention_refuses_unaligned_views(dtype):
    """The kernel copies 16 bytes at a time: a base one element off, or a
    row stride that is no whole number of 16 bytes, raises before any
    launch."""
    _need_cuda()
    reset_launch_counts()
    q, k, v = _qkv(1, 64, 64, 4, 2, 64, dtype)
    wide = torch.zeros(1, 64, 4, 65, dtype=q.dtype, device="cuda")
    off_by_one = wide[..., 1:]  # base one element past a 16-byte boundary
    short_rows = wide[..., :64]  # aligned base, head stride of 65 elements
    for bad in (off_by_one, short_rows):
        with pytest.raises(ValueError, match="16-byte"):
            flash_kernel.flash_attention(bad, k, v)
        with pytest.raises(ValueError, match="16-byte"):
            flash_ops.flash_attention(q, bad[:, :, :2], v)
        with pytest.raises(ValueError, match="16-byte"):
            flash_kernel.flash_attention(q, k, bad[:, :, :2])
    assert launch_counts()["flash_attention"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_cuda_flash_attention_is_deterministic(dtype):
    """Each output element is summed by one thread in a fixed order: two
    launches on the same inputs are bit-equal."""
    _need_cuda()
    q, k, v = _qkv(2, 300, 300, 8, 2, 128, dtype, seed=3)
    first = flash_kernel.flash_attention(q, k, v, causal=True)
    torch.testing.assert_close(flash_kernel.flash_attention(q, k, v, causal=True), first,
                               rtol=0, atol=0)


@pytest.mark.cuda
def test_torch_cuda_params_from_numpy_defaults_to_the_card():
    _need_cuda()
    cfg = smoke(get_config("olmo-1b"))
    shapes = get_model(cfg).param_shapes(cfg)
    tree = model_layers.tree_map(lambda shape: np.ones(shape, np.float32), shapes)
    leaves = []
    model_layers.tree_map(leaves.append, params_from_numpy(cfg, tree))
    assert leaves and all(t.is_cuda and t.dtype == torch.float32 for t in leaves)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["olmo-1b", "stablelm-1.6b", "deepseek-67b"])
def test_torch_cuda_dense_prefill_runs_the_kernel(arch):
    """On the card the prefill's attention goes through the kernel, once per
    layer, and agrees with the plain attention within 1e-4 (f32, TF32 off)."""
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = smoke(get_config(arch))
    m = get_model(cfg)
    params = m.init(cfg, generator=torch.Generator(device="cuda").manual_seed(0), device="cuda")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 70)))
    tokens = tokens.to("cuda")
    reset_launch_counts()
    got, _, kv = m.forward(cfg, params, {"tokens": tokens}, return_kv=True)
    assert launch_counts()["flash_attention"] == cfg.num_layers
    want, _, kv_ref = m.forward(cfg, params, {"tokens": tokens}, return_kv=True, impl="ref")
    assert launch_counts()["flash_attention"] == cfg.num_layers
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(kv["k"], kv_ref["k"], rtol=1e-4, atol=1e-4)


# (Bz, S, H, G, P, N): the reference's cases (tests/test_kernels.py:175, G
# rows as H heads with their own B/C), ragged S (no multiple of the
# kernel's 32-token sub-chunks nor of 256), N 4 / P 8, grouped B/C, and
# one mamba2-130m layer at the serve shape.
SSD_CASES = [
    (1, 64, 2, 2, 16, 8),
    (1, 128, 4, 4, 32, 16),
    (1, 256, 1, 1, 64, 128),
    (2, 1000, 4, 2, 8, 16),
    (1, 77, 3, 3, 8, 4),
    (2, 333, 6, 1, 128, 256),
    (4, 4000, 24, 1, 64, 128),
]


def _ssd_inputs(Bz, S, H, G, P, N, seed=0):
    """The reference test's distributions, in model layout, on the card."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((Bz, S, H, P), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((Bz, S, H), dtype=np.float32))) * 0.1
    A = -np.exp(rng.standard_normal(H, dtype=np.float32) * 0.3)
    B, C = (rng.standard_normal((Bz, S, G, N), dtype=np.float32) * 0.5 for _ in range(2))
    return [torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda() for a in (x, dt, A, B, C)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSD_CASES)
def test_torch_cuda_ssd_scan_matches_plain(case):
    """y and the final state against the chunked plain version at the
    model's chunk 256 and, up to S 1000, y against the sequential
    recurrence: 2e-3, the reference's tolerance (both sum in f32, in other
    orders and chunkings)."""
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in full f32
    Bz, S, H, G, P, N = case
    x, dt, A, B, C = _ssd_inputs(*case)
    y, state = ssd_kernel.ssd_scan(x, dt, A, B, C)
    assert y.shape == (Bz, S, H, P) and state.shape == (Bz, H, N, P)
    y_want, state_want = ssd_chunked(x, dt, A, B, C, 256)
    torch.testing.assert_close(y, y_want, rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(state, state_want, rtol=2e-3, atol=2e-3)
    if S <= 1000:
        y_seq, state_seq = ssd_ops.ssd(x, dt, A, B, C, impl="ref", return_state=True)
        torch.testing.assert_close(y, y_seq, rtol=2e-3, atol=2e-3)
        torch.testing.assert_close(state, state_seq, rtol=2e-3, atol=2e-3)


def _check_ssd_structure(monkeypatch, x, dt, A, B, C):
    """The kernel against its own decomposition in plain PyTorch at its
    own chunk length, and against the chunked plain version at the
    model's chunk 256: 2e-3, the reference's tolerance (all sum in f32, in
    other orders).  Both results finite."""
    # the plain versions in full f32, for this test only
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    y, state = ssd_kernel.ssd_scan(x, dt, A, B, C)
    assert bool(y.isfinite().all()) and bool(state.isfinite().all())
    for y_want, state_want in (ssd_three_pass(x, dt, A, B, C, ssd_kernel.chunk_length()),
                               ssd_chunked(x, dt, A, B, C, 256)):
        torch.testing.assert_close(y, y_want, rtol=2e-3, atol=2e-3)
        torch.testing.assert_close(state, state_want, rtol=2e-3, atol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("at", ["1", "l-1", "l", "l+1"])
def test_torch_cuda_ssd_scan_at_chunk_edges(at, monkeypatch):
    """S on either side of the kernel's chunk length l (read from the
    library, so the cases follow the build), two groups over four heads at
    the serve head size: the ragged chunk is masked in the kernel."""
    _need_cuda()
    l = ssd_kernel.chunk_length()
    S = {"1": 1, "l-1": l - 1, "l": l, "l+1": l + 1}[at]
    _check_ssd_structure(monkeypatch, *_ssd_inputs(2, S, 4, 2, 64, 128, seed=5))


@pytest.mark.cuda
def test_torch_cuda_ssd_scan_strong_decay(monkeypatch):
    """dt * A = -2.4 a token over two chunks and a ragged third: cum falls
    below -150 within a chunk, where exp(-cum) is inf in f32."""
    _need_cuda()
    l = ssd_kernel.chunk_length()
    x, _, _, B, C = _ssd_inputs(2, 2 * l + 5, 4, 1, 64, 128, seed=6)
    dt = torch.full(x.shape[:3], 0.1, device="cuda")
    A = torch.full((4,), -24.0, device="cuda")
    _check_ssd_structure(monkeypatch, x, dt, A, B, C)


@pytest.mark.cuda
def test_torch_cuda_ssd_scan_takes_unaligned_views_and_odd_widths(monkeypatch):
    """P 6 and N 5, and x, B and C as views 4 bytes past a 16-byte
    boundary: the kernel takes its 4-byte copies and masks the padded
    columns."""
    _need_cuda()
    Bz, S, H, G, P, N = 2, 150, 4, 2, 6, 5
    x, dt, A, B, C = _ssd_inputs(Bz, S, H, G, P, N, seed=7)
    flat = torch.cat([x.reshape(Bz, S, -1), B.reshape(Bz, S, -1), C.reshape(Bz, S, -1)], dim=-1)
    buf = torch.zeros(Bz, S, flat.shape[-1] + 1, device="cuda")
    buf[..., 1:] = flat
    xv = buf[..., 1:1 + H * P].reshape(Bz, S, H, P)
    Bv = buf[..., 1 + H * P:1 + H * P + G * N].reshape(Bz, S, G, N)
    Cv = buf[..., 1 + H * P + G * N:].reshape(Bz, S, G, N)
    assert xv.data_ptr() % 16 != 0
    _check_ssd_structure(monkeypatch, xv, dt, A, Bv, Cv)


@pytest.mark.cuda
def test_torch_cuda_ssd_scan_counts_its_three_kernels():
    """One call counts one in ``launches`` and the three kernels the C
    entry reports in ``kernel_launches``."""
    _need_cuda()
    x, dt, A, B, C = _ssd_inputs(1, 100, 4, 2, 16, 16, seed=9)
    calls, kernels = ssd_kernel.launches, ssd_kernel.kernel_launches
    ssd_kernel.ssd_scan(x, dt, A, B, C)
    assert (ssd_kernel.launches - calls, ssd_kernel.kernel_launches - kernels) == (1, 3)


@pytest.mark.cuda
def test_torch_cuda_kernel_counts_lose_nothing_across_threads():
    """Calls from two threads at once, as the serve phases make them from
    two lanes, are all counted: in ``launches`` and in the kernels the C
    entries report."""
    _need_cuda()
    ssd_args = _ssd_inputs(1, 100, 4, 2, 16, 16, seed=9)
    paged_args = _paged_inputs(*PAGED_CASES[2])
    reset_launch_counts()
    calls = 200

    def work():
        for _ in range(calls):
            ssd_kernel.ssd_scan(*ssd_args)
            paged_kernel.paged_attention(*paged_args)

    threads = [threading.Thread(target=work) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert (ssd_kernel.launches, ssd_kernel.kernel_launches) == (2 * calls, 6 * calls)
    assert (paged_kernel.launches, paged_kernel.kernel_launches) == (2 * calls, 2 * calls)


@pytest.mark.cuda
def test_torch_cuda_ssd_scan_repeats_bit_for_bit():
    """Two calls in a row on one stream give the same bits: the workspace
    carries nothing from one call to the next, and no sum is atomic."""
    _need_cuda()
    x, dt, A, B, C = _ssd_inputs(2, 700, 8, 2, 64, 128, seed=8)
    y1, state1 = ssd_kernel.ssd_scan(x, dt, A, B, C)
    y2, state2 = ssd_kernel.ssd_scan(x, dt, A, B, C)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(state1, state2)


@pytest.mark.cuda
def test_torch_cuda_ssd_scan_takes_strided_views_and_groups():
    """x, B and C as views of one (Bz, S, H*P + 2*G*N) tensor, as the model
    slices them out of the conv output, with G = 2 groups over H = 6
    heads: the same result as contiguous copies, bit for bit, and as the
    plain version with the groups expanded."""
    _need_cuda()
    Bz, S, H, G, P, N = 2, 300, 6, 2, 64, 32
    x, dt, A, B, C = _ssd_inputs(Bz, S, H, G, P, N, seed=3)
    xbc = torch.cat([x.reshape(Bz, S, -1), B.reshape(Bz, S, -1), C.reshape(Bz, S, -1)], dim=-1)
    xv = xbc[..., :H * P].reshape(Bz, S, H, P)
    Bv = xbc[..., H * P:H * P + G * N].reshape(Bz, S, G, N)
    Cv = xbc[..., H * P + G * N:].reshape(Bz, S, G, N)
    dtv = dt.transpose(1, 2).contiguous().transpose(1, 2)
    assert not (xv.is_contiguous() or Bv.is_contiguous() or dtv.is_contiguous())
    y, state = ssd_kernel.ssd_scan(xv, dtv, A, Bv, Cv)
    y_c, state_c = ssd_kernel.ssd_scan(x, dt, A, B, C)
    torch.testing.assert_close(y, y_c, rtol=0, atol=0)
    torch.testing.assert_close(state, state_c, rtol=0, atol=0)
    R = H // G
    y_want, _ = ssd_chunked(x, dt, A, B.repeat_interleave(R, dim=2),
                            C.repeat_interleave(R, dim=2), 64)
    torch.testing.assert_close(y, y_want, rtol=2e-3, atol=2e-3)


@pytest.mark.cuda
def test_torch_cuda_ssd_scan_refuses_what_it_does_not_take():
    _need_cuda()
    reset_launch_counts()
    x, dt, A, B, C = _ssd_inputs(1, 64, 4, 2, 16, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_ops.ssd(*(t.cpu() for t in (x, dt, A, B, C)), impl="cuda")
    with pytest.raises(TypeError, match="float32"):
        ssd_kernel.ssd_scan(x.bfloat16(), dt, A, B, C)
    with pytest.raises(ValueError, match="N=512"):
        ssd_kernel.ssd_scan(x, dt, A, *_ssd_inputs(1, 64, 4, 2, 16, 512)[3:])
    with pytest.raises(ValueError, match="P=256"):
        ssd_kernel.ssd_scan(*_ssd_inputs(1, 64, 4, 2, 256, 8)[:1], dt, A, B, C)
    with pytest.raises(ValueError, match="not a multiple"):
        ssd_kernel.ssd_scan(x, dt, A, B[:, :, :1].expand(1, 64, 3, 8), C[:, :, :1].expand(1, 64, 3, 8))
    with pytest.raises(ValueError, match="contiguous last dimension"):
        ssd_kernel.ssd_scan(x.transpose(2, 3).contiguous().transpose(2, 3), dt, A, B, C)
    assert launch_counts()["ssd_scan"] == 0


@pytest.mark.cuda
def test_torch_cuda_ssd_op_launches_the_kernel():
    _need_cuda()
    reset_launch_counts()
    x, dt, A, B, C = _ssd_inputs(2, 100, 4, 1, 16, 16)
    D = torch.rand(4, device="cuda")
    got = ssd_ops.ssd(x, dt, A, B, C, D)
    assert launch_counts()["ssd_scan"] == 1
    plain = ssd_ops.ssd(x, dt, A, B, C, D, impl="ref")
    assert launch_counts()["ssd_scan"] == 1
    torch.testing.assert_close(got, plain, rtol=2e-3, atol=2e-3)


@pytest.mark.cuda
def test_torch_cuda_ssm_prefill_runs_the_kernel():
    """On the card the mamba2 prefill's scans go through the kernel, once
    per layer, and the logits and the decode cache agree with the plain
    run (``ssd_chunked``) within 1e-4 (f32, TF32 off)."""
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = smoke(get_config("mamba2-130m"))
    m = get_model(cfg)
    params = m.init(cfg, generator=torch.Generator(device="cuda").manual_seed(0), device="cuda")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 70)))
    tokens = tokens.to("cuda")
    reset_launch_counts()
    got, _, cache = m.forward(cfg, params, {"tokens": tokens}, return_kv=True)
    assert launch_counts()["ssd_scan"] == cfg.num_layers
    want, _, cache_ref = m.forward(cfg, params, {"tokens": tokens}, return_kv=True, impl="ref")
    assert launch_counts()["ssd_scan"] == cfg.num_layers
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    for name in ("state", "conv"):
        torch.testing.assert_close(cache[name], cache_ref[name], rtol=1e-4, atol=1e-4)


# (B, H, K, D, P, M, lengths): the reference's cases (tests/test_paged.py:
# 74-119, D 4 and 8, P 2-8), a length-0 row, the zoo's D 64 with GQA, and
# whisper-tiny's decoder (H = K = 6, D 64; prompts of 64 and 256 with up to
# 32 new tokens, a table of 18 pages), and, last, the serve decode shape
# (OLMo-1B: H = K = 16, D 128, P 16, table width 128).
PAGED_CASES = [
    (4, 4, 2, 8, 4, 6, [3, 4, 7, 24]),
    (3, 4, 2, 8, 4, 5, [1, 6, 20]),
    (2, 2, 1, 4, 2, 3, [5, 6]),
    (3, 4, 2, 4, 8, 3, [24, 0, 9]),
    (2, 8, 2, 64, 16, 8, [100, 37]),
    (2, 36, 4, 128, 16, 16, [250, 129]),
    (8, 6, 6, 64, 16, 18, [64, 95, 70, 80, 256, 287, 260, 270]),
    (8, 16, 16, 128, 16, 128, [1000] * 4 + [2000] * 4),
]


def _paged_inputs(B, H, K, D, P, M, lengths, dtype="float32", seed=0):
    """The reference's pool, on the card: pages in order from 1, page 0,
    unreferenced pages and the tails past each length holding +-1e6 (bf16:
    NaN in the tails, which the kernel never reads)."""
    rng = np.random.default_rng(seed)
    N = 1 + sum(-(-n // P) for n in lengths) + 2
    garbage = 1e6 if dtype == "float32" else np.nan
    kp = np.full((N, P, K, D), garbage, np.float32)
    vp = np.full((N, P, K, D), -garbage, np.float32)
    tbl = np.zeros((B, M), np.int32)
    nxt = 1
    for b, n in enumerate(lengths):
        for j in range(-(-n // P)):
            tbl[b, j] = nxt
            valid = min(P, n - j * P)
            kp[nxt, :valid] = rng.standard_normal((valid, K, D))
            vp[nxt, :valid] = rng.standard_normal((valid, K, D))
            nxt += 1
    q = rng.standard_normal((B, H, D), dtype=np.float32)
    td = DTYPES[dtype]
    return (torch.from_numpy(q).to("cuda", td), torch.from_numpy(kp).to("cuda", td),
            torch.from_numpy(vp).to("cuda", td), torch.from_numpy(tbl).cuda(),
            torch.from_numpy(np.asarray(lengths, np.int32)).cuda())


def _paged_plain(q, kp, vp, tbl, lens):
    """The plain version, with the garbage out of the gathered rows
    (masked slots weigh exactly 0, but 0 * NaN is NaN) and length-0 rows
    set to the kernel's 0 (the plain softmax spreads them over masked
    slots)."""
    clean = lambda t: torch.nan_to_num(t, nan=0.0)  # noqa: E731
    want = paged_attention_ref(q, clean(kp), clean(vp), tbl, lens)
    return want.masked_fill((lens == 0)[:, None, None], 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", PAGED_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_cuda_paged_attention_matches_plain(case, dtype):
    _need_cuda()
    q, kp, vp, tbl, lens = _paged_inputs(*case, dtype=dtype)
    got = paged_kernel.paged_attention(q, kp, vp, tbl, lens)
    torch.cuda.synchronize()
    assert got.shape == q.shape and got.dtype == q.dtype and bool(got.isfinite().all())
    want = _paged_plain(q, kp, vp, tbl, lens)
    if dtype == "float32":  # both sum in f32, in other orders
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:  # per element, within paged_attention.ref.bf16_bound
        clean = lambda t: torch.nan_to_num(t, nan=0.0)  # noqa: E731
        bound = paged_bf16_bound(q, clean(kp), clean(vp), tbl, lens, want)
        err = (got.float() - want.float()).abs()
        assert bool((err <= bound).all()), float((err / bound).max())


@pytest.mark.cuda
def test_torch_cuda_paged_attention_takes_strided_q_and_pages():
    _need_cuda()
    q, kp, vp, tbl, lens = _paged_inputs(3, 8, 2, 64, 16, 4, [5, 33, 64])
    wide = torch.zeros(3, 1, 8, 2 * 64, device="cuda")
    wide[:, 0, :, :64] = q  # a (B, 1, H, D) projection's view, head stride 128
    slab_k, slab_v = torch.stack([kp, kp * 0]), torch.stack([vp * 0, vp])  # folded slabs
    got = paged_kernel.paged_attention(wide[:, 0, :, :64], slab_k[0], slab_v[1], tbl, lens)
    torch.testing.assert_close(got, paged_kernel.paged_attention(q, kp, vp, tbl, lens),
                               rtol=0, atol=0)


@pytest.mark.cuda
def test_torch_cuda_paged_attention_fold_is_bit_equal_to_per_layer_launches():
    _need_cuda()
    layers = [_paged_inputs(8, 16, 16, 128, 16, 128, [1000] * 4 + [2000] * 4, seed=s)
              for s in range(3)]
    tbl, lens = layers[0][3], layers[0][4]
    q, kp, vp = (torch.stack([x[i] for x in layers]) for i in range(3))
    reset_launch_counts()
    folded = paged_ops.paged_attention_layers(q, kp, vp, tbl, lens)
    assert launch_counts()["paged_attention"] == 1  # one launch for all layers
    for i in range(3):
        assert torch.equal(folded[i], paged_ops.paged_attention(q[i], kp[i], vp[i], tbl, lens))


# The split-K tiling's edges (8 splits a row): rows of fewer pages than
# splits, lengths at multiples of splits x P (and one past), one long row
# (M 512, 8,000 tokens), and GQA R 9 at the serve page size with a
# length-0 and a length-1 row.
PAGED_SPLIT_CASES = [
    (4, 8, 2, 64, 16, 8, [1, 16, 17, 100]),
    (4, 16, 16, 128, 16, 64, [128, 256, 1024, 129]),
    (1, 16, 16, 128, 16, 512, [8000]),
    (4, 36, 4, 128, 16, 128, [1000, 2000, 1, 0]),
]


def _assert_paged_close(got, want, q, kp, vp, tbl, lens):
    """f32 within 1e-5; bf16 per element within ``bf16_bound`` (on the
    pages with their NaN garbage cleaned)."""
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        clean = lambda t: torch.nan_to_num(t, nan=0.0)  # noqa: E731
        bound = paged_bf16_bound(q, clean(kp), clean(vp), tbl, lens, want)
        err = (got.float() - want.float()).abs()
        assert bool((err <= bound).all()), float((err / bound).max())


@pytest.mark.cuda
@pytest.mark.parametrize("case", PAGED_SPLIT_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_cuda_paged_attention_split_edges(case, dtype):
    """The kernel against the split decomposition in plain PyTorch (which
    takes the NaN tails as they are) and against the plain gather
    version; a length-0 row gives exactly 0."""
    _need_cuda()
    q, kp, vp, tbl, lens = _paged_inputs(*case, dtype=dtype, seed=len(case[-1]))
    got = paged_kernel.paged_attention(q, kp, vp, tbl, lens)
    torch.cuda.synchronize()
    assert paged_kernel.last_load_width == 4  # contiguous pages: the vector instantiation
    assert bool(got.isfinite().all())
    _assert_paged_close(got, paged_attention_split_ref(q, kp, vp, tbl, lens), q, kp, vp, tbl, lens)
    _assert_paged_close(got, _paged_plain(q, kp, vp, tbl, lens), q, kp, vp, tbl, lens)
    assert not bool(got[lens == 0].any())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_cuda_paged_attention_repeats_bit_for_bit(dtype):
    """No atomics and a fixed merge order: two calls are equal bit for bit
    (the serve shape, and GQA R 9)."""
    _need_cuda()
    for case in (PAGED_CASES[-1], PAGED_SPLIT_CASES[-1]):
        args = _paged_inputs(*case, dtype=dtype)
        first = paged_kernel.paged_attention(*args)
        assert torch.equal(first, paged_kernel.paged_attention(*args))


@pytest.mark.cuda
def test_torch_cuda_paged_attention_fold_bit_equal_at_split_boundaries():
    _need_cuda()
    lengths = [128, 256, 127, 129, 1024, 0]  # multiples of 8 x 16 tokens and one off
    layers = [_paged_inputs(6, 8, 4, 128, 16, 64, lengths, seed=s) for s in range(3)]
    tbl, lens = layers[0][3], layers[0][4]
    q, kp, vp = (torch.stack([x[i] for x in layers]) for i in range(3))
    folded = paged_kernel.paged_attention_layers(q, kp, vp, tbl, lens)
    for i in range(3):
        assert torch.equal(folded[i], paged_kernel.paged_attention(q[i], kp[i], vp[i], tbl, lens))
        torch.testing.assert_close(folded[i], paged_attention_split_ref(q[i], kp[i], vp[i], tbl,
                                                                        lens),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_cuda_paged_attention_scalar_instantiation(dtype):
    """Views the vector loads cannot take go through the kernel's scalar
    instantiation: a base one element off, an odd head dim, odd strides;
    each agrees with the plain version, and an aligned copy of the same
    data takes the vector one."""
    _need_cuda()
    q, kp, vp, tbl, lens = _paged_inputs(3, 8, 2, 64, 16, 40, [5, 300, 129], dtype=dtype)
    clean = lambda t: torch.nan_to_num(t, nan=0.0)  # noqa: E731
    want = _paged_plain(q, kp, vp, tbl, lens)

    def shifted(t):  # the same values at a base one element past a 16-byte boundary
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    off = paged_kernel.paged_attention(shifted(q), shifted(kp), shifted(vp), tbl, lens)
    assert paged_kernel.last_load_width == 1
    _assert_paged_close(off, want, q, kp, vp, tbl, lens)
    wide = torch.zeros(*kp.shape[:-1], 67, dtype=kp.dtype, device="cuda")  # row stride 67
    wide_v = wide.clone()
    wide[..., :64], wide_v[..., :64] = kp, vp
    odd = paged_kernel.paged_attention(q, wide[..., :64], wide_v[..., :64], tbl, lens)
    assert paged_kernel.last_load_width == 1
    _assert_paged_close(odd, want, q, kp, vp, tbl, lens)
    # D 33: no 4-element chunks
    q3, k3, v3, t3, l3 = _paged_inputs(2, 4, 2, 33, 4, 12, [45, 7], dtype=dtype)
    got3 = paged_kernel.paged_attention(q3, k3, v3, t3, l3)
    assert paged_kernel.last_load_width == 1
    _assert_paged_close(got3, _paged_plain(q3, k3, v3, t3, l3), q3, k3, v3, t3, l3)
    paged_kernel.paged_attention(q.contiguous(), clean(kp).contiguous(), vp, tbl, lens)
    assert paged_kernel.last_load_width == 4


@pytest.mark.cuda
def test_torch_cuda_paged_attention_one_kernel_a_call():
    """Each call launches one CUDA kernel, as the C entry reports: the
    cluster merge needs no second pass.  The grid it recorded holds
    splits x kv heads x rows x layers blocks, in clusters of the splits."""
    _need_cuda()
    reset_launch_counts()
    args = _paged_inputs(*PAGED_CASES[-1])
    for _ in range(3):
        paged_kernel.paged_attention(*args)
    assert (paged_kernel.last_blocks, paged_kernel.last_cluster) == (1024, 8)
    q, kp, vp, tbl, lens = args
    paged_kernel.paged_attention_layers(torch.stack([q, q]), torch.stack([kp, kp]),
                                        torch.stack([vp, vp]), tbl, lens)
    assert paged_kernel.launches == paged_kernel.kernel_launches == 4
    assert (paged_kernel.last_blocks, paged_kernel.last_cluster) == (2048, 8)
    assert paged_kernel.splits() == 8


@pytest.mark.cuda
def test_torch_cuda_paged_attention_refuses_what_it_does_not_take():
    _need_cuda()
    reset_launch_counts()
    q, kp, vp, tbl, lens = _paged_inputs(2, 4, 2, 8, 4, 3, [5, 9])
    with pytest.raises(ValueError, match="CUDA tensors"):
        paged_ops.paged_attention(q.cpu(), kp.cpu(), vp.cpu(), tbl.cpu(), lens.cpu(), impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        paged_kernel.paged_attention(q, kp, vp, tbl.cpu(), lens)
    with pytest.raises(TypeError, match="int32"):
        paged_kernel.paged_attention(q, kp, vp, tbl.long(), lens)
    with pytest.raises(TypeError, match="float32 or all bfloat16"):
        paged_kernel.paged_attention(q.half(), kp.half(), vp.half(), tbl, lens)
    with pytest.raises(ValueError, match="not a multiple"):
        paged_kernel.paged_attention(q[:, :3], kp, vp, tbl, lens)
    with pytest.raises(ValueError, match="contiguous last dimension"):
        paged_kernel.paged_attention(q.transpose(1, 2).contiguous().transpose(1, 2)[:, :, :4],
                                     kp[..., :4], vp[..., :4], tbl, lens)
    with pytest.raises(ValueError, match="head dim"):
        paged_kernel.paged_attention(*_paged_inputs(1, 2, 2, 300, 4, 2, [3])[:3], tbl[:1], lens[:1])
    assert launch_counts()["paged_attention"] == 0


@pytest.mark.cuda
def test_torch_cuda_paged_attention_op_launches_the_kernel():
    _need_cuda()
    reset_launch_counts()
    args = _paged_inputs(3, 4, 2, 8, 4, 5, [1, 6, 20])
    got = paged_ops.paged_attention(*args)
    assert launch_counts()["paged_attention"] == 1
    plain = paged_ops.paged_attention(*args, impl="ref")
    assert launch_counts()["paged_attention"] == 1
    torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_torch_cuda_paged_decode_step_launches_once_per_layer():
    """On the card the dense paged decode step attends through the kernel,
    once per layer, and agrees with the gather path within 1e-4."""
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = smoke(get_config("olmo-1b"))
    m = get_model(cfg)
    params = m.init(cfg, generator=torch.Generator(device="cuda").manual_seed(0), device="cuda")
    spec = m.paged_spec(cfg)
    rng = np.random.default_rng(1)
    shape = (spec.layers, 9, spec.page_size, spec.kv_heads, spec.head_dim)
    kp = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).cuda()
    vp = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).cuda()
    tbl = torch.tensor([[1, 2, 3], [4, 5, 0]], dtype=torch.int32, device="cuda")
    lens = torch.tensor([32, 20], dtype=torch.int32, device="cuda")  # a boundary, inside a page
    tok = torch.tensor([3, 7], dtype=torch.int32, device="cuda")
    reset_launch_counts()
    k1, v1, _, got = m.paged_decode_step(cfg, params, kp.clone(), vp.clone(), None, tok, lens,
                                         tbl, lens)
    assert launch_counts()["paged_attention"] == cfg.num_layers
    k2, v2, _, want = m.paged_decode_step(cfg, params, kp.clone(), vp.clone(), None, tok, lens,
                                          tbl, lens, impl="ref")
    assert launch_counts()["paged_attention"] == cfg.num_layers
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(k1, k2, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_torch_cuda_paged_engine_decodes_after_the_page_write():
    """The decode lane's first step reads pages the prefill lane wrote while
    that write was still held back on the device: a page write delayed by
    about 0.1 s of ``torch.cuda._sleep`` is seen all the same."""
    _need_cuda()
    dev = get_all_devices(1, 0).get()[0]
    kv = PagedKVCache(PageSpec(1, 4, 1, 4), devices=[dev], pool_pages=16)
    V = 64

    def prefill_fn(tokens, extras):  # v of every token = the prompt's first token
        B, T = tokens.shape
        c = tokens[:, :1].float()
        v = c[:, None, :, None, None].expand(B, 1, T, 1, 4).contiguous()
        return torch.zeros_like(v), v, None, torch.nn.functional.one_hot(tokens[:, 0].long(), V).float()

    def decode_fn(ks, vs, state, tokens, positions, tables, lengths):
        B = tokens.shape[0]
        c = tokens.float()[:, None, None, None].expand(B, 1, 1, 4)
        kp, vp = model_layers.page_scatter(ks[0], vs[0], torch.zeros_like(c), c, tables, positions)
        o = model_layers.paged_decode_attend(torch.zeros(B, 1, 1, 4, device="cuda"), kp, vp, tables,
                                             lengths)  # uniform weights: the mean of v
        return ks, vs, state, torch.nn.functional.one_hot(o[:, 0, 0, 0].round().long(), V).float()

    eng = PagedServeEngine(kv, prefill_fn, decode_fn, max_seq_len=16, name="t-order")
    pool = kv.pool_of(dev)
    write = pool.write_tokens

    def slow_write(pages, k, v):
        torch.cuda._sleep(SLEEP_CYCLES)  # hold the write back on the prefill lane's stream
        write(pages, k, v)

    pool.write_tokens = slow_write
    reset_launch_counts()
    try:
        futs = [eng.submit(np.full(6, c, np.int32), 4) for c in (11, 29)]
        got = [list(f.get(timeout=120)) for f in futs]
    finally:
        eng.close()
    assert got == [[11] * 4, [29] * 4]  # stale pages would give another mean
    # Steps replay CUDA graphs: the kernels that ran are the counted launches
    # less those captured into graphs, plus those the replays ran.
    m = eng.metrics()
    ran = (launch_counts()["paged_attention"] - m["decode"]["captured_launches"]["paged_attention"]
           + m["decode"]["replayed_launches"].get("paged_attention", 0))
    assert ran == m["decode_steps"]


# ---------------------------------------------------------------------------
# graph capture on torch.cuda.CUDAGraph
# ---------------------------------------------------------------------------


def _graph_chain(n):
    dev = get_all_devices(1, 0).get()[0]
    prog = dev.create_program({"stencil": stencil_ops.stencil, "partition_map": map_ops.partition_map,
                               "shift": lambda x: x + 1.0, "add": lambda x, y: x + y},
                              name="graph-card").get()
    src, a, b, c = (dev.create_buffer(n, np.float32).get() for _ in range(4))

    def chain(s, x, y, z):
        prog.run([s], "stencil", block=(256, 1, 1), out=[x])
        prog.run([x], "partition_map", block=(256, 1, 1), out=[y])
        return prog.run([y], "shift", out=[z])

    def eager(x):
        src.enqueue_write(0, x)
        chain(src, a, b, c).get()
        return c.array().clone()

    return dev, prog, chain, eager


@pytest.mark.cuda
def test_torch_cuda_graph_replay_bit_equal_to_eager_with_new_feeds():
    """stencil -> partition_map -> shift captured into ONE CUDA graph: every
    replay with a fresh input is bit-equal to the eager chain, the first
    result survives later replays, graph-internal buffers raise, and the
    capture recorded one launch of each kernel."""
    _need_cuda()
    n = 1 << 20
    dev, prog, chain, eager = _graph_chain(n)
    gsrc, ga, gb, gc = (dev.create_buffer(n, np.float32).get() for _ in range(4))
    gen = torch.Generator(device="cuda").manual_seed(3)
    with dev.capture("card") as g:
        w = gsrc.enqueue_write(0, torch.randn(n, generator=gen, device="cuda"))
        chain(gsrc, ga, gb, gc)
        r = gc.enqueue_read()
    exe = g.instantiate()
    assert exe.cuda_graphs == 1 and {s.exec_mode for s in exe._segments} == {"fused"}, repr(exe)
    assert exe.recorded_launches == {"stencil": 1, "partition_map": 1}
    reset_launch_counts()
    first = None
    for _ in range(6):
        x = torch.randn(n, generator=gen, device="cuda")
        res = exe.replay(feeds={w: x}).get()
        got = gc.array()
        want = eager(x)
        assert torch.equal(got, want)
        assert np.array_equal(res[r], want.cpu().numpy())
        if first is None:
            first, held = got, got.clone()
    assert torch.equal(first, held)
    assert launch_counts()["stencil"] == 6  # the eager chains only: replays pass no wrapper
    for buf in (gsrc, ga, gb):
        with pytest.raises(RuntimeError, match="donated"):
            buf.enqueue_read().get()


@pytest.mark.cuda
def test_torch_cuda_graph_two_chains_are_branches_of_one_graph():
    """Two chains joined by an add: three segments on two lanes, each
    with a CUDA graph of its own (once branches of one graph), the join an
    event edge; replays bit-equal to eager."""
    _need_cuda()
    n = 1 << 18
    dev, prog, _, _ = _graph_chain(n)
    a, b, ma, mb, out = (dev.create_buffer(n, np.float32).get() for _ in range(5))
    gen = torch.Generator(device="cuda").manual_seed(4)
    with dev.capture("branches") as g:
        wa = a.enqueue_write(0, torch.randn(n, generator=gen, device="cuda"))
        wb = b.enqueue_write(0, torch.randn(n, generator=gen, device="cuda"))
        prog.run([a], "stencil", out=[ma])
        prog.run([b], "partition_map", out=[mb])
        prog.run([ma, mb], "add", out=[out])
    exe = g.instantiate()
    assert exe._fanout and exe._event_edges and exe.cuda_graphs == 3, repr(exe)
    assert len({id(seg.queue) for seg in exe._segments}) == 2, repr(exe)
    for _ in range(3):
        xa, xb = (torch.randn(n, generator=gen, device="cuda") for _ in range(2))
        exe.replay(feeds={wa: xa, wb: xb}).get()
        assert torch.equal(out.array(), stencil_ops.stencil(xa) + map_ops.partition_map(xb))


@pytest.mark.cuda
def test_torch_cuda_graph_capture_while_another_thread_launches():
    """A capture (thread_local mode) taken while another thread keeps
    launching and allocating on its own stream: the capture succeeds, the
    other thread's work stays out of the graph, both results are right."""
    _need_cuda()
    n = 1 << 20
    dev, prog, chain, eager = _graph_chain(n)
    gsrc, ga, gb, gc = (dev.create_buffer(n, np.float32).get() for _ in range(4))
    x = torch.randn(n, device="cuda")
    stop, errors, done = threading.Event(), [], [0]

    def busy():
        s = torch.cuda.Stream()
        y = torch.randn(n, device="cuda")
        try:
            with torch.cuda.stream(s):
                while not stop.is_set():
                    z = stencil_ops.stencil(y)  # allocates, launches
                    if not torch.allclose(z, stencil_ref(y), rtol=1e-6, atol=1e-6):
                        errors.append("stencil differs")
                    done[0] += 1
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(repr(e))

    t = threading.Thread(target=busy)
    t.start()
    try:
        for _ in range(3):
            with dev.capture("busy") as g:
                w = gsrc.enqueue_write(0, x)
                chain(gsrc, ga, gb, gc)
            exe = g.instantiate()
            exe.replay(feeds={w: x}).get()
            assert torch.equal(gc.array(), eager(x))
    finally:
        stop.set()
        t.join(timeout=60)
    assert not t.is_alive() and not errors and done[0] > 0


def _resident(eng, prompts):
    """Requests prefilled and paged in as the prefill lane does, never
    admitted: the test steps the decode lane itself."""
    reqs = []
    with eng._on_stream():
        for rid, p in enumerate(prompts):
            k, v, state, logits = eng.prefill_fn(torch.from_numpy(p)[None].cuda(), None)
            r = _PagedRequest(p, 1000, Promise(), 0.0, rid=rid)
            r.seq = eng.kv.new_seq(eng.device)
            eng.kv.append(r.seq, k[0], v[0])
            if state is not None:
                r.seq.set_state({n: t[0] for n, t in state.items()})
            r.out.append(int(torch.argmax(logits[0])))
            reqs.append(r)
    return reqs


def _eager_step(eng, reqs):
    """One step of the lane with its graphs off: ``decode_fn`` eagerly."""
    lane = eng._lane_for(eng.device)
    lane._graphs = None
    lane._step(reqs)


def _paged_pair(arch):
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = smoke(get_config(arch))
    params = get_model(cfg).init(cfg, generator=torch.Generator(device="cuda").manual_seed(0),
                                 device="cuda")
    dev = get_all_devices(1, 0).get()[0]
    engs = [PagedServeEngine.from_config(cfg, params=params, devices=[dev], max_seq_len=64,
                                         decode_shapes=(1, 2, 4), name=f"t-graph-{arch}-{i}")
            for i in range(2)]
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, cfg.vocab_size, size=s).astype(np.int32) for s in (5, 14, 17, 9)]
    return cfg, engs, prompts


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["olmo-1b", "mamba2-130m"])
def test_torch_cuda_paged_graph_tokens_equal_eager_decode(arch):
    """The decode lane's CUDA graphs at 3 warm counts (1, 2, 4; 3 rows pad
    to 4) give the tokens and states of eager ``decode_fn`` steps on the same
    inputs; the first step at each count is eager, every later one a
    replay; each graph recorded one paged_attention launch a layer."""
    _need_cuda()
    cfg, (geng, eeng), prompts = _paged_pair(arch)
    rows = (1, 2, 3, 4, 1, 2, 3, 4, 4, 2)
    try:
        greqs, ereqs = _resident(geng, prompts), _resident(eeng, prompts)
        for b in rows:
            geng._lane_for(geng.device)._step(greqs[:b])
            _eager_step(eeng, ereqs[:b])
        d = geng.metrics()["decode"]
    finally:
        geng.close()
        eeng.close()
    assert [r.out for r in greqs] == [r.out for r in ereqs]
    for g, e in zip(greqs, ereqs):
        if g.seq.state is not None:
            for n in g.seq.state:
                assert torch.equal(g.seq.state[n], e.seq.state[n])
    assert d["warm_counts"] == [1, 2, 4] and d["graphs_captured"] == 3
    assert d["eager_steps"] == 3 and d["replayed_steps"] == len(rows) - 3
    per = cfg.num_layers if cfg.family == "dense" else 0
    assert d["captured_launches"].get("paged_attention", 0) == 3 * per
    assert d["replayed_launches"].get("paged_attention", 0) == (len(rows) - 3) * per


@pytest.mark.cuda
def test_torch_cuda_paged_graph_recaptured_after_slab_rebind():
    """A slab tensor rebound between steps: the lane drops every graph and
    recaptures, never replaying one captured against the old address."""
    _need_cuda()
    cfg, (geng, eeng), prompts = _paged_pair("olmo-1b")
    try:
        greqs, ereqs = _resident(geng, prompts[:2]), _resident(eeng, prompts[:2])
        for i in range(6):
            if i == 3:
                pool = geng.kv.pool_of(geng.device)
                with geng._on_stream():
                    pool.k_slab._set_tensor(pool.k_slab.array().clone())
            geng._lane_for(geng.device)._step(greqs)
            _eager_step(eeng, ereqs)
        d = geng.metrics()["decode"]
    finally:
        geng.close()
        eeng.close()
    assert [r.out for r in greqs] == [r.out for r in ereqs]
    assert d["graphs_captured"] == 2 and d["eager_steps"] == 2 and d["replayed_steps"] == 4


@pytest.mark.cuda
def test_torch_cuda_paged_graph_kernel_count_matches_profiler():
    """The smoke's launch rule: the paged_attention kernels a graph recorded
    at capture, times its replays, are the paged kernels a profiler trace of
    those replays shows on the device."""
    _need_cuda()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg, (geng, eeng), prompts = _paged_pair("olmo-1b")
    eeng.close()
    try:
        reqs = _resident(geng, prompts)
        geng._lane_for(geng.device)._step(reqs)  # eager at 4, then captured
        with profile(activities=[ProfilerActivity.CUDA]):
            geng._lane_for(geng.device)._step(reqs)  # the profiler's first start, outside the window
        before = dict(geng.metrics()["decode"]["replayed_launches"])
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                geng._lane_for(geng.device)._step(reqs)
            torch.cuda.synchronize()
        after = geng.metrics()["decode"]["replayed_launches"]
    finally:
        geng.close()
    seen = sum(1 for e in prof.events()
               if e.device_type == DeviceType.CUDA and "paged_decode" in e.name)
    assert after["paged_attention"] - before["paged_attention"] == 3 * cfg.num_layers == seen


# ---------------------------------------------------------------------------
# logical devices, spill and refetch, run_on_any, the paged engine's fleet
# ---------------------------------------------------------------------------


def _logical(n):
    """``n`` logical devices of the first card (``REPRO_LOGICAL_DEVICES``)."""
    old = os.environ.get("REPRO_LOGICAL_DEVICES")
    os.environ["REPRO_LOGICAL_DEVICES"] = str(n)
    try:
        return get_all_devices(1, 0).get()[:n]
    finally:
        if old is None:
            os.environ.pop("REPRO_LOGICAL_DEVICES")
        else:
            os.environ["REPRO_LOGICAL_DEVICES"] = old


def _lanes_sleep_s(devs):
    """Host seconds for one ``torch.cuda._sleep`` kernel submitted to each
    device's default lane at once, until all have ended."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    futs = [d.ops_queue.submit(torch.cuda._sleep, SLEEP_CYCLES) for d in devs]
    wait_all(futs)
    for d in devs:
        d.synchronize()
    return time.perf_counter() - t0


@pytest.mark.cuda
def test_torch_cuda_logical_devices_run_kernels_concurrently():
    """Every logical device but the first has a CUDA stream of its own as
    its default stream, so two logical devices' kernels overlap: two ~0.1 s
    sleep kernels on two devices take well under twice one."""
    _need_cuda()
    try:
        devs = _logical(4)
        assert [d.key for d in devs] == ["cuda:0", "cuda:0.1", "cuda:0.2", "cuda:0.3"]
        streams = [d.default_stream.cuda_stream for d in devs]
        assert streams[0] == torch.cuda.default_stream()
        assert len({s.cuda_stream for s in streams}) == 4
        _lanes_sleep_s(devs[1:2])  # warm the lanes
        for pair in ((devs[1], devs[2]), (devs[0], devs[3])):
            one = min(_lanes_sleep_s(pair[:1]) for _ in range(2))
            both = min(_lanes_sleep_s(pair) for _ in range(2))
            assert both < 1.5 * one, (pair, one, both)
    finally:
        reset_runtime()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 4097, 1 << 22])
def test_torch_cuda_buffer_spill_refetch_is_bit_exact(n):
    """A spill leaves a pinned host copy and the HOST_KEY record; a read
    and a kernel launch refetch it bit for bit, on logical device 0 and 3."""
    _need_cuda()
    try:
        devs = _logical(4)
        prog = devs[0].create_program({"partition_map": map_ops.partition_map}).get()
        data = np.random.default_rng(n).normal(size=(n,)).astype(np.float32) * 50
        for dev in (devs[0], devs[3]):
            buf = dev.create_buffer_from(data).get()
            want = map_ops.partition_map(buf.array().clone())
            for read in ("host", "launch"):
                assert buf.spill().get() is True
                assert registry.placement(buf.gid).device_key == HOST_KEY
                assert buf._spilled_host.is_pinned() and buf._tensor is None
                if read == "host":
                    assert buf.enqueue_read_sync().tobytes() == data.tobytes()
                else:
                    got = prog.for_device(dev).run([buf], "partition_map").get()
                    assert torch.equal(got, want)
                assert registry.placement(buf.gid).device_key == dev.key
            assert (dev.spills, dev.refetches) >= (2, 2)
            buf.free().get()
    finally:
        reset_runtime()


@pytest.mark.cuda
def test_torch_cuda_run_on_any_over_4_logical_devices_is_bit_equal():
    """partition_map of 16 chunks through ``run_on_any`` over 4 logical
    devices (raw chunks with stealing on; buffers spread over the fleet
    under each policy with it off, then under a memory limit that spills
    and refetches) is bit-equal to one device's."""
    _need_cuda()
    try:
        devs = _logical(4)
        x = torch.randn(1 << 22, device="cuda") * 100
        chunks = list(x.chunk(16))
        want = [map_ops.partition_map(c) for c in chunks]
        torch.cuda.synchronize()
        prog = devs[0].create_program({"partition_map": map_ops.partition_map}).get()
        bufs = [devs[i % 4].create_buffer_from(c).get() for i, c in enumerate(chunks)]

        def run(args, sched):
            got = [f.get() for f in [prog.run_on_any([a], "partition_map", scheduler=sched)
                                     for a in args]]
            assert all(torch.equal(g, w) for g, w in zip(got, want)), sched
            return sched.stats()

        run(chunks, Scheduler(devs))
        placed = {p: run(bufs, Scheduler(devs, policy=p, steal=False))
                  for p in ("static", "round_robin", "least_loaded", "affinity")}
        assert len(placed["round_robin"]) == 4
        assert placed["affinity"] == {d.key: 4 for d in devs}  # where the bytes are
        for d in devs:
            d.memory_limit = 3 * bufs[0].nbytes
            d.spills = d.refetches = 0
        run(bufs, Scheduler(devs, steal=False))
        assert sum(d.spills for d in devs) >= 1 and sum(d.refetches for d in devs) >= 1
        wait_all([b.free() for b in bufs])
    finally:
        reset_runtime()


def _fleet_graph(devs, n, chunks, mode):
    """``chunks`` chunks of ``n`` f32, each partition_map -> stencil
    through ``run_on_any`` round-robin over ``devs``, captured and
    instantiated with ``REPRO_SEGMENT_COMPILE=mode``; returns (exe, its
    write nodes, the eager DAG on the same inputs, the graph's outputs)."""
    prog = devs[0].create_program({"partition_map": map_ops.partition_map,
                                   "stencil": stencil_ops.stencil}, name="fleet-graph").get()
    nd = len(devs)
    mk = lambda k: [devs[(2 * i + k) % nd].create_buffer(n, np.float32).get()  # noqa: E731
                    for i in range(chunks)]
    gsrc, gmid, gout, esrc, emid, eout = mk(0), mk(0), mk(1), mk(0), mk(0), mk(1)

    def dag(sched, srcs, mids, outs):
        return [(prog.run_on_any([s], "partition_map", out=[m], scheduler=sched),
                 prog.run_on_any([m], "stencil", out=[o], scheduler=sched))[1]
                for s, m, o in zip(srcs, mids, outs)]

    with devs[0].capture("fleet") as g:
        nodes = [g.write(s) for s in gsrc]
        dag(Scheduler(devs, policy="round_robin", steal=False), gsrc, gmid, gout)
    old = os.environ.get("REPRO_SEGMENT_COMPILE")
    os.environ["REPRO_SEGMENT_COMPILE"] = mode
    try:
        exe = g.instantiate()
    finally:
        if old is None:
            del os.environ["REPRO_SEGMENT_COMPILE"]
        else:
            os.environ["REPRO_SEGMENT_COMPILE"] = old

    def eager(xs):
        for s, x in zip(esrc, xs):
            s.enqueue_write(0, x)
        wait_all(dag(Scheduler(devs, policy="round_robin", steal=False), esrc, emid, eout))
        return [o.array() for o in eout]

    return exe, nodes, eager, gout


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fused", "staged"])
def test_torch_cuda_graph_over_4_logical_devices_one_graph_a_segment(mode):
    """A plan recorded through ``run_on_any`` over 4 logical devices:
    fused, every segment is a CUDA graph of its own (each device has
    some); staged, none is.  Replays with fresh feeds are bit-equal to the
    eager DAG and to one device's kernels."""
    _need_cuda()
    try:
        devs = _logical(4)
        n, chunks = 1 << 20, 8
        exe, nodes, eager, gout = _fleet_graph(devs, n, chunks, mode)
        segs = exe._segments
        assert len(segs) == 2 * chunks and len(exe._transfers) == chunks, repr(exe)
        assert {s.exec_mode for s in segs} == {mode}
        if mode == "fused":
            assert exe.cuda_graphs == len(segs)
            assert {s.device.key for s in segs if s.graph is not None} == {d.key for d in devs}
            assert exe.recorded_launches == {"partition_map": chunks, "stencil": chunks}
        else:
            assert exe.cuda_graphs == 0 and exe.recorded_launches == {}
        gen = torch.Generator(device="cuda").manual_seed(7)
        for _ in range(4):
            xs = [torch.randn(n, generator=gen, device="cuda") for _ in range(chunks)]
            torch.cuda.synchronize()
            exe.replay(feeds=dict(zip(nodes, xs))).get()
            want = eager(xs)
            for x, o, w in zip(xs, gout, want):
                assert torch.equal(o.array(), w)
                assert torch.equal(w, stencil_ops.stencil(map_ops.partition_map(x)))
        assert exe.graph_replays == (4 * len(segs) if mode == "fused" else 0)
    finally:
        reset_runtime()


def _slow(x):
    """x + 1 after ~0.1 s of device time (on a card)."""
    if x.is_cuda:
        torch.cuda._sleep(SLEEP_CYCLES)
    return x + 1.0


@pytest.mark.cuda
def test_torch_cuda_graph_event_edges_are_device_side():
    """The first segment sleeps ~0.1 s on the device; its consumer sits on
    another logical device.  ``replay(sync="dispatch")`` resolves before
    the producer's work ends (the consumer's stream waits on its event,
    nobody waits on the host), and the committed value is still right;
    ``sync="ready"`` resolves once it has ended."""
    _need_cuda()
    try:
        devs = _logical(2)
        prog = devs[0].create_program({"slow": _slow, "double": lambda x: x * 2.0}, "slow").get()
        x = devs[0].create_buffer_from(torch.arange(1 << 16, dtype=torch.float32,
                                                    device="cuda")).get()
        m = devs[0].create_buffer(1 << 16, np.float32).get()
        o = devs[1].create_buffer(1 << 16, np.float32).get()
        with devs[0].capture("slow") as g:
            prog.run([x], "slow", out=[m])
            prog.for_device(devs[1]).run([m], "double", out=[o])
        exe = g.instantiate()
        assert exe._fanout and exe.cuda_graphs == 2 and exe._event_edges, repr(exe)
        want = (torch.arange(1 << 16, dtype=torch.float32, device="cuda") + 1.0) * 2.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        exe.replay(sync="dispatch").get()
        dispatched = time.perf_counter() - t0
        pending = not exe._last_event.query()
        assert torch.equal(o.array(), want)  # ordered after the replay's work on the device
        assert pending and dispatched < 0.05, (pending, dispatched)
        exe.replay(sync="ready").get()
        assert exe._last_event.query()
        assert torch.equal(o.array(), want)
    finally:
        reset_runtime()


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["transfer slot", "read in place"])
def test_torch_cuda_graph_next_replay_waits_for_the_slow_consumer(where):
    """Two replays dispatched back to back while the first one's consumer
    (slow: it sleeps before reading) still has to read its input, a
    transfer slot on another logical device or a same-device producer's
    graph output read in place: each replay's out-less result is its own
    inputs' (the second replay's copies and producer wait for the first
    replay's end)."""
    _need_cuda()
    try:
        devs = _logical(2)
        k = {"inc": lambda x: x + 1.0, "slow_add": lambda x, y: _slow(x) + y - 1.0}
        prog = devs[0].create_program(k, "slow-consumer").get()
        n = 1 << 16
        a, b = (devs[0].create_buffer(n, np.float32).get() for _ in range(2))
        ma, mb = (devs[0].create_buffer(n, np.float32).get() for _ in range(2))
        with devs[0].capture("slow-consumer") as g:
            wa, wb = g.write(a), g.write(b)
            prog.run([a], "inc", out=[ma])  # chain 0
            prog.run([b], "inc", out=[mb])  # chain 1
            cons = prog if where == "read in place" else prog.for_device(devs[1])
            node = cons.run([mb, ma], "slow_add")  # chain 1 (or device 1): ma from chain 0
        exe = g.instantiate()
        consumer, ma_sym = exe._segments[-1], g._cur[id(ma)]
        if where == "transfer slot":
            assert exe.cuda_graphs == 3 and len(consumer.transfer_ixs) == 2, repr(exe)
        else:  # inc(b) and slow_add share chain 1: one segment, reading ma in place
            assert exe.cuda_graphs == 2 and not consumer.transfer_ixs, repr(exe)
            assert consumer.static_in[ma_sym] is exe._segments[0].outs[ma_sym]
        feeds = [{wa: torch.full((n,), float(v), device="cuda"),
                  wb: torch.full((n,), 10.0 * v, device="cuda")} for v in (1, 2)]
        torch.cuda.synchronize()
        res = [exe.replay(feeds=f, sync="dispatch").get() for f in feeds]
        torch.cuda.synchronize()
        for v, r in zip((1, 2), res):
            assert torch.equal(r[node], torch.full((n,), 11.0 * v + 2.0, device="cuda")), v
    finally:
        reset_runtime()


@pytest.mark.cuda
def test_torch_cuda_graph_fleet_memory_stays_bounded_over_50_replays():
    """The graph memory is allocated at instantiate: 50 replays of a plan
    over 4 logical devices do not grow the reserved memory."""
    _need_cuda()
    try:
        devs = _logical(4)
        n, chunks = 1 << 20, 8
        exe, nodes, _, _ = _fleet_graph(devs, n, chunks, "fused")
        xs = [torch.randn(n, device="cuda") for _ in range(chunks)]
        torch.cuda.synchronize()
        feeds = dict(zip(nodes, xs))
        for _ in range(5):
            exe.replay(feeds=feeds).get()
        before = torch.cuda.memory_reserved()
        for _ in range(50):
            exe.replay(feeds=feeds).get()
        assert torch.cuda.memory_reserved() <= before + n * 4 * chunks, \
            (before, torch.cuda.memory_reserved())
    finally:
        reset_runtime()


def _fleet_engines(arch, devs, decode_shapes=(1,)):
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = smoke(get_config(arch))
    params = get_model(cfg).init(cfg, generator=torch.Generator(device="cuda").manual_seed(0),
                                 device="cuda")
    ref = PagedServeEngine.from_config(cfg, params=params, devices=devs[:1], max_seq_len=64,
                                       decode_shapes=decode_shapes, name=f"t-ref-{arch}")
    eng = PagedServeEngine.from_config(cfg, params=params, devices=devs, max_seq_len=64,
                                       decode_shapes=decode_shapes,
                                       scheduler=Scheduler(devs), name=f"t-fleet-{arch}")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, cfg.vocab_size, size=s).astype(np.int32) for s in (5, 14, 17, 9)]
    return cfg, ref, eng, prompts


def _step_one_by_one(eng, reqs):
    """One decode step of each request alone (one row: the same products
    whatever its neighbours), on its own device's lane."""
    for r in reqs:
        eng._lane_for(r.seq.device)._step([r])


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["olmo-1b", "mamba2-130m"])
def test_torch_cuda_paged_tokens_survive_defrag_and_migrate_between_replays(arch):
    """Replayed decode steps (one CUDA graph a lane, captured against the
    pool's slabs by address) with a ``defrag`` that moves every live page
    and a ``migrate`` to the other logical device's pool between them: the
    tokens and states equal an undisturbed engine's; the slabs keep their
    storage, so lane 0 never recaptures."""
    _need_cuda()
    try:
        devs = _logical(2)
        cfg, ref, eng, prompts = _fleet_engines(arch, devs)
        filler = _resident(eng, prompts[:1])[0]  # the lowest pages: freed for the defrag
        reqs, rreqs = _resident(eng, prompts), _resident(ref, prompts)
        pool = eng.kv.pool_of(devs[0])
        ptrs = [t.data_ptr() for t in pool.arrays()]
        for i in range(10):
            if i == 3:
                eng.kv.free_seq(filler.seq)
                assert eng.kv.defrag(devs[0]) > 0
            if i == 6:
                eng.kv.migrate(reqs[1].seq, devs[1])
                assert reqs[1].seq.device is devs[1]
            _step_one_by_one(eng, reqs)
            _step_one_by_one(ref, rreqs)
        m = eng.metrics()["decode_by_device"]
    finally:
        ref.close()
        eng.close()
        reset_runtime()
    assert [r.out for r in reqs] == [r.out for r in rreqs]
    for r, q in zip(reqs, rreqs):
        for n in (r.seq.state or {}):
            assert torch.equal(r.seq.state[n], q.seq.state[n])
    assert [t.data_ptr() for t in pool.arrays()] == ptrs
    assert m[devs[0].key]["graphs_captured"] == 1 and m[devs[1].key]["graphs_captured"] == 1
    assert m[devs[0].key]["replayed_steps"] == 10 * 4 - 4 - 1
    assert m[devs[1].key]["eager_steps"] == 1 and m[devs[1].key]["replayed_steps"] == 3


@pytest.mark.cuda
def test_torch_cuda_spill_racing_a_replayed_step_waits_for_it():
    """A spill asked for while a replayed step of the sequence is still
    running on the device (held back by a ~0.1 s sleep kernel on the lane's
    stream) waits for the step and its event: the pages stay with the
    sequence until then, and the tokens after the refetch are the
    undisturbed engine's."""
    _need_cuda()
    try:
        devs = _logical(2)
        cfg, ref, eng, prompts = _fleet_engines("olmo-1b", devs)
        reqs, rreqs = _resident(eng, prompts[:2]), _resident(ref, prompts[:2])
        lane = eng._lane_for(devs[0])
        for _ in range(2):  # eager + capture, then a replay
            _step_one_by_one(eng, reqs)
            _step_one_by_one(ref, rreqs)
        replay = lane._graphs.step

        def held_back(*a):
            torch.cuda._sleep(SLEEP_CYCLES)  # on the lane's stream, ahead of the replay
            return replay(*a)

        lane._graphs.step = held_back
        r = reqs[0]
        pages = list(r.seq.pages)
        t = threading.Thread(target=lambda: lane._step([r]))
        t.start()
        time.sleep(0.02)  # the step holds the sequence; its kernels are queued
        f = r.seq.spill()
        time.sleep(0.03)
        assert not f.done() and r.seq.pages == pages and not r.seq.spilled
        t.join(timeout=60)
        assert not t.is_alive() and f.get(timeout=60) is True and r.seq.spilled
        lane._graphs.step = replay
        _step_one_by_one(ref, rreqs[:1])  # the step the spill raced
        for _ in range(3):
            _step_one_by_one(eng, reqs)  # the first refetches the spilled sequence
            _step_one_by_one(ref, rreqs)
        d = eng.metrics()
    finally:
        ref.close()
        eng.close()
        reset_runtime()
    assert [q.out for q in reqs] == [q.out for q in rreqs]
    assert d["spills"] >= 1 and d["refetches"] >= 1


# ---------------------------------------------------------------------------
# RequestEngine on the card: the graph route is a real CUDA graph
# ---------------------------------------------------------------------------


def _map_rounds(x, rounds=2):
    """The engine phase's step at a smaller size: ``v <- partition_map(v) *
    0.5 + v * 0.5``, the hand-written kernel on a CUDA tensor."""
    v = x
    for _ in range(rounds):
        v = map_ops.partition_map(v.reshape(-1)).reshape(v.shape) * 0.5 + v * 0.5
    return v


def _engine_results(step, payloads, graph, name, **kw):
    from repro_torch.serving import RequestEngine

    dev = get_all_devices(1, 0).get()[0]
    eng = RequestEngine(step, max_batch=4, max_delay_s=0.002, graph=graph,
                        scheduler=Scheduler([dev]), name=name, **kw)
    try:
        futs = [eng.submit(p) for p in payloads]
        return [f.get(timeout=120) for f in futs], eng, dev
    finally:
        eng.close()


@pytest.mark.cuda
def test_torch_cuda_engine_graph_route_bit_equal_to_direct():
    """Batches replayed from the engine's CUDA graphs, back to back on one
    route, give the direct route's bits; each route is one CUDA graph on the
    engine's own stream, and its replays ran the kernel."""
    _need_cuda()
    rng = np.random.default_rng(11)
    payloads = [(rng.normal(size=(1, 4096)) * 10).astype(np.float32) for _ in range(24)]
    got, eng, dev = _engine_results(_map_rounds, payloads, True, "t-cuda-graph")
    want, _, _ = _engine_results(_map_rounds, payloads, False, "t-cuda-direct")
    for g, w, p in zip(got, want, payloads):
        assert np.array_equal(g, w)
        assert np.array_equal(g, _map_rounds(torch.from_numpy(p).cuda()).cpu().numpy())
    entries = list(eng._graphs.values())
    assert entries and all(e is not None and e.exe.cuda_graphs == 1 for e in entries)
    s = eng._streams[dev.key]
    assert s.cuda_stream.cuda_stream != torch.cuda.default_stream().cuda_stream
    assert all(e.exe._last_replay_queue is s.lane for e in entries)
    replayed = sum(e.exe.replayed_launches().get("partition_map", 0) for e in entries)
    assert replayed == 2 * eng.metrics()["batches"]


@pytest.mark.cuda
def test_torch_cuda_engine_six_pos_values_share_one_graph():
    """``pos`` is a 0-d write-fed input of the graph, not a constant baked
    into the capture: six values through one route, six right results."""
    _need_cuda()
    from repro_torch.serving import RequestEngine

    dev = get_all_devices(1, 0).get()[0]
    eng = RequestEngine(lambda b: {"y": b["x"] + b["pos"].to(torch.float32)}, max_batch=2,
                        max_delay_s=0.002, scheduler=Scheduler([dev]), name="t-cuda-pos")
    try:
        for pos in range(6):
            got = eng.submit({"x": np.zeros((1, 4), np.float32),
                              "pos": np.int32(pos)}).get(timeout=120)
            np.testing.assert_array_equal(got["y"], np.full((1, 4), float(pos), np.float32))
        routes = [(k, v) for k, v in eng._graphs.items() if v is not None]
        assert len(routes) == 1 and routes[0][1].exe.cuda_graphs == 1
        assert routes[0][1].exe.graph_replays == 6
    finally:
        eng.close()


@pytest.mark.cuda
def test_torch_cuda_engine_host_sync_step_falls_back_and_the_next_capture_works():
    """A step that reads a value on the host (``.item()``) cannot be
    captured: its route is None, it is served directly with the right
    results, and the engine's next capture (another step) succeeds."""
    _need_cuda()

    def synced(x):
        return x * float(x.abs().max().item())

    rng = np.random.default_rng(12)
    payloads = [rng.normal(size=(1, 64)).astype(np.float32) for _ in range(6)]
    got, eng, _ = _engine_results(synced, payloads, True, "t-cuda-sync")
    assert eng._graphs and set(eng._graphs.values()) == {None}
    for g, p in zip(got, payloads):
        assert g.shape == p.shape and np.isfinite(g).all()
    got, eng, _ = _engine_results(_map_rounds, payloads, True, "t-cuda-after")
    entries = list(eng._graphs.values())
    assert entries and all(e is not None and e.exe.cuda_graphs == 1 for e in entries)
    for g, p in zip(got, payloads):
        assert np.array_equal(g, _map_rounds(torch.from_numpy(p).cuda()).cpu().numpy())


@pytest.mark.cuda
def test_torch_cuda_make_serve_engine_matches_per_request_eager_decode():
    """``make_serve_engine`` on smoke(olmo-1b) on the card: a batch of
    three requests against each decoded alone by ``make_serve_step``:
    equal tokens, logits within 2e-4."""
    _need_cuda()
    from repro_torch.serving import cache_to_rows, make_serve_engine, rows_to_cache
    from repro_torch.serving.serve_step import make_serve_step

    cfg = smoke(get_config("olmo-1b"))
    m = get_model(cfg)
    params = m.init(cfg, generator=torch.Generator(device="cuda").manual_seed(0), device="cuda")
    dev = get_all_devices(1, 0).get()[0]
    rng = np.random.default_rng(13)
    shape = (1, cfg.num_layers, 8, cfg.num_kv_heads, cfg.hd)
    reqs = [{"cache": {"k": rng.normal(size=shape).astype(np.float32),
                       "v": rng.normal(size=shape).astype(np.float32)},
             "tokens": rng.integers(0, cfg.vocab_size, size=(1, 1)).astype(np.int32),
             "pos": np.int32(3)} for _ in range(3)]
    eng = make_serve_engine(cfg, params, max_batch=4, max_delay_s=0.2,
                            scheduler=Scheduler([dev]))
    try:
        got = [f.get(timeout=120) for f in [eng.submit(r, kind="decode") for r in reqs]]
        assert eng.metrics()["batches"] == 1
    finally:
        eng.close()
    step = make_serve_step(cfg, params)
    for r, g in zip(reqs, got):
        cache = rows_to_cache({k: torch.from_numpy(v).cuda() for k, v in r["cache"].items()})
        nxt, logits, cache = step(cache, torch.from_numpy(r["tokens"]).cuda(), 3)
        np.testing.assert_array_equal(g["next"], nxt.cpu().numpy())
        np.testing.assert_allclose(g["logits"], logits.cpu().numpy(), rtol=0, atol=2e-4)
        for k, v in cache_to_rows(cache).items():
            np.testing.assert_allclose(g["cache"][k], v.cpu().numpy(), rtol=0, atol=2e-4)


# ---------------------------------------------------------------------------
# training: the kernels inside autograd (kernels._autograd)
# ---------------------------------------------------------------------------

# loss_fn gradients with the kernels in the forward against the plain path,
# in f32: every leaf within 1e-3 of its largest gradient (chip_smoke's
# grad_parity bound; the forwards differ by the kernels' f32 rounding).
GRAD_PARITY_TOL = 1e-3


def _grad_run(cfg, params, batch, impl, **kw):
    from repro_torch.pytree import tree_flatten, tree_unflatten

    leaves, treedef = tree_flatten(params)
    masters = [p.detach().requires_grad_(True) for p in leaves]
    reset_launch_counts()
    loss = get_model(cfg).loss_fn(cfg, tree_unflatten(treedef, masters), batch, impl=impl, **kw)
    grads = torch.autograd.grad(loss, masters)
    torch.cuda.synchronize()
    return float(loss.detach()), grads, launch_counts()


@pytest.mark.cuda
@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("arch,seq,kernel", [("olmo-1b", 64, "flash_attention"),
                                             ("mamba2-130m", 100, "ssd_scan"),
                                             ("hymba-1.5b", 12, "flash_attention")])
def test_torch_cuda_loss_fn_grads_kernel_vs_plain(arch, seq, kernel, remat):
    """Smoke configs in f32 on the card (hymba: 12 tokens + 4 meta fit its
    window of 16, so every layer takes flash; its SSM heads take ssd_scan
    too): loss within 1e-5, every gradient leaf within ``GRAD_PARITY_TOL``
    of its largest; the kernel launches once a layer in the forward (and
    again in each recompute under full remat), never on the plain path."""
    _need_cuda()
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import make_batch

    cfg = smoke(get_config(arch))
    params = get_model(cfg).init(cfg, generator=torch.Generator(device="cuda").manual_seed(0),
                                 device="cuda")
    batch = make_batch(cfg, ShapeConfig("t", seq_len=seq, global_batch=2, kind="train"), seed=1,
                       device="cuda")
    la, ga, ca = _grad_run(cfg, params, batch, "auto", remat=remat)
    lr, gr, cr = _grad_run(cfg, params, batch, "ref", remat=remat)
    np.testing.assert_allclose(la, lr, rtol=1e-5)
    for a, b in zip(ga, gr):
        assert float((a - b).abs().max()) <= GRAD_PARITY_TOL * float(b.abs().max())
    per_layer = 1 if remat == "none" else 2
    assert ca[kernel] == per_layer * cfg.num_layers and cr[kernel] == 0, (ca, cr)
    if arch == "hymba-1.5b":
        assert ca["ssd_scan"] == per_layer * cfg.num_layers and cr["ssd_scan"] == 0


@pytest.mark.cuda
def test_torch_cuda_train_step_kernel_vs_plain():
    """One ``make_train_step`` step of smoke olmo-1b (f32 compute, remat
    full) with the kernels against the plain path: loss within 1e-5; params
    within rtol 2e-4 atol 2e-6 but where AdamW's denominator is within 10
    eps (the update is then rounding noise over eps; at most 1 in 1000)."""
    _need_cuda()
    import dataclasses

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distribution.recipes import plan_for
    from repro_torch.models import make_batch
    from repro_torch.pytree import tree_flatten
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.train_step import make_init, make_train_step

    cfg = smoke(get_config("olmo-1b"))
    shape = ShapeConfig("t", seq_len=128, global_batch=4, kind="train")
    plan = dataclasses.replace(plan_for(cfg, shape), remat="full", compute_dtype="float32")
    opt = OptConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    batch = make_batch(cfg, shape, seed=3, device="cuda")
    out = {}
    for impl in ("auto", "ref"):
        params, state = make_init(cfg, opt, device="cuda")(0)
        reset_launch_counts()
        p2, s2, metrics = make_train_step(cfg, shape, opt, plan, impl=impl)(params, state, batch)
        torch.cuda.synchronize()
        out[impl] = (float(metrics["loss"]), tree_flatten(p2)[0], tree_flatten(s2["v"])[0],
                     launch_counts()["flash_attention"])
    np.testing.assert_allclose(out["auto"][0], out["ref"][0], rtol=1e-5)
    assert out["auto"][3] == 2 * cfg.num_layers and out["ref"][3] == 0
    n_ill = n = 0
    for a, b, v in zip(out["auto"][1], out["ref"][1], out["ref"][2]):
        ill = torch.sqrt(v / (1 - opt.b2)) < 10 * opt.eps
        torch.testing.assert_close(a[~ill], b[~ill], rtol=2e-4, atol=2e-6)
        n_ill += int((~torch.isclose(a, b, rtol=2e-4, atol=2e-6) & ill).sum())
        n += a.numel()
    assert n_ill <= n // 1000


@pytest.mark.cuda
def test_torch_cuda_raw_wrappers_raise_under_grad():
    """The raw kernel wrappers refuse an input that requires grad (they
    have no backward), and run it under ``no_grad``."""
    _need_cuda()
    q = torch.randn(1, 64, 2, 16, device="cuda")
    k, v = torch.randn(1, 64, 2, 16, device="cuda"), torch.randn(1, 64, 2, 16, device="cuda")
    x = torch.randn(1, 64, 2, 16, device="cuda")
    dt = torch.rand(1, 64, 2, device="cuda") * 0.1
    A = -torch.ones(2, device="cuda")
    Bm, Cm = torch.randn(1, 64, 1, 8, device="cuda"), torch.randn(1, 64, 1, 8, device="cuda")
    qd = torch.randn(2, 2, 16, device="cuda")
    kp, vp = torch.randn(4, 16, 2, 16, device="cuda"), torch.randn(4, 16, 2, 16, device="cuda")
    table = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32, device="cuda")
    lengths = torch.tensor([5, 20], dtype=torch.int32, device="cuda")
    calls = [(lambda t: flash_kernel.flash_attention(t, k, v), q),
             (lambda t: ssd_kernel.ssd_scan(t, dt, A, Bm, Cm), x),
             (lambda t: paged_kernel.paged_attention(t, kp, vp, table, lengths), qd)]
    for call, t in calls:
        with pytest.raises(RuntimeError, match="no backward"):
            call(t.clone().requires_grad_())
        with torch.no_grad():
            call(t.clone().requires_grad_())
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_torch_cuda_train_driver_and_resume():
    """``launch.train.train`` on the card at smoke size: finite losses, flash
    once a layer and again in each recompute (the plan's dots), and a
    kill-and-resume equal to the straight run within 1e-5."""
    _need_cuda()
    import tempfile

    from repro_torch.launch.train import train

    kw = dict(use_smoke=True, batch=4, seq=64, lr=1e-3, log_every=0, seed=5, device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        reset_launch_counts()
        full = train("olmo-1b", steps=6, ckpt_dir=os.path.join(tmp, "a"), ckpt_every=100, **kw)
        assert launch_counts()["flash_attention"] == 6 * 2 * 2
        train("olmo-1b", steps=3, ckpt_dir=os.path.join(tmp, "b"), ckpt_every=3,
              schedule_total=6, **kw)
        resumed = train("olmo-1b", steps=6, ckpt_dir=os.path.join(tmp, "b"), resume=True,
                        ckpt_every=100, **kw)
    assert all(np.isfinite(full["losses"]))
    np.testing.assert_allclose(resumed["final_loss"], full["final_loss"], rtol=1e-5)


# ---------------------------------------------------------------------------
# elastic training over local workers: each shard a captured CUDA graph
# ---------------------------------------------------------------------------


def _elastic(arch, workers, devices, **kw):
    from repro_torch.training.elastic import ElasticTrainer

    return ElasticTrainer(arch, use_smoke=True, batch=4, seq=64, workers=workers,
                          devices=devices, total_steps=5, device="cuda", **kw)


@pytest.mark.cuda
def test_torch_cuda_elastic_midstep_kill_bit_identical_over_logical_devices():
    """Smoke olmo-1b over 2 logical devices of the card, worker 1 killed
    inside step 1: the tail equals, bit for bit, a clean 1-worker run from
    the snapshot on the survivor's device (every shard a CUDA graph)."""
    _need_cuda()
    devs = _logical(2)
    t = _elastic("olmo-1b", 2, devs)
    try:
        t.run(1)
        snap = t.snapshot()
        t.workers[1].kill_at_step(t.cursor)
        tail = t.run(3)["losses"]
        assert [e[:3] for e in t.events] == [("death", 1, 1)]
    finally:
        t.close()
    ref = _elastic("olmo-1b", 1, [devs[0]], state=(snap["params"], snap["opt_state"]),
                   start_step=snap["step"])
    try:
        assert ref.run(3)["losses"] == tail
        assert all(np.isfinite(tail))
    finally:
        ref.close()
    reset_runtime()


@pytest.mark.cuda
def test_torch_cuda_elastic_graph_and_jit_routes_agree(monkeypatch):
    """The replayed shard graphs and the direct eager route give the same
    losses within rtol 1e-5 on the card, 2 workers on 2 logical devices."""
    _need_cuda()
    devs = _logical(2)
    losses = {}
    for route in ("graph", "jit"):
        monkeypatch.setenv("REPRO_ELASTIC_ROUTE", route)
        t = _elastic("olmo-1b", 2, devs)
        try:
            losses[route] = t.run(3)["losses"]
        finally:
            t.close()
    np.testing.assert_allclose(losses["graph"], losses["jit"], rtol=1e-5)
    reset_runtime()


@pytest.mark.cuda
@pytest.mark.parametrize("arch,kernel", [("olmo-1b", "flash_attention"),
                                         ("mamba2-130m", "ssd_scan")])
def test_torch_cuda_elastic_kernels_counted_inside_shard_graph(arch, kernel):
    """Each shard's captured graph holds the kernel once a layer in the
    forward and once in the remat recompute (the backward's recompute runs
    on autograd's device thread, on the capture stream), and the replays
    run it without the wrapper: its host count is warm-up + capture only."""
    _need_cuda()
    from repro_torch.training import elastic

    reset_runtime()
    reset_launch_counts()
    t = _elastic(arch, 2, None)
    try:
        t.run(3)
    finally:
        t.close()
    cfg = smoke(get_config(arch))
    plan = elastic._get_family(arch, True, 64, 4)["plan"]
    per_replay = cfg.num_layers * (1 if plan.remat == "none" else 2)
    (gexec, *_), = [e for k, e in elastic._GEXECS.items() if k[0][0] == arch]
    assert gexec.cuda_graphs == 1
    assert gexec.recorded_launches == {kernel: per_replay}
    assert gexec.graph_replays == 3 * 2  # 3 steps x 2 shards of 2 rows, one graph
    assert launch_counts()[kernel] == 2 * per_replay  # warm-up + capture
    if kernel == "ssd_scan":
        assert ssd_kernel.kernel_launches == 3 * launch_counts()[kernel]
    reset_runtime()


# ---------------------------------------------------------------------------
# parcels: worker processes with CUDA contexts of their own on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_torch_cuda_cluster_remote_stencil_and_bf16_buffer():
    """A 1-worker cluster on the card: stencil launched by name in the
    worker is bit-equal to the same launch here, the worker's own counter
    shows the kernel ran there, and a bfloat16 RemoteBuffer round-trips."""
    _need_cuda()
    from repro_torch.core import LocalClusterParcelport

    x = torch.from_numpy(np.random.default_rng(2).normal(size=(1 << 20,)).astype(np.float32))
    local = stencil_ops.stencil(x.cuda(), block=(256, 1, 1)).cpu().numpy()
    port = LocalClusterParcelport(n_workers=1, heartbeat_timeout=60.0)
    try:
        rdev = port.devices()[0]
        assert rdev.platform == "cuda" and rdev.capability() >= (9, 0)
        prog = rdev.create_program(["stencil"], name="cuda-stencil").get()
        rbuf = rdev.create_buffer_from(x.numpy()).get()
        prog.run([rbuf], "stencil", block=(256, 1, 1), out=[rbuf]).get()
        assert rbuf.enqueue_read_sync().tobytes() == local.tobytes()
        counts = port.call(rdev.locality_id, "invoke",
                           {"fn": "repro_torch.kernels:launch_counts"}).get()
        assert counts["stencil"] == 1
        h = torch.randn(4096, generator=torch.Generator().manual_seed(5)).to(torch.bfloat16)
        hb = rdev.create_buffer_from(h).get()
        assert hb.dtype == torch.bfloat16
        assert torch.equal(hb.enqueue_read_sync().view(torch.int16), h.view(torch.int16))
        wait_all([rbuf.free(), hb.free()])
    finally:
        port.shutdown()


@pytest.mark.cuda
def test_torch_cuda_cluster_sigkilled_worker_fails_fast_and_leaves_placement():
    """A worker SIGKILLed with a parcel in flight: the pending future fails
    within the monitor's interval, the scheduler stops placing there, the
    survivor keeps serving, and the killed worker's memory goes back to
    the card."""
    _need_cuda()
    from repro_torch.core import LocalClusterParcelport

    port = LocalClusterParcelport(n_workers=2, heartbeat_timeout=30.0)
    try:
        a, b = port.devices()
        held = b.create_buffer(64 << 20, np.float32).get()  # 256 MiB on the card
        del held
        free0 = torch.cuda.mem_get_info()[0]
        pending = port.call(b.locality_id, "invoke", {"fn": "time:sleep", "payload": 20.0})
        port.process(b.locality_id).kill()
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="failed"):
            pending.get(timeout=15)
        assert time.monotonic() - t0 < 10
        sched = Scheduler([a, b], policy="round_robin")
        assert {sched.select().key for _ in range(4)} == {a.key}
        prog = a.create_program(["partition_map"], name="survivor").get()
        x = np.linspace(-3.0, 3.0, 1 << 16, dtype=np.float32)
        res = np.asarray(prog.run([x], "partition_map").get()[0])
        np.testing.assert_allclose(res, np.ones_like(x), rtol=1e-5)
        deadline = time.monotonic() + 10
        while torch.cuda.mem_get_info()[0] <= free0 and time.monotonic() < deadline:
            time.sleep(0.2)
        assert torch.cuda.mem_get_info()[0] > free0  # its context left the card
    finally:
        port.shutdown()


@pytest.mark.cuda
def test_torch_cuda_engine_serves_over_2_process_cluster_bit_equal():
    """``RequestEngine("partition_map")`` over two worker processes on the
    card: every micro-batch one apply_batched parcel, each request's rows
    bit-equal to the plain version on the card.  The kernel takes a 1-D
    tensor, so a request is 4096 rows of one element and a batch up to 4
    requests."""
    _need_cuda()
    from repro_torch.core import LocalClusterParcelport
    from repro_torch.serving import RequestEngine

    n = 4096
    port = LocalClusterParcelport(n_workers=2, heartbeat_timeout=60.0)
    try:
        sched = Scheduler(port.devices(), policy="round_robin")
        eng = RequestEngine("partition_map", max_batch=4 * n, max_delay_s=0.01, scheduler=sched,
                            name="t-cuda-cluster")
        try:
            rng = np.random.default_rng(5)
            payloads = [(rng.normal(size=(n,)) * 10).astype(np.float32) for _ in range(8)]
            futs = [eng.submit(p) for p in payloads]
            for p, f in zip(payloads, futs):
                got = f.get(timeout=300)
                want = partition_map_ref(torch.from_numpy(p).cuda()).cpu().numpy()
                assert got.dtype == want.dtype and np.array_equal(got, want)
            assert len(sched.stats()) == 2  # both worker processes served
            counts = [port.call(d.locality_id, "invoke",
                                {"fn": "repro_torch.kernels:launch_counts"}).get()
                      for d in port.devices()]
            assert all(c["partition_map"] > 0 for c in counts)
        finally:
            eng.close()
    finally:
        port.shutdown()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["olmo-1b", "mamba2-130m"])
def test_torch_cuda_paged_ship_decode_in_a_worker(arch):
    """Prefill here, ship the sequence to a worker process on the card and
    decode there on a one-row CUDA graph: the tokens equal the
    single-locality engine's, the graph is captured once and replayed, and
    an attention family's decode runs paged_attention on the worker's
    device (its own counters, read through ``invoke``)."""
    _need_cuda()
    from repro_torch.core import LocalClusterParcelport
    from repro_torch.serving.paged import sample_token

    cfg = smoke(get_config(arch))
    dev = get_all_devices().get()[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = get_model(cfg).init(cfg, generator=gen, device=dev.torch_device)
    prompts = [np.random.default_rng(3).integers(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in (17, 40)]
    new = 8
    eng = PagedServeEngine.from_config(cfg, params=params, devices=[dev], max_seq_len=64,
                                       pool_pages=16, name=f"t-cuda-ship-{arch}")
    try:
        want = [list(np.asarray(eng.submit(p, new, request_id=i).get(timeout=300)))
                for i, p in enumerate(prompts)]
        max_pages = eng.max_pages
    finally:
        eng.close()
    m = get_model(cfg)
    kv = PagedKVCache(m.paged_spec(cfg), devices=[dev], pool_pages=16)
    port = LocalClusterParcelport(n_workers=1, heartbeat_timeout=60.0)
    try:
        lid = port.localities()[0].process_index
        got = []
        for i, p in enumerate(prompts):
            with torch.no_grad():
                k, v, state, logits = m.paged_prefill(cfg, params,
                                                      torch.from_numpy(p)[None].cuda())
            seq = kv.new_seq(dev)
            kv.append(seq, k[0], v[0])
            if state is not None:
                seq.set_state({n: t[0] for n, t in state.items()})
            payload = kv.export_seq(seq)
            kv.free_seq(seq)
            got.append(list(np.asarray(port.call(lid, "invoke", {
                "fn": "repro_torch.serving.paged:paged_worker_decode", "payload": {
                    "name": "ship", "config": arch, "smoke": True, "seed": 0,
                    "pool_pages": 16, "seq": payload,
                    "first_token": sample_token(logits[0].cpu().numpy(), None, i, 0),
                    "max_new": new, "max_pages": max_pages, "request_id": i}}).get(
                timeout=300))))
        stats = port.call(lid, "invoke", {"fn": "repro_torch.serving.paged:paged_worker_stats",
                                          "payload": {"name": "ship"}}).get()["ship"]
        counts = port.call(lid, "invoke", {"fn": "repro_torch.kernels:launch_counts"}).get()
    finally:
        port.shutdown()
    assert got == want
    steps = len(prompts) * (new - 1)
    assert stats["eager_steps"] == stats["graphs_captured"] == 1
    assert stats["replayed_steps"] == steps - 1
    layers = 0 if cfg.family == "ssm" else cfg.num_layers
    on_device = (counts["paged_attention"] - stats["captured_launches"].get("paged_attention", 0)
                 + stats["replayed_launches"].get("paged_attention", 0))
    assert on_device == layers * steps


@pytest.mark.cuda
def test_torch_cuda_train_under_a_one_rank_mesh():
    """``train(mesh=make_host_mesh(1, 1))`` on the card: a one-rank NCCL
    group of its own, params as DTensors, the flash kernel launched on the
    local shards as often as the unsharded route launches it, the losses
    the unsharded route's; ``reset_runtime()`` destroys the group."""
    _need_cuda()
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import train

    reset_launch_counts()
    want = train("olmo-1b", steps=3, batch=2, seq=64, log_every=0)
    want_flash = launch_counts()["flash_attention"]
    mesh = make_host_mesh(1, 1)
    try:
        assert dist.get_backend() == "nccl" and mesh.device_type == "cuda"
        reset_launch_counts()
        got = train("olmo-1b", steps=3, batch=2, seq=64, log_every=0, mesh=mesh)
        flash = launch_counts()["flash_attention"]
        assert isinstance(got["params"]["layers"]["attn"]["wq"], DTensor)
    finally:
        reset_runtime()
    assert not dist.is_initialized()
    assert flash == want_flash > 0
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
