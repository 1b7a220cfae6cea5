"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

The main path is the paper's Listings 1-2 and its three workloads, run
through the port's entry points (``get_all_devices``,
``create_program_with_file``, buffers, streams and events, ``Program.run``
with ``Dim3`` geometry, ``enqueue_read``):

  fig3  the PRK stencil on 4 inputs of 2**26 f32, futurized: H2D, build,
        launch, D2H;
  fig4  partition_map over 2**28 f32 (fig4_partition.py's size at m = 8)
        in 4 partitions, each H2D -> kernel -> D2H on its own stream, timed
        with 1 stream and with 4, with each copy's rate;
  fig5  Mandelbrot at 4096 x 4096, 64 iterations, images written through
        ``async_``;
  serve OLMo-1B at full width and depth (seeded random weights, f32, TF32
        off): 8 requests in two groups of 4 with prompts of 1000 and 2000
        tokens, each group one future on its own ``Stream``: one
        ``make_prefill`` call, its KV written into an ``init_cache`` of
        prompt + 32 slots, then 32 greedy ``serve_step`` calls.  The prefill
        attention runs the flash kernel (16 layers x 2 prefills = 32
        launches).  The same requests then run with the plain attention
        (``impl="ref"``), held against the kernel run (last-position logits
        within ``SERVE_LOGIT_TOL``, identical greedy tokens up to near-ties
        of the plain run), and with the params in bf16, timed.
  serve_ssm  Mamba2-130M at full width and depth the same way: prompts of
        1000 and 4000 tokens, 32 greedy steps decoded from the prefill's own
        cache (the recurrent state and conv window).  Every layer's prefill
        scan runs the ssd_scan kernel (24 layers x 2 prefills = 48
        calls, 3 kernel launches each); the plain run scans with
        ``ssd_chunked``.
  serve_paged  the serve phase's model, f32 weights and 8 requests through
        one ``PagedServeEngine.from_config`` (pages of 16 tokens, a pool
        that holds every request), 33 tokens each: both prefill groups, then
        every resident request in the same decode steps (CUDA graphs), each
        layer's attention through the paged_attention kernel (16 launches a
        step).  Then again with ``impl="ref"`` (the gather path); the
        tokens of both are held against the serve phase's plain run.
  serve_paged_ssm  Mamba2-130M the same way (the recurrent state rides per
        sequence; no paged_attention launch).
  graph the chain of ``examples/graph_replay.py`` with the port's kernels,
        stencil -> partition_map -> an elementwise shift at fig3's 2**26
        f32: eager through ``Program.run``, then ``Device.capture`` ->
        ``instantiate`` (one CUDA graph) -> 100 ``replay(feeds=...)`` with
        fresh inputs, each bit-equal to the eager chain on the same input;
        then a two-chain plan joined by an add (three segments on two
        lanes, a CUDA graph each, one event edge).
  fleet partition_map through ``run_on_any`` over 4 logical devices of the
        card (fig6's shape, fig4's 2**28 f32 in 16 chunks), by policy.
  graph_fleet  the same chunks, each partition_map -> stencil, recorded
        through ``run_on_any`` (``round_robin``) over the 4 logical devices
        and replayed through one future: a CUDA graph a segment, a transfer
        step and a cross-device event edge a chunk; 20 replays with fresh
        feeds bit-equal to the eager ``run_on_any`` DAG and to one device's
        kernels, then host us and device ms a replay against that DAG.
  engine  ``examples/serving_engine.py``'s workload on the partition_map
        kernel: 64 single-row requests of 2**20 f32 (4 rounds of
        partition_map a step) through ``RequestEngine`` (batches of up to
        8, a CUDA graph a bucket, replayed on the engine's stream), against
        the same requests one by one through ``Program.run``, bit for bit.
  serve_engine  OLMo-1B at full width and depth, f32: 4 requests of
        512-token prompts prefilled through a ``RequestEngine`` lane (the
        flash kernel, one batch of 2048 tokens), then 8 greedy steps
        through ``make_serve_engine``, each request held against itself
        served alone; the first step again through ``make_serve_fanout``
        over 2 logical devices.
  serve_moe  Qwen1.5-MoE-A2.7B at full width and depth (60 experts top-4 and
        a shared expert, 14.3 B parameters, 57.3 GB in f32) through the serve
        flow with the serve phase's prompts: the f32 kernel run (flash in
        the prefill, 24 layers x 2 groups) with every routing decision
        recorded; the plain run with that routing replayed, held to it
        (logits within ``SERVE_LOGIT_TOL``, tokens up to near-ties); the
        plain run unpinned, its differing routing decisions counted and
        printed with their router margins; then bf16 after the f32 params
        are freed.
  serve_paged_moe  the same requests through ``PagedServeEngine`` (MoE
        dispatched per row, decode on CUDA graphs, paged_attention 24 a
        step), the kernel run held to the plain paged run; a request that
        differs is run again alone both ways and must show a near-tie of
        the logits or of the router.
  serve_paged_encdec  whisper-tiny at full size through ``PagedServeEngine``:
        prompts of 64 and 256 tokens in groups of 4, each request with its
        own (1500, 384) f32 frames as ``extras``, 32 tokens; flash on the
        encoder (non-causal, counted apart) and the decoder prefill
        (causal), 4 launches of each a prefill batch; paged_attention 4 a
        step; the cross K/V (18 MB a
        request) rides as the sequence's state.  Both runs are held to the
        reference's padded oracle on the plain path.
  serve_paged_hybrid  Hymba-1.5B at full width and depth (32 layers of
        attention and Mamba-2 heads in parallel, 128 meta tokens, windows of
        1024 but on 3 global layers, K/V shared by pairs of layers; 1.63 B
        parameters, f32) through ``PagedServeEngine``: 4 prompts of 700
        tokens and 4 of 2000, 32 tokens each.  flash on every layer of a
        prefill batch that fits the window with its meta tokens (828), on
        the 3 global layers of a longer one (2128: the SWA layers run the
        plain windowed blocks); ssd_scan on every layer of each batch;
        paged_attention on the 3 global layers a decode step (the 16 SWA
        producers rebuild their rings from the pages, plain).  Both runs
        are held to the padded oracle (ring caches) and to each other.

The paged phases decode on CUDA graphs, one per warm row count: every
decode step is a replay except the first at each count.  A graph's kernels
run on the device without passing the wrappers, so the paged launch check
counts the kernels each graph recorded at capture times its replays.

Every kernel is built from ``src/repro_torch/kernels/csrc`` first (one
``nvcc`` per source, all started together).  The launch counters are set to
0 just before each main-path run (the three fig phases; each serve and
paged serve run; the graph, fleet, graph_fleet, engine and serve_engine
phases, and each run of the moe and encdec phases) and read just after; a
kernel the run did not launch fails it.  Then each
kernel is held against its plain PyTorch version on the card at the main
path's shapes (whisper-tiny's and Hymba-1.5B's among them) and timed
beside its bound.  The script prints the
``kernels`` JSON line, the card's name and power limit, and, last,
``{"ok": true, "device": {...}}``.  It exits non-zero, printing no result,
without CUDA or outside a checkout of the repository.
"""
from __future__ import annotations

import faulthandler
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import record_function  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import Dim3, Scheduler, async_, dataflow, get_all_devices, wait_all  # noqa: E402
from repro_torch.kernels import _build, launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as flash_kernel  # noqa: E402
from repro_torch.kernels.flash_attention.ref import bf16_bound, flash_attention_ref  # noqa: E402
from repro_torch.kernels.mandelbrot import kernel as mandel_kernel  # noqa: E402
from repro_torch.kernels.mandelbrot.ref import mandelbrot_ref  # noqa: E402
from repro_torch.kernels.paged_attention import kernel as paged_kernel  # noqa: E402
from repro_torch.kernels.paged_attention.ref import bf16_bound as paged_bf16_bound  # noqa: E402
from repro_torch.kernels.paged_attention.ref import paged_attention_ref  # noqa: E402
from repro_torch.kernels.partition_map import kernel as map_kernel  # noqa: E402
from repro_torch.kernels.partition_map.ref import partition_map_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_three_pass  # noqa: E402
from repro_torch.kernels.partition_map import ops as map_ops  # noqa: E402
from repro_torch.kernels.stencil import kernel as stencil_kernel  # noqa: E402
from repro_torch.kernels.stencil import ops as stencil_ops  # noqa: E402
from repro_torch.kernels.stencil.ref import stencil_ref  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import moe as moe_model  # noqa: E402
from repro_torch.models.ssm import ssd_chunked  # noqa: E402
from repro_torch.serving import (LanePolicy, PagedKVCache, PagedServeEngine, RequestEngine,  # noqa: E402
                                 cache_to_rows, make_serve_engine, make_serve_fanout,
                                 rows_to_cache)
from repro_torch.serving.serve_step import make_prefill, make_serve_step  # noqa: E402

KERNEL_DIR = ROOT / "src" / "repro_torch" / "kernels"

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM3 bytes/s,
# f32 FLOP/s outside the tensor cores, dense bf16 and TF32 FLOP/s of the
# tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
TF32_FLOP_PER_S = 495e12
# FP32 operations a second when none fuses into an FMA: 132 SMs x 128 FP32
# lanes x the 1.98 GHz boost clock.  The 67 TFLOP/s peak counts an FMA as
# two flops; an operation rounded on its own (mandelbrot's, to stay
# bit-equal to its plain version) takes a lane's slot for one flop.
F32_SLOTS_PER_S = 132 * 128 * 1.98e9

FIG3_N, FIG3_INPUTS = 1 << 26, 4
FIG4_N, FIG4_PARTS = 1 << 28, 4
FIG5_SIZE, FIG5_ITERS, FIG5_IMAGES = 4096, 64, 4
STENCIL_BLOCK = Dim3(256)
MAP_BLOCK = Dim3(256)
MANDEL_BLOCK = Dim3(32, 8)
FIG_KERNELS = ("stencil", "partition_map", "mandelbrot")

GRAPH_N, GRAPH_REPLAYS, GRAPH_TIMED = FIG3_N, 100, 20
GRAPH_FLEET_REPLAYS, GRAPH_FLEET_TIMED = 20, 5
# Sleep cycles (about 2 s on an H100) that hold every stream while the
# graph_fleet steps are issued, so their device time is measured alone.
# The eager DAG's 5 steps take 0.1-0.25 s to issue on the H100's host (its
# host us a step, times 5); a stalled host once took over 0.5 s.
GRAPH_FLEET_HOLD = 4_000_000_000
GRAPH_KERNELS = ("stencil", "partition_map")

SERVE_ARCH = "olmo-1b"
SERVE_BATCH, SERVE_PROMPTS, SERVE_NEW = 4, (1000, 2000), 32
SSM_ARCH, SSM_PROMPTS = "mamba2-130m", (1000, 4000)
PAGED_WARMUP = 16  # tokens of the paged engines' warm-up request
# fleet: fig6's shape, 4 logical devices of the card and fig4's 2**28 f32
# in 16 chunks; the memory-limit run lets 3 chunks reside on a device.
FLEET_DEVICES, FLEET_CHUNKS, FLEET_LIMIT_CHUNKS = 4, 16, 3
FLEET_POLICIES = ("static", "round_robin", "least_loaded", "affinity")
# serve_paged_fleet: 2 logical devices of 300 pages each; each pool holds
# the longest request (127 pages), the two hold 598 of the 768 pages the 8
# requests end at.
PAGED_FLEET_DEVICES, PAGED_FLEET_POOL = 2, 300
SPILL_PAGES = 129  # the sequence whose spill and refetch are timed (4 MiB a page)
# engine: examples/serving_engine.py's workload on the partition_map kernel,
# 64 single-row requests of 2**20 f32, 4 rounds a step, batches of up to 8.
ENGINE_REQUESTS, ENGINE_N, ENGINE_ROUNDS, ENGINE_MAX_BATCH = 64, 1 << 20, 4, 8
# serve_engine: OLMo-1B f32, 4 requests with prompts of 512 tokens, prefilled
# through a RequestEngine lane of a 2048-token budget, then 8 greedy decode
# steps through make_serve_engine; the fan-out over 2 logical devices.
SERVE_ENGINE_BATCH, SERVE_ENGINE_PROMPT, SERVE_ENGINE_NEW = 4, 512, 8
SERVE_ENGINE_BUDGET, SERVE_ENGINE_FANOUT = 2048, 2
# Both engines' assembly deadline: long, so that each burst of the 4 requests
# fills one batch however the submitting thread is scheduled; a full batch
# (4 rows, or the 2048-token budget) dispatches at once, so it adds no wait.
SERVE_ENGINE_DELAY_S = 1.0
# f32 kernel run against the plain run: both sum in f32, in other orders,
# through 16 (OLMo-1B) or 24 (Mamba2-130M) layers; the last-position logits
# of both moved by about 1e-5 on an H100.
SERVE_LOGIT_TOL = 2e-4
# A request stops being compared where the plain run's top-2 logit gap is
# below this: the two runs may then pick either token.
NEAR_TIE = 1e-4
# serve_group's parts, as torch.profiler ranges (tools/profile_torch_serve.py)
SERVE_SPANS = ("serve.prefill", "serve.cache", "serve.decode")
GQA_SHAPE = (1, 2048, 36, 4, 128)  # StarCoder2-7B's heads: B, S, H, K, D
# The f32 kernel against its plain version: the reference's tolerance
# (tests/test_kernels.py).  bf16 is held per element to ``bf16_bound``.
FLASH_F32_TOL = 2e-4
# ssd_scan against ssd_chunked and the sequential recurrence: the
# reference's tolerance (tests/test_kernels.py); all sum in f32.
SSD_TOL = 2e-3
# paged_attention against its plain version in f32: the reference's
# tolerance (tests/test_paged.py); both sum in f32, in other orders.
PAGED_TOL = 1e-5
# serve_moe / serve_paged_moe: Qwen1.5-MoE-A2.7B at full width and depth,
# the serve phase's prompts and steps.  A routing decision is a near-tie
# where its k-th and (k+1)-th router probabilities lie closer than this: a
# rounding of the kernel run may then pick the other expert.
MOE_ARCH = "qwen2-moe-a2.7b"
ROUTER_NEAR_TIE = 1e-4
MOE_PRINTED_FLIPS = 20  # differing routing decisions on the summary line (the JSON has all)
# serve_paged_encdec: whisper-tiny at full size, prompts of 64 and 256 tokens
# in groups of 4 with 32 new tokens (under the decoder's 448 positions), each
# request with its own (1500, 384) f32 frames.
ENCDEC_ARCH, ENCDEC_PROMPTS, ENCDEC_NEW = "whisper-tiny", (64, 256), 32
ENCODER_SHAPE = (4, 1500, 6, 6, 64)  # whisper-tiny's encoder heads: B, S, H, K, D
# serve_paged_hybrid: Hymba-1.5B at full width and depth, f32, 4 prompts of 700
# and 4 of 2000 content tokens (+ 128 meta tokens: 828 fit the 1024-token
# window, so every layer's prefill takes flash; 2128 do not, so the SWA
# layers run the windowed blocks and the ring wraps in decode), 32 tokens each.
HYBRID_ARCH, HYBRID_PROMPTS, HYBRID_NEW = "hymba-1.5b", (700, 2000), 32
# Seconds after which a hung run dumps its threads' stacks and exits (a run
# takes about 175 s; the limit it runs under is 1200).
WATCHDOG_S = 900


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# the three workloads, written against the runtime only (any device)
# ---------------------------------------------------------------------------


def fig3_flow(dev, prog, hosts, block=STENCIL_BLOCK) -> "list[np.ndarray]":
    """Futurized stencil: async H2D of every input and the build overlap;
    each launch (``out`` = its input) follows its copy and the build, each
    D2H its launch."""
    built = prog.build("stencil", block=block)
    bufs = [dev.create_buffer_from(h) for h in hosts]
    outs = [
        dataflow(lambda buf, _: prog.run([buf], "stencil", block=block, out=[buf],
                                         sync="dispatch").get(), b, built)
        for b in bufs
    ]
    reads = [o.then(lambda bl: bl[0].enqueue_read().get()) for o in outs]
    wait_all(reads)
    return [r.get() for r in reads]


def fig4_flow(dev, prog, hosts, ins, outs, streams, block=MAP_BLOCK):
    """Each partition runs H2D -> kernel -> D2H on stream ``i % len(streams)``,
    with an event before and after each step; returns the host results and
    the events ``[(e0, e1, e2, e3)]`` per partition."""
    reads, events = [], []
    for i, h in enumerate(hosts):
        s = streams[i % len(streams)]
        e0 = s.record()
        s.enqueue_write(ins[i], 0, h)
        e1 = s.record()
        s.launch(prog, [ins[i]], "partition_map", block=block, out=[outs[i]], sync="dispatch")
        e2 = s.record()
        reads.append(s.enqueue_read(outs[i]))
        events.append((e0, e1, e2, s.record()))
    wait_all(reads)
    for ev in events:
        ev[-1].wait()
    return [r.get() for r in reads], events


def fig5_flow(dev, prog, size_buf, imgs, out_dir, block=MANDEL_BLOCK) -> "list[np.ndarray]":
    """Mandelbrot images, each read back and written to ``out_dir`` through
    ``async_`` while the next image computes; returns the images."""
    writes, reads = [], []
    for i, img in enumerate(imgs):
        prog.run([size_buf], "mandelbrot", block=block, out=[img], sync="dispatch")
        r = img.enqueue_read()
        reads.append(r)
        writes.append(async_(lambda r=r, i=i: np.save(os.path.join(out_dir, f"img{i}.npy"), r.get())))
    wait_all(writes)
    for w in writes:
        w.get()
    return [r.get() for r in reads]


def top2_gap(logits: "torch.Tensor") -> "torch.Tensor":
    """(B, V) -> (B,): the greedy pick's margin over the runner-up."""
    top = torch.topk(logits.float(), 2, dim=-1).values
    return top[:, 0] - top[:, 1]


def serve_group(dev, stream, cfg, params, prompt: np.ndarray, new_tokens: int, impl: str,
                t_submit: float) -> dict:
    """One group of requests, run as a task of ``stream``: prefill, then
    ``new_tokens`` greedy decode steps from its cache (dense, moe: the KV
    written into a cache of prompt + ``new_tokens`` slots; ssm: the
    prefill's recurrent cache itself).  Returns the greedy tokens (B,
    1 + new_tokens), each pick's top-2 gap, the last-position prefill
    logits, every step's last-position logits (B, 1 + new_tokens, V, on the
    device), the times, and whether the work ran on the stream's CUDA
    stream.  Its three parts are the profiler ranges ``SERVE_SPANS``; each
    ends with the device idle."""
    cs = torch.cuda.current_stream(dev.torch_device) if dev.is_cuda else None
    on_stream = cs is None or cs.cuda_stream == stream.cuda_stream.cuda_stream
    sync = cs.synchronize if cs is not None else (lambda: None)
    prefill, step = make_prefill(cfg, params, impl=impl), make_serve_step(cfg, params)
    B, S = prompt.shape
    span_prefill, span_cache, span_decode = SERVE_SPANS
    t0 = time.perf_counter()
    with record_function(span_prefill):
        logits, kv = prefill({"tokens": torch.from_numpy(prompt).to(dev.torch_device)})
        sync()
    t1 = time.perf_counter()
    with record_function(span_cache):
        tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        toks, gaps, lasts = [tok.cpu()], [top2_gap(logits[:, -1])], [logits[:, -1]]
        t_first = time.perf_counter()
        if cfg.family in ("dense", "moe", "vlm"):
            # init_cache's (L, B, S + new, K, hd) layout, keys then values,
            # each prefill tensor freed once copied: only half the KV is
            # ever held twice (Qwen1.5-MoE's f32 KV at 4 x 2000 is 3.1 GB)
            cache = {}
            for n in ("k", "v"):
                rows = kv.pop(n)
                cache[n] = rows.new_zeros((*rows.shape[:2], S + new_tokens, *rows.shape[3:]))
                cache[n][:, :, :S] = rows
                del rows
        else:
            cache = kv
        del kv
        sync()
    t2 = time.perf_counter()
    with record_function(span_decode):
        for i in range(new_tokens):
            tok, step_logits, cache = step(cache, tok, S + i)
            toks.append(tok)
            gaps.append(top2_gap(step_logits[:, -1]))
            lasts.append(step_logits[:, -1])
        tokens = torch.cat([t.cpu() for t in toks], dim=1).numpy()
    t3 = time.perf_counter()
    decode_s = t3 - t2
    return {"on_stream": on_stream, "tokens": tokens,
            "gaps": torch.stack(gaps, dim=1).cpu().numpy(),
            "logits_last": logits[:, -1].float().cpu().numpy(),
            "logits_steps": torch.stack(lasts, dim=1),
            "prefill_s": t1 - t0, "ttft_s": t_first - t_submit, "decode_s": decode_s,
            "decode_ms_per_step": decode_s / max(new_tokens, 1) * 1e3,
            "decode_tokens_per_s": B * new_tokens / decode_s}


def serve_flow(dev, cfg, params, prompts, streams, new_tokens: int = SERVE_NEW,
               impl: str = "auto", routes: "RouteLog | None" = None) -> "list[dict]":
    """Each group of prompts (B, S) as one future on its own stream, all
    submitted before any is awaited (as ``route_batches`` submits to device
    lanes); returns each group's ``serve_group`` result.  With ``routes``,
    group ``g``'s routing calls are logged under key ``g``."""
    task = serve_group if routes is None else routes.keyed(serve_group)
    futs = [s.submit(task, dev, s, cfg, params, p, new_tokens, impl, time.perf_counter(),
                     **({} if routes is None else {"key": g}))
            for g, (p, s) in enumerate(zip(prompts, streams))]
    wait_all(futs)
    return [f.get() for f in futs]


def greedy_cuts(got: np.ndarray, want: np.ndarray, want_gaps: np.ndarray,
                near_tie: float = NEAR_TIE) -> "tuple[int, int]":
    """Compare greedy tokens request by request, step by step.  A request
    is no longer compared from the first step where the reference run's
    top-2 gap is below ``near_tie``.  Returns (requests that differ before
    any cut, requests cut)."""
    differ = cuts = 0
    for g, w, gap in zip(got, want, want_gaps):
        for t in range(len(w)):
            if gap[t] < near_tie:
                cuts += 1
                break
            if g[t] != w[t]:
                differ += 1
                break
    return differ, cuts


# ---------------------------------------------------------------------------
# phases on the card
# ---------------------------------------------------------------------------


def host_stencil(x: np.ndarray) -> np.ndarray:
    left = np.concatenate([np.zeros(1, x.dtype), x[:-1]])
    right = np.concatenate([x[1:], np.zeros(1, x.dtype)])
    return np.float32(0.5) * left + x + np.float32(0.5) * right


def phase_fig3(dev, prog, hosts) -> dict:
    t0 = time.perf_counter()
    fig3_flow(dev, prog, hosts)  # first run includes the build and the allocations
    t1 = time.perf_counter()
    got = fig3_flow(dev, prog, hosts)
    t2 = time.perf_counter()
    err = max(float(np.abs(g - host_stencil(h)).max()) for g, h in zip(got, hosts))
    require(all(g.shape == h.shape for g, h in zip(got, hosts)), "fig3: wrong output shape")
    require(err <= 1e-6, f"fig3: stencil differs from the host stencil by {err}")
    return {"first_s": t1 - t0, "wall_s": t2 - t1, "max_abs_err_vs_host": err,
            "bytes": FIG3_INPUTS * FIG3_N * 4}


def phase_fig4(dev, prog, hosts) -> dict:
    part = FIG4_N // FIG4_PARTS
    ins = [dev.create_buffer(part, np.float32).get() for _ in range(FIG4_PARTS)]
    outs = [dev.create_buffer(part, np.float32).get() for _ in range(FIG4_PARTS)]
    # One stream set per variant, reused: PyTorch's caching allocator pools
    # memory per stream, so a warm-up on other streams would not warm these.
    stream_sets = {n: [dev.create_stream() for _ in range(n)] for n in (1, FIG4_PARTS)}
    variants = {"streams_1": 1, f"streams_{FIG4_PARTS}": FIG4_PARTS}
    # The plain version on the card, bit for bit: sqrt(sin^2 + cos^2) lies
    # within 1.2e-7 of 1, so |y - 1| alone would pass a kernel that wrote 1.
    want = [partition_map_ref(h.to(dev.torch_device)).cpu().numpy() for h in hosts]
    require(any((w != 1).any() for w in want), "fig4: the plain version is 1 everywhere")
    out = {name: {"wall_s": []} for name in variants}
    for rep, name in enumerate(list(variants) * 3):  # warm each, then time each twice
        n_streams = variants[name]
        dev.synchronize()
        t0 = time.perf_counter()
        got, events = fig4_flow(dev, prog, hosts, ins, outs, stream_sets[n_streams])
        wall = time.perf_counter() - t0
        err = max(float(np.abs(g - 1.0).max()) for g in got)
        exact = all(np.array_equal(g, w) for g, w in zip(got, want))
        del got  # hand the pinned read buffers back before the next run
        require(err <= 1e-5, f"fig4: |y - 1| = {err} > 1e-5 with {n_streams} stream(s)")
        require(exact, f"fig4: output differs from the plain version with {n_streams} stream(s)")
        if rep < len(variants):
            continue
        nbytes = part * 4
        row = out[name]
        row["wall_s"].append(wall)
        row.update({
            "max_abs_err_vs_one": err,
            "h2d_GBps": [nbytes / e[0].elapsed_ms(e[1]) / 1e6 for e in events],
            "kernel_ms": [e[1].elapsed_ms(e[2]) for e in events],
            "d2h_GBps": [nbytes / e[2].elapsed_ms(e[3]) / 1e6 for e in events],
        })
    return out


def phase_fig5(dev, prog) -> dict:
    size_buf = dev.create_buffer_from(np.array([FIG5_SIZE, FIG5_SIZE], np.int32)).get()
    imgs = [dev.create_buffer((FIG5_SIZE, FIG5_SIZE), np.int32).get() for _ in range(FIG5_IMAGES)]
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_fig5_")
    try:
        t0 = time.perf_counter()
        got = fig5_flow(dev, prog, size_buf, imgs, out_dir)
        wall = time.perf_counter() - t0
        on_disk = np.load(os.path.join(out_dir, f"img{FIG5_IMAGES - 1}.npy"))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    img = got[-1]
    require(img.shape == (FIG5_SIZE, FIG5_SIZE) and img.dtype == np.int32, "fig5: wrong image")
    require(np.array_equal(on_disk, img), "fig5: the image written through async_ differs")
    require(int(img.min()) >= 0 and int(img.max()) == FIG5_ITERS, "fig5: counts out of range")
    col = round((-1.0 + 2.0) / 3.0 * (FIG5_SIZE - 1))  # c = (-1, 0) lies inside the set
    require(int(img[FIG5_SIZE // 2, col]) == FIG5_ITERS, "fig5: interior pixel escaped")
    require(all(np.array_equal(g, img) for g in got), "fig5: images differ between runs")
    return {"wall_s": wall, "images": FIG5_IMAGES, "image": img}


def serve_times(g: dict) -> dict:
    return {k: g[k] for k in ("prefill_s", "ttft_s", "decode_ms_per_step", "decode_tokens_per_s")}


def phase_serve(dev, arch: str, prompt_lens, kernel: str) -> dict:
    """Serve ``arch`` at full width and depth: the f32 kernel run (the main
    path, after a warm-up), each group alone, the plain run (``impl="ref"``)
    it is held against, and a bf16 run.  ``kernel`` is the kernel the
    prefill must launch once per layer and group."""
    # f32 products in full f32 (the card's default, stated and set): the
    # plain versions and the model's matmuls and convs then round as the
    # kernels do.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(arch)
    m = get_model(cfg)

    def init(dtype):  # the same seeded draws, rounded to dtype
        gen = torch.Generator(device=dev.torch_device).manual_seed(0)
        return m.init(cfg, generator=gen, device=dev.torch_device, dtype=dtype)

    params = init(torch.float32)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=(SERVE_BATCH, s), dtype=np.int32)
               for s in prompt_lens]
    streams = [dev.create_stream() for _ in prompts]  # reused: the allocator pools per stream

    def run(p, impl, new=SERVE_NEW):
        dev.synchronize()
        reset_launch_counts()
        out = serve_flow(dev, cfg, p, prompts, streams, new, impl)
        dev.synchronize()
        return out, launch_counts()[kernel]

    def kernels_launched(n_calls: int) -> int:
        # CUDA kernels the last run's calls launched: ssd_scan makes three a call
        return ssd_kernel.kernel_launches if kernel == "ssd_scan" else n_calls

    name = f"{arch} {kernel}"
    want_launches = cfg.num_layers * len(prompts)
    run(params, "auto", 2)  # warm-up: cuBLAS handles, the streams' memory pools
    f32, n_f32 = run(params, "auto")  # the main path
    n_f32_kernels = kernels_launched(n_f32)
    require(n_f32 == want_launches, f"{name}: launched {n_f32} times, not {want_launches}")
    require(all(g["on_stream"] for g in f32), f"{arch}: a group's CUDA work left its stream")
    # Each group once more on its own, to see what running both at once costs.
    alone = [serve_flow(dev, cfg, params, [p], [s], SERVE_NEW)[0]
             for p, s in zip(prompts, streams)]
    plain, n_plain = run(params, "ref")
    require(n_plain == 0, f"{name}: the plain run launched the kernel {n_plain} times")
    groups = []
    for S, g, w, a in zip(prompt_lens, f32, plain, alone):
        require(g["tokens"].shape == (SERVE_BATCH, SERVE_NEW + 1), f"{arch}: wrong token shape")
        require(g["logits_last"].shape == (SERVE_BATCH, cfg.vocab_size)
                and bool(np.isfinite(g["logits_last"]).all()), f"{arch}: bad prefill logits")
        require(bool(((g["tokens"] >= 0) & (g["tokens"] < cfg.vocab_size)).all()),
                f"{arch}: token out of the vocabulary")
        err = float(np.abs(g["logits_last"] - w["logits_last"]).max())
        require(err <= SERVE_LOGIT_TOL, f"{arch} S={S}: prefill logits differ from the plain "
                                        f"run's by {err} > {SERVE_LOGIT_TOL}")
        differ, cuts = greedy_cuts(g["tokens"], w["tokens"], w["gaps"])
        require(differ == 0, f"{arch} S={S}: {differ} request(s) decode other greedy tokens "
                             "than in the plain run")
        require(np.array_equal(a["tokens"], g["tokens"]), f"{arch} S={S}: alone, other tokens")
        groups.append({"prompt": S, "batch": SERVE_BATCH, "f32": serve_times(g),
                       "f32_group_alone": serve_times(a), "plain_f32": serve_times(w),
                       "max_abs_logit_err_vs_plain": err, "near_tie_cuts": cuts,
                       "min_gap_plain": float(w["gaps"].min())})

    del params
    params = init(torch.bfloat16)
    run(params, "auto", 2)
    bf16, n_bf16 = run(params, "auto")
    require(n_bf16 == want_launches, f"{name} bf16: launched {n_bf16} times")
    for row, g, w in zip(groups, bf16, f32):
        require(bool(np.isfinite(g["logits_last"]).all()), f"{arch} bf16: non-finite logits")
        row["bf16"] = serve_times(g)
        row["bf16_tokens_equal_f32"] = int((g["tokens"] == w["tokens"]).sum())
        row["tokens"] = int(w["tokens"].size)
    del params
    return {"arch": cfg.name, "params": cfg.param_count(), "layers": cfg.num_layers,
            "d_model": cfg.d_model, "new_tokens": SERVE_NEW, "groups": groups,
            "launches": {"kernel": kernel, "f32": n_f32, "f32_kernels": n_f32_kernels,
                         "plain": n_plain, "bf16": n_bf16},
            # the plain f32 run, one row per request, for the paged phases
            "_plain": {"tokens": np.concatenate([w["tokens"] for w in plain]),
                       "gaps": np.concatenate([w["gaps"] for w in plain])}}


def paged_serve_run(dev, cfg, params, prompts, impl: str, pool_pages: int, max_seq_len: int,
                    new_tokens: int, devices=None, scheduler=None, extras=None) -> dict:
    """One ``PagedServeEngine.from_config`` engine over ``devices`` (by
    default ``[dev]``), placed by ``scheduler``: a warm-up request, then
    every row of ``prompts`` submitted at once, ``new_tokens`` each (the
    prefill's token and ``new_tokens - 1`` decode steps), request ``i``
    with ``extras[i]`` where given (the warm-up with the first).  The launch
    counters are set to 0 just before the measured requests and read just
    after.  Returns the tokens (one row per request), the engine's metrics,
    the launches, the (rows, tokens) of each prefill batch the engine formed
    for them, and the wall time."""
    devices = [dev] if devices is None else devices
    B = prompts[0].shape[0]
    policy = LanePolicy(max_batch=B, max_delay_s=0.004,  # the serve phase's groups
                        token_budget=B * max(p.shape[1] for p in prompts))
    eng = PagedServeEngine.from_config(cfg, params=params, devices=devices,
                                       max_seq_len=max_seq_len, pool_pages=pool_pages, impl=impl,
                                       prefill=policy, scheduler=scheduler,
                                       name=f"smoke-{cfg.name}-{impl}")
    batches = []
    prefill_fn = eng.prefill_fn

    def prefill_logged(tokens, extras):
        batches.append(tuple(tokens.shape))
        return prefill_fn(tokens, extras)

    eng.prefill_fn = prefill_logged
    try:
        ex = [None] * sum(len(p) for p in prompts) if extras is None else extras
        eng.submit(prompts[0][0, :PAGED_WARMUP], 2, extras=ex[0]).get(timeout=600)  # cuBLAS, pools
        eng.drain()
        eng.reset_metrics()
        for d in devices:
            d.synchronize()
        reset_launch_counts()
        batches.clear()
        t0 = time.perf_counter()
        rows = [row for p in prompts for row in p]
        futs = [eng.submit(row, new_tokens, extras=e) for row, e in zip(rows, ex)]
        tokens = np.stack([f.get(timeout=900) for f in futs])
        eng.drain()
        for d in devices:
            d.synchronize()
        wall = time.perf_counter() - t0
        launches = {**launch_counts(), "paged_attention_kernels": paged_kernel.kernel_launches,
                    "flash_attention_noncausal": flash_kernel.noncausal_launches,
                    "ssd_scan_kernels": ssd_kernel.kernel_launches}
        metrics = eng.metrics()
    finally:
        eng.close()
    return {"tokens": tokens, "metrics": metrics, "launches": launches,
            "prefill_batches": list(batches), "wall_s": wall}


def paged_times(run: dict) -> dict:
    m = run["metrics"]
    d = m["decode"]
    return {"wall_s": run["wall_s"], "ttft_p50_s": m["ttft_p50_s"], "ttft_p99_s": m["ttft_p99_s"],
            "step_ms_p50": m["token_latency_p50_s"] * 1e3,
            "step_ms_p99": m["token_latency_p99_s"] * 1e3,
            "decode_tokens_per_s": m["decode_rows"] / max(m["decode_s"], 1e-9),
            "decode_steps": m["decode_steps"], "prefill_batches": m["prefill_batches"],
            "warm_counts": d["warm_counts"], "graphs_captured": d["graphs_captured"],
            "padded_rows": m["padded_rows"], "eager_steps": d["eager_steps"],
            "replayed_steps": d["replayed_steps"], "capture_s": d["capture_s"]}


def graph_steps_check(name: str, m: dict) -> None:
    """Every decode step of a measured run is a replay of a CUDA graph
    except the first at each warm count, which ran eagerly and was then
    captured."""
    d = m["decode"]
    require(d["eager_steps"] + d["replayed_steps"] == m["decode_steps"]
            and d["eager_steps"] == d["graphs_captured"] <= len(d["warm_counts"])
            and d["replayed_steps"] > 0,
            f"{name}: {d['eager_steps']} eager and {d['replayed_steps']} replayed steps, "
            f"{d['graphs_captured']} graphs captured, of {m['decode_steps']} decode steps at "
            f"warm counts {d['warm_counts']}")


def paged_device_launches(run: dict, kernel: str, counted: int) -> int:
    """Kernels of ``kernel`` that ran on the device in a paged run:
    ``counted`` (the wrapper's or the C entry's count, which a capture
    adds to without running anything), less the launches captured into
    graphs, plus those the graphs ran (recorded at capture x replays)."""
    d = run["metrics"]["decode"]
    return (counted - d["captured_launches"].get(kernel, 0)
            + d["replayed_launches"].get(kernel, 0))


def paged_params(dev, cfg):
    """The serve phase's seeded f32 weights and prompts."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev.torch_device).manual_seed(0)  # the serve phase's draws
    params = get_model(cfg).init(cfg, generator=gen, device=dev.torch_device, dtype=torch.float32)
    rng = np.random.default_rng(0)
    return params, rng


def paged_attention_layers(cfg) -> int:
    """Layers whose decode attends through paged_attention: every decoder
    layer of an attention family, none of an ssm, a hybrid's global layers
    (its SWA layers attend over the ring rebuilt from the pages, plain)."""
    if cfg.family == "ssm":
        return 0
    return len(cfg.global_attn_layers) if cfg.family == "hybrid" else cfg.num_layers


def prefill_kernel_layers(cfg, tokens: int) -> int:
    """Layers whose prefill of a ``tokens``-token batch launches the
    family's prefill kernel once (causal flash, or ssd_scan for an ssm): all
    decoder layers, but a hybrid whose sequence, meta tokens included,
    outgrows the window only its global layers (the SWA layers run the plain
    windowed blocks)."""
    if cfg.family == "hybrid" and tokens + cfg.meta_tokens > cfg.sliding_window:
        return len(cfg.global_attn_layers)
    return cfg.num_layers


def paged_phase_runs(dev, cfg, params, prompts, new_tokens: int, extras=None
                     ) -> "tuple[dict, dict]":
    """The kernel run (``impl="auto"``, the main path) and the plain run
    (``impl="ref"``: plain prefill attention or scan, the gather path in
    decode) of ``prompts`` through ``paged_serve_run``, every request
    resident at once (the pool holds them all), with their launch checks:
    paged_attention once a ``paged_attention_layers`` layer a decode step
    on the device, the prefill kernel once a ``prefill_kernel_layers``
    layer of each prefill batch the engine formed (causal), flash once an
    encoder layer a batch (non-causal, counted apart), a hybrid's ssd_scan
    once a layer a batch (3 CUDA kernels a call), none in the plain run.
    Returns (the phase's record, the two runs)."""
    arch = cfg.name
    spec = get_model(cfg).paged_spec(cfg)
    lens = [p.shape[1] for p in prompts]
    meta = cfg.meta_tokens  # a hybrid's meta tokens page in with the prompt
    # page 0, every request's pages at its longest, and the one page of
    # headroom admission asks for: no request waits for pages
    pool_pages = 2 + sum(p.shape[0] * spec.pages_for(meta + s + new_tokens - 1)
                         for p, s in zip(prompts, lens))
    max_seq_len = 1 << (meta + max(lens) + new_tokens - 1).bit_length()
    runs = {}
    for impl in ("auto", "ref"):
        runs[impl] = paged_serve_run(dev, cfg, params, prompts, impl, pool_pages, max_seq_len,
                                     new_tokens, extras=extras)
        gc.collect()  # the closed engine's pool (4.8 GB for Qwen1.5-MoE), before the next one's
        torch.cuda.empty_cache()
    got = runs["auto"]
    steps = got["metrics"]["decode_steps"]
    attends = cfg.family != "ssm"
    prefill_kernel = "flash_attention" if attends else "ssd_scan"
    enc_layers = cfg.encdec.encoder_layers if cfg.encdec else 0
    hybrid = cfg.family == "hybrid"
    counted = (("paged_attention", prefill_kernel)
               + (("flash_attention_noncausal",) if enc_layers else ())
               + (("ssd_scan", "ssd_scan_kernels") if hybrid else ()))
    launches = {impl: {k: r["launches"][k] for k in counted} for impl, r in runs.items()}
    for impl, r in runs.items():
        if dev.is_cuda:  # graphs are captured on a CUDA device only
            graph_steps_check(f"{arch} paged {impl}", r["metrics"])
    per_graph = paged_attention_layers(cfg)
    want_paged = per_graph * steps
    # Under replay a graph's kernels pass no wrapper: the kernels that ran
    # are the counted ones less those captured, plus those replayed (each
    # graph's recorded launches x its replays).  One CUDA kernel a call, as
    # the C entry counts its launches.
    d = got["metrics"]["decode"]
    require(d["captured_launches"].get("paged_attention", 0) == per_graph * d["graphs_captured"]
            and d["replayed_launches"].get("paged_attention", 0) == per_graph * d["replayed_steps"],
            f"{arch} paged: graphs recorded {d['captured_launches']} and replayed "
            f"{d['replayed_launches']} paged_attention launches, not {per_graph} a step")
    on_device = paged_device_launches(got, "paged_attention", launches["auto"]["paged_attention"])
    kernels = paged_device_launches(got, "paged_attention", got["launches"]["paged_attention_kernels"])
    launches["auto"].update(paged_attention_on_device=on_device, paged_attention_kernels=kernels,
                            paged_attention_captured=d["captured_launches"].get("paged_attention", 0),
                            paged_attention_replayed=d["replayed_launches"].get("paged_attention", 0))
    require(on_device == want_paged == kernels,
            f"{arch} paged: paged_attention launched {on_device} times and {kernels} CUDA kernels "
            f"on the device, not {want_paged} each ({per_graph} layers x {steps} decode steps)")
    # the decoder's layers (or the ssm's; a long hybrid prefill's global
    # layers) once a prefill batch, causal; an encoder's layers once a batch
    # too, non-causal, counted apart
    batches = got["metrics"]["prefill_batches"]
    shapes = got["prefill_batches"]
    require(len(shapes) == batches, f"{arch} paged: {len(shapes)} prefill calls seen, "
                                    f"{batches} batches counted")
    want_causal = sum(prefill_kernel_layers(cfg, T) for _, T in shapes)
    noncausal = got["launches"]["flash_attention_noncausal"]
    causal = launches["auto"][prefill_kernel] - (noncausal if attends else 0)
    require(causal == want_causal and noncausal == enc_layers * batches,
            f"{arch} paged: {prefill_kernel} launched {causal} times and the non-causal flash "
            f"{noncausal} times in the prefill batches {shapes}, not {want_causal} and "
            f"{enc_layers} a batch")
    if hybrid:  # every layer's SSM path scans, whatever the length
        scans = launches["auto"]["ssd_scan"]
        require(scans == cfg.num_layers * batches
                and launches["auto"]["ssd_scan_kernels"] == len(SSD_KERNELS) * scans,
                f"{arch} paged: ssd_scan called {scans} times launching "
                f"{launches['auto']['ssd_scan_kernels']} kernels in {batches} prefill batches, "
                f"not {cfg.num_layers} calls a batch, {len(SSD_KERNELS)} kernels a call")
    require(all(n == 0 for n in launches["ref"].values()),
            f"{arch} paged: the plain run launched a kernel: {launches['ref']}")
    n_req = sum(p.shape[0] for p in prompts)
    out = {"arch": cfg.name, "prompts": lens, "requests": n_req, "new_tokens": new_tokens,
           "pool_pages": pool_pages, "page_size": spec.page_size, "max_seq_len": max_seq_len,
           "prefill_batch_shapes": shapes, "launches": launches}
    for impl, r in runs.items():
        toks, mt = r["tokens"], r["metrics"]
        require(toks.shape == (n_req, new_tokens), f"{arch} paged {impl}: tokens {toks.shape}")
        require(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
                f"{arch} paged {impl}: token out of the vocabulary")
        require(mt["requests_completed"] == n_req and mt["requests_failed"] == 0,
                f"{arch} paged {impl}: {mt['requests_completed']} of {n_req} requests completed")
        require(mt["kv"][dev.key]["used_pages"] == 0, f"{arch} paged {impl}: pages not returned")
        out[impl] = paged_times(r)
    return out, runs


def phase_serve_paged(dev, arch: str, prompt_lens, plain: dict) -> dict:
    """Serve ``arch`` at full width and depth through ``PagedServeEngine``:
    the serve phase's prompts and seeded f32 weights, ``SERVE_NEW + 1``
    tokens each, all decoding in the same steps (``paged_phase_runs``).
    The kernel run (the main path) and the plain run are held against the
    serve phase's plain tokens ``plain`` and against each other, near-ties
    counted."""
    cfg = get_config(arch)
    params, rng = paged_params(dev, cfg)
    prompts = [rng.integers(0, cfg.vocab_size, size=(SERVE_BATCH, s), dtype=np.int32)
               for s in prompt_lens]
    out, runs = paged_phase_runs(dev, cfg, params, prompts, SERVE_NEW + 1)
    del params
    for impl, r in runs.items():
        differ, cuts = greedy_cuts(r["tokens"], plain["tokens"], plain["gaps"])
        require(differ == 0, f"{arch} paged {impl}: {differ} request(s) decode other greedy tokens "
                             "than the serve phase's plain run")
        out[impl]["near_tie_cuts_vs_serve_plain"] = cuts
    differ, cuts = greedy_cuts(runs["auto"]["tokens"], runs["ref"]["tokens"], plain["gaps"])
    require(differ == 0, f"{arch} paged: {differ} request(s) decode other tokens than the plain "
                         "paged run")
    out["near_tie_cuts_kernel_vs_plain"] = cuts
    return out


def phase_serve_paged_fleet(devs, plain: dict) -> dict:
    """The serve_paged phase's model and requests through one
    ``PagedServeEngine`` over ``devs`` (logical devices of the card),
    placed by ``Scheduler(devs, policy="least_loaded")``, with pools of
    ``PAGED_FLEET_POOL`` pages: the fleet holds about three quarters of the
    requests' pages, so the run spills sequences, defers their decode and
    refetches them.  Held against the serve phase's plain tokens; the
    paged_attention kernels that ran on the device are counted as in
    serve_paged (eager launches plus each graph's recorded launches x its
    replays, summed over the lanes)."""
    cfg = get_config(SERVE_ARCH)
    params, rng = paged_params(devs[0], cfg)
    prompts = [rng.integers(0, cfg.vocab_size, size=(SERVE_BATCH, s), dtype=np.int32)
               for s in SERVE_PROMPTS]
    spec = get_model(cfg).paged_spec(cfg)
    need = sum(SERVE_BATCH * spec.pages_for(s + SERVE_NEW) for s in SERVE_PROMPTS)
    longest = spec.pages_for(max(SERVE_PROMPTS) + SERVE_NEW)
    require(longest < PAGED_FLEET_POOL - 1 and (PAGED_FLEET_POOL - 1) * len(devs) < need,
            f"paged fleet: pools of {PAGED_FLEET_POOL} pages do not put {need} pages under pressure")
    max_seq_len = 1 << (max(SERVE_PROMPTS) + SERVE_NEW).bit_length()
    sched = Scheduler(devs, policy="least_loaded")
    run = paged_serve_run(devs[0], cfg, params, prompts, "auto", PAGED_FLEET_POOL, max_seq_len,
                          SERVE_NEW + 1, devices=devs, scheduler=sched)
    del params
    toks, m = run["tokens"], run["metrics"]
    n_req = SERVE_BATCH * len(SERVE_PROMPTS)
    require(toks.shape == (n_req, SERVE_NEW + 1), f"paged fleet: tokens {toks.shape}")
    require(m["requests_completed"] == n_req and m["requests_failed"] == 0,
            f"paged fleet: {m['requests_completed']} of {n_req} requests completed")
    require(all(p["used_pages"] == 0 for p in m["kv"].values()), "paged fleet: pages not returned")
    differ, cuts = greedy_cuts(toks, plain["tokens"], plain["gaps"])
    require(differ == 0, f"paged fleet: {differ} request(s) decode other greedy tokens than the "
                         "serve phase's plain run")
    require(m["spills"] >= 1 and m["refetches"] >= 1,
            f"paged fleet: {m['spills']} spills and {m['refetches']} refetches, not >= 1 each")
    lanes = m["decode_by_device"]
    if devs[0].is_cuda:
        for key, d in lanes.items():
            require(d["eager_steps"] == d["graphs_captured"] <= len(d["warm_counts"]),
                    f"paged fleet {key}: {d['eager_steps']} eager steps, {d['graphs_captured']} "
                    f"graphs captured at warm counts {d['warm_counts']}")
        d = m["decode"]
        require(d["eager_steps"] + d["replayed_steps"] == m["decode_steps"] and d["replayed_steps"],
                f"paged fleet: {d['eager_steps']} eager and {d['replayed_steps']} replayed of "
                f"{m['decode_steps']} decode steps")
    steps = m["decode_steps"]
    want = cfg.num_layers * steps
    on_device = paged_device_launches(run, "paged_attention", run["launches"]["paged_attention"])
    kernels = paged_device_launches(run, "paged_attention",
                                    run["launches"]["paged_attention_kernels"])
    require(on_device == want == kernels,
            f"paged fleet: paged_attention launched {on_device} times and {kernels} CUDA kernels "
            f"on the device, not {want} each ({cfg.num_layers} layers x {steps} decode steps)")
    n_flash = run["launches"]["flash_attention"]
    require(n_flash == cfg.num_layers * m["prefill_batches"],
            f"paged fleet: flash_attention launched {n_flash} times")
    spill_s, refetch_s = spill_timing(devs[0], spec, SPILL_PAGES + 2)
    per_device = {
        key: {"placed": m["placed"].get(key, 0), "spills": m["kv"][key]["spills"],
              "refetches": m["kv"][key]["refetches"], "stalls": lane["stalls"],
              "deferred_rows": lane["deferred_rows"], "migrations_out": lane["migrations_out"],
              "warm_counts": lane["warm_counts"], "graphs_captured": lane["graphs_captured"],
              "decode_steps": lane["eager_steps"] + lane["replayed_steps"]}
        for key, lane in lanes.items()}
    return {"arch": cfg.name, "devices": [d.key for d in devs], "pool_pages": PAGED_FLEET_POOL,
            "pages_needed": need, "requests": n_req, "new_tokens": SERVE_NEW + 1,
            "near_tie_cuts_vs_serve_plain": cuts, "migrations": m["migrations"],
            "spill_pages": SPILL_PAGES, "spill_s": spill_s, "refetch_s": refetch_s,
            "spills": m["spills"], "refetches": m["refetches"], "per_device": per_device,
            "launches": {"flash_attention": n_flash, "paged_attention": run["launches"][
                "paged_attention"], "paged_attention_on_device": on_device,
                "paged_attention_kernels": kernels},
            **paged_times(run)}


def spill_timing(dev, spec, pages: int, reps: int = 3) -> "tuple[list, list]":
    """Host seconds of ``SeqPages.spill`` (pages and state to pinned host
    memory, until the pages are free) and of ``ensure_resident`` plus the
    end of its copy, for one sequence of ``pages - 2`` pages of random KV
    in a pool of its own on ``dev``, ``reps`` times each."""
    kv = PagedKVCache(spec, devices=[dev], pool_pages=pages)
    seq = kv.new_seq(dev)
    T = (pages - 2) * spec.page_size
    shape = (spec.layers, T, spec.kv_heads, spec.head_dim)
    gen = torch.Generator(device=dev.torch_device).manual_seed(0)
    k = torch.randn(shape, generator=gen, device=dev.torch_device, dtype=spec.dtype)
    kv.append(seq, k, -k)
    want = kv.pool_of(dev).read_pages(seq.pages)[0].clone()
    spill_s, refetch_s = [], []
    for _ in range(reps):
        dev.synchronize()
        t0 = time.perf_counter()
        require(seq.spill().get(timeout=600) is True, "spill timing: nothing spilled")
        spill_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        seq.ensure_resident()
        seq._sync_ready()
        refetch_s.append(time.perf_counter() - t0)
    require(torch.equal(kv.pool_of(dev).read_pages(seq.pages)[0], want),
            "spill timing: pages differ after the refetches")
    kv.free_seq(seq)
    return spill_s, refetch_s


# ---------------------------------------------------------------------------
# engine and serve_engine: the continuous-batching RequestEngine
# ---------------------------------------------------------------------------


def engine_step(x: "torch.Tensor", map_fn=map_ops.partition_map) -> "torch.Tensor":
    """``examples/serving_engine.py``'s step on the hand-written kernel:
    ``ENGINE_ROUNDS`` rounds of ``v <- partition_map(v) * 0.5 + v * 0.5``
    (``map_fn=partition_map_ref``: the plain version)."""
    v = x
    for _ in range(ENGINE_ROUNDS):
        v = map_fn(v.reshape(-1)).reshape(v.shape) * 0.5 + v * 0.5
    return v


def percentiles(values) -> "tuple[float, float]":
    """(p50, p99) as ``RequestEngine.metrics`` takes them."""
    s = sorted(values)
    return s[int(0.50 * (len(s) - 1))], s[int(0.99 * (len(s) - 1))]


def phase_engine(dev) -> dict:
    """``ENGINE_REQUESTS`` single-row requests of (1, ``ENGINE_N``) f32, all
    at once: through ``Program.run`` one after another (the example's
    serial baseline), then through ``RequestEngine(engine_step, max_batch=8,
    max_delay_s=0.002)`` on the graph route, once to capture the bucket
    routes and once timed.  Every result bit-equal to the serial run's;
    every route a CUDA graph, replayed on the engine's own stream; every
    bucket in {1, 2, 4, 8}; the replays ran ``ENGINE_ROUNDS`` partition_map
    kernels each (the graphs' recorded launches x their replays).  Every
    result is also bit-equal to the step on the plain ``partition_map_ref``,
    run on the device request by request (the two agree bit for bit, as
    ``check_partition_map`` holds).  The launch counts are the engine's
    alone: the host's (its probe, warm-up and capture a route) and the
    replayed; the serial run's are reported apart.  A request's latency is
    from the burst's start to its result."""
    rng = np.random.default_rng(0)
    payloads = [rng.standard_normal((1, ENGINE_N), dtype=np.float32) * 10
                for _ in range(ENGINE_REQUESTS)]
    plain = [engine_step(torch.from_numpy(p).to(dev.torch_device), partition_map_ref).cpu().numpy()
             for p in payloads]
    reset_launch_counts()
    prog = dev.create_program({"step": engine_step}, "serve-demo").get()
    prog.run([payloads[0]], "step").get()  # warm the step
    serial, serial_lat = [], []
    t0 = time.perf_counter()
    for p in payloads:
        serial.append(prog.run([p], "step").get().cpu().numpy())
        serial_lat.append(time.perf_counter() - t0)
    t_serial = time.perf_counter() - t0
    n_serial = launch_counts()["partition_map"]

    reset_launch_counts()  # the main path: the engine's launches alone
    eng = RequestEngine(engine_step, max_batch=ENGINE_MAX_BATCH, max_delay_s=0.002,
                        scheduler=Scheduler([dev]), name="demo")
    try:
        warm = [f.get(timeout=600) for f in [eng.submit(p) for p in payloads]]
        eng.drain()
        before, n_lat = eng.metrics(), len(eng._latencies)
        t0 = time.perf_counter()
        futs = [eng.submit(p) for p in payloads]
        got = [f.get(timeout=600) for f in futs]
        t_engine = time.perf_counter() - t0
        eng.drain()
        after, lats = eng.metrics(), list(eng._latencies)[n_lat:]
    finally:
        eng.close()
    n_host = launch_counts()["partition_map"]
    routes = eng._graphs
    unbuilt = sorted(k[2] for k, e in routes.items() if e is None)
    require(bool(routes) and not unbuilt, f"engine: graph routes not built for buckets {unbuilt}")
    buckets = sorted(k[2] for k in routes)
    require(set(buckets) <= {1, 2, 4, 8}, f"engine: buckets {buckets}")
    s = eng._streams[dev.key]
    on_stream = s is not dev.default_stream and all(e.exe._last_replay_queue is s.lane
                                                    for e in routes.values())
    differ = sum(not (g.dtype == w.dtype and np.array_equal(g, w))
                 for g, w in zip(warm + got, serial + serial))
    require(differ == 0,
            f"engine: {differ} of {2 * len(serial)} results differ from the serial run")
    differ_plain = sum(not (g.dtype == w.dtype and np.array_equal(g, w))
                       for g, w in zip(warm + got, plain + plain))
    require(differ_plain == 0, f"engine: {differ_plain} of {2 * len(plain)} results differ "
                               "from the step on the plain partition_map")
    replayed = sum(e.exe.replayed_launches().get("partition_map", 0) for e in routes.values())
    batches = after["batches"]
    if dev.is_cuda:  # a CPU device replays its routes eagerly, on the plain version
        default = torch.cuda.default_stream(dev.torch_device).cuda_stream
        on_stream = on_stream and s.cuda_stream.cuda_stream != default
        require(all(e.exe.cuda_graphs == 1 and e.exe.graph_replays > 0
                    for e in routes.values()), "engine: a route is not one replayed CUDA graph")
        require(replayed >= ENGINE_ROUNDS * batches,
                f"engine: {replayed} replayed partition_map launches for {batches} batches")
    require(on_stream, "engine: the replays did not run on the engine's own stream")
    d = {k: after[k] - before[k] for k in ("batches", "rows", "padded_rows")}
    p50, p99 = percentiles(lats)
    sp50, sp99 = percentiles(serial_lat)
    return {"requests": ENGINE_REQUESTS, "n": ENGINE_N, "rounds": ENGINE_ROUNDS,
            "max_batch": ENGINE_MAX_BATCH, "buckets": buckets,
            "graph_replays": sum(e.exe.graph_replays for e in routes.values()),
            "results_bit_equal": 2 * len(serial) - differ,
            "results_bit_equal_plain": 2 * len(plain) - differ_plain,
            "on_engine_stream": on_stream,
            "serial": {"requests_per_s": ENGINE_REQUESTS / t_serial, "latency_p50_s": sp50,
                       "latency_p99_s": sp99, "batches": ENGINE_REQUESTS, "mean_batch_rows": 1.0,
                       "padding_waste": 0.0},
            "engine": {"requests_per_s": ENGINE_REQUESTS / t_engine, "latency_p50_s": p50,
                       "latency_p99_s": p99, "batches": d["batches"],
                       "mean_batch_rows": d["rows"] / d["batches"],
                       "padding_waste": d["padded_rows"] / d["rows"]},
            "batches_with_warmup": batches,
            "launches": {"host": n_host, "replayed": replayed, "serial": n_serial}}


def serve_engine_flow(prefill_engine, decode_engine, prompts, new_tokens: int) -> dict:
    """Every prompt through the prefill engine at once (its KV rows written
    into a request cache of prompt + ``new_tokens`` slots on the host), then
    ``new_tokens`` decode steps, each submitting every request's cache rows,
    token and ``pos`` to the decode engine.  Returns the tokens (B, 1 + new),
    the last-position logits (B, 1 + new, V), the first decode step's
    requests, TTFT and the step times."""
    S = prompts[0].shape[1]
    t0 = time.perf_counter()
    futs = [prefill_engine.submit({"tokens": p}, kind="prefill") for p in prompts]
    pre, ttft = [], []
    for f in futs:
        pre.append(f.get(timeout=600))
        ttft.append(time.perf_counter() - t0)
    rows, toks, logits = [], [], [[r["logits"]] for r in pre]
    for r in pre:
        cache = {}
        for name, kv in r["kv"].items():
            c = np.zeros(kv.shape[:2] + (S + new_tokens,) + kv.shape[3:], np.float32)
            c[:, :, :S] = kv
            cache[name] = c
        rows.append(cache)
        toks.append(np.argmax(r["logits"], axis=-1).astype(np.int32).reshape(1, 1))
    first = list(zip(rows, toks))
    tokens = [list(t[:, 0]) for t in toks]
    step_s = []
    for i in range(new_tokens):
        t1 = time.perf_counter()
        futs = [decode_engine.submit({"cache": c, "tokens": t, "pos": np.int32(S + i)},
                                     kind="decode") for c, t in zip(rows, toks)]
        outs = [f.get(timeout=600) for f in futs]
        step_s.append(time.perf_counter() - t1)
        rows, toks = [o["cache"] for o in outs], [o["next"] for o in outs]
        for j, o in enumerate(outs):
            logits[j].append(o["logits"][:, -1])
            tokens[j].append(int(o["next"][0, 0]))
    return {"tokens": np.array(tokens), "logits": np.stack([np.concatenate(lg) for lg in logits]),
            "first": first, "ttft_s": ttft, "step_s": step_s,
            "wall_s": time.perf_counter() - t0}


def phase_serve_engine(dev) -> dict:
    """OLMo-1B at full width and depth (the serve phase's seeded f32
    weights): ``SERVE_ENGINE_BATCH`` requests with prompts of
    ``SERVE_ENGINE_PROMPT`` tokens, prefilled through a ``RequestEngine``
    lane of a ``SERVE_ENGINE_BUDGET``-token budget (``make_prefill`` on the
    flash kernel, the KV handed back by ``cache_to_rows``), then
    ``SERVE_ENGINE_NEW`` decode steps through ``make_serve_engine``; the
    flow once to warm up (its times printed too), once measured.  Each
    request is held against itself served alone, eagerly, on the plain path
    (``serve_group`` with ``impl="ref"``: attention without the flash
    kernel): every step's last-position logits within ``SERVE_LOGIT_TOL``
    while the tokens agree, greedy tokens equal up to near-ties
    (``greedy_cuts``).  Then ``make_serve_fanout`` over
    ``SERVE_ENGINE_FANOUT`` logical devices for the first decode step: its
    tokens equal the engine's, near-ties excepted.  The decode step's
    device compute is an eager batched step on a resident cache."""
    cfg = get_config(SERVE_ARCH)
    params, _ = paged_params(dev, cfg)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=(1, SERVE_ENGINE_PROMPT), dtype=np.int32)
               for _ in range(SERVE_ENGINE_BATCH)]
    prefill = make_prefill(cfg, params)

    def prefill_step(batch):
        logits, kv = prefill(batch)
        return {"logits": logits[:, -1], "kv": cache_to_rows(kv)}

    sched = Scheduler([dev])
    peng = RequestEngine({"prefill": prefill_step},
                         lanes={"prefill": LanePolicy(token_budget=SERVE_ENGINE_BUDGET,
                                                      max_delay_s=SERVE_ENGINE_DELAY_S)},
                         graph=False, scheduler=sched, name="prefill")
    deng = make_serve_engine(cfg, params, max_batch=SERVE_ENGINE_BATCH,
                             max_delay_s=SERVE_ENGINE_DELAY_S, scheduler=sched)
    try:
        # Warm-up, the whole flow: the streams' pools and the pinned host
        # blocks every step's batch and results take.
        warm = serve_engine_flow(peng, deng, prompts, SERVE_ENGINE_NEW)
        pm0, dm0 = peng.metrics(), deng.metrics()
        dev.synchronize()
        reset_launch_counts()
        run = serve_engine_flow(peng, deng, prompts, SERVE_ENGINE_NEW)
        dev.synchronize()
        n_flash = launch_counts()["flash_attention"]
        pm, dm = peng.metrics(), deng.metrics()
    finally:
        peng.close()
        deng.close()
    prefill_batches = pm["batches"] - pm0["batches"]
    decode_batches = dm["batches"] - dm0["batches"]
    require(n_flash == cfg.num_layers * prefill_batches * dev.is_cuda,
            f"serve_engine: flash_attention launched {n_flash} times for {prefill_batches} "
            "prefill batches")
    require(pm["requests_failed"] == dm["requests_failed"] == 0, "serve_engine: failed requests")
    require(decode_batches == SERVE_ENGINE_NEW, f"serve_engine: {decode_batches} decode batches "
                                                f"for {SERVE_ENGINE_NEW} steps")

    stream = dev.create_stream()
    alone = [serve_flow(dev, cfg, params, [p], [stream], SERVE_ENGINE_NEW, impl="ref")[0]
             for p in prompts]
    dev.synchronize()
    require(launch_counts()["flash_attention"] == n_flash,
            "serve_engine: the plain reference launched the flash kernel")
    want_tokens = np.concatenate([a["tokens"] for a in alone])
    want_gaps = np.concatenate([a["gaps"] for a in alone])
    toks, lg = run["tokens"], run["logits"]
    want_lg_shape = (SERVE_ENGINE_BATCH, SERVE_ENGINE_NEW + 1, cfg.vocab_size)
    require(toks.shape == want_tokens.shape and lg.shape == want_lg_shape
            and bool(np.isfinite(lg).all()),
            f"serve_engine: tokens {toks.shape}, logits {lg.shape}")
    differ, cuts = greedy_cuts(toks, want_tokens, want_gaps)
    require(differ == 0, f"serve_engine: {differ} request(s) decode other greedy tokens than "
                         "served alone")
    err = 0.0
    for j, a in enumerate(alone):  # logits while the inputs agree
        want_lg = a["logits_steps"][0].float().cpu().numpy()
        same = int(np.argmin(np.append(toks[j] == want_tokens[j], False)))
        err = max(err, float(np.abs(lg[j, :same + 1] - want_lg[:same + 1]).max()))
    require(err <= SERVE_LOGIT_TOL, f"serve_engine: logits differ from the requests served "
                                    f"alone on the plain path by {err} > {SERVE_LOGIT_TOL}")
    del alone

    # The fan-out: each request's first decode step with its own params,
    # placed round-robin over logical devices of the card.
    devs = logical_devices(SERVE_ENGINE_FANOUT, dev.platform)
    fsched = Scheduler(devs, policy="round_robin")
    S = SERVE_ENGINE_PROMPT
    futs = make_serve_fanout(cfg)([(params, rows_to_cache(c), t, np.int32(S))
                                   for c, t in run["first"]], scheduler=fsched)
    fan = np.array([int(f.get(timeout=600)[0][0, 0]) for f in futs])
    fan_differ = int(sum(a != b and gap >= NEAR_TIE
                         for a, b, gap in zip(fan, toks[:, 1], want_gaps[:, 1])))
    require(fan_differ == 0, f"serve_engine: the fan-out decodes {fan_differ} other first tokens")
    require(len(fsched.stats()) == SERVE_ENGINE_FANOUT, f"serve_engine: fan-out placed "
                                                        f"{fsched.stats()}")

    # The batched decode step's device work alone: the engine's step on a
    # cache already resident on the card.
    step = make_serve_step(cfg, params)
    cache = get_model(cfg).init_cache(cfg, SERVE_ENGINE_BATCH, S + SERVE_ENGINE_NEW,
                                      dtype=torch.float32, device=dev.torch_device)
    tok = torch.zeros((SERVE_ENGINE_BATCH, 1), dtype=torch.int32, device=dev.torch_device)
    if dev.is_cuda:
        compute_ms = cuda_ms(lambda: step(cache, tok, S), 5)
    else:
        t0 = time.perf_counter()
        step(cache, tok, S)
        compute_ms = (time.perf_counter() - t0) * 1e3
    del cache, params
    steps_ms = [t * 1e3 for t in run["step_s"]]
    step_p50 = percentiles(steps_ms)[0]
    return {"arch": cfg.name, "requests": SERVE_ENGINE_BATCH, "prompt": SERVE_ENGINE_PROMPT,
            "new_tokens": SERVE_ENGINE_NEW, "token_budget": SERVE_ENGINE_BUDGET,
            "ttft_s": run["ttft_s"], "decode_ms_per_step": steps_ms,
            "warmup_ttft_s": warm["ttft_s"],
            "warmup_decode_ms_per_step": [t * 1e3 for t in warm["step_s"]],
            "decode_ms_p50": step_p50, "decode_compute_ms": compute_ms,
            "host_share_of_step": 1.0 - compute_ms / step_p50,
            "cache_bytes_per_request": int(sum(v.nbytes for v in run["first"][0][0].values())),
            "requests_per_s": SERVE_ENGINE_BATCH / run["wall_s"], "wall_s": run["wall_s"],
            "prefill": {"batches": prefill_batches,
                        "mean_batch_rows": (pm["rows"] - pm0["rows"]) / prefill_batches},
            "decode": {"batches": decode_batches,
                       "mean_batch_rows": (dm["rows"] - dm0["rows"]) / decode_batches,
                       "padding_waste": dm["padding_waste"]},
            "max_abs_logit_err_vs_alone_plain": err, "near_tie_cuts": cuts,
            "fanout": {"devices": [d.key for d in devs], "placed": fsched.stats(),
                       "tokens_equal": int((fan == toks[:, 1]).sum())},
            "launches": {"flash_attention": n_flash}}


# ---------------------------------------------------------------------------
# the moe and encdec families: Qwen1.5-MoE-A2.7B and whisper-tiny
# ---------------------------------------------------------------------------


def router_probs(x2d: "torch.Tensor", wr: "torch.Tensor") -> "torch.Tensor":
    """The f32 router probabilities ``moe.route`` computes."""
    return torch.softmax(torch.matmul(x2d.float(), wr.float()), dim=-1)


def route_with(x2d, wr, idx, renormalize: bool):
    """``moe.route`` with the top-k indices ``idx`` given: the weights are
    the router probabilities at ``idx``, renormalized, and the aux loss
    counts ``idx``."""
    probs = router_probs(x2d, wr)
    weights = probs.gather(1, idx)
    if renormalize:
        weights = weights / (torch.sum(weights, dim=-1, keepdim=True) + 1e-9)
    E = wr.shape[-1]
    ce = torch.mean((idx[:, :1] == torch.arange(E, device=idx.device)).float(), dim=0)
    return weights, idx, E * torch.sum(torch.mean(probs, dim=0) * ce)


class RouteLog:
    """Wraps ``repro_torch.models.moe.route`` while it is entered (this
    script's wrapper: the package has no routing hook).  ``record`` keeps
    each call's top-k indices and router margins (the gap between the k-th
    and the (k+1)-th probability) under the calling task's key, in call
    order; ``replay`` gives each call the indices the same call of a
    recorded run chose (``route_with``); with no mode it calls ``route``.
    A task is keyed by running it through ``keyed``."""

    def __init__(self):
        self.route = moe_model.route
        self.local = threading.local()
        self.lock = threading.Lock()
        self.start()

    def __enter__(self) -> "RouteLog":
        moe_model.route = self
        return self

    def __exit__(self, *exc) -> None:
        moe_model.route = self.route

    def start(self, mode: "str | None" = None, replay: "dict | None" = None) -> None:
        self.mode, self.calls, self.replay, self.n = mode, {}, replay or {}, {}

    def keyed(self, fn):
        def task(*args, key, **kwargs):
            self.local.key = key
            try:
                return fn(*args, **kwargs)
            finally:
                self.local.key = None
        return task

    def __call__(self, x2d, wr, top_k: int, renormalize: bool):
        if self.mode is None:
            return self.route(x2d, wr, top_k, renormalize)
        key = getattr(self.local, "key", None)
        with self.lock:
            i = self.n[key] = self.n.get(key, -1) + 1
        if self.mode == "replay":
            return route_with(x2d, wr, self.replay[key][i][0], renormalize)
        out = self.route(x2d, wr, top_k, renormalize)
        top = torch.topk(router_probs(x2d, wr), top_k + 1, dim=-1).values
        with self.lock:
            self.calls.setdefault(key, []).append((out[1], top[:, top_k - 1] - top[:, top_k]))
        return out


def route_flips(a: dict, b: dict, layers: int) -> "list[dict]":
    """The routing decisions of log ``b`` whose set of experts differs from
    the same call and token of log ``a``, in call order, each with ``b``'s
    router margin: its key, call, step (0: the prefill; the call's layer
    is the call modulo ``layers``) and token."""
    flips = []
    for key in sorted(b, key=str):
        for c, ((ia, _), (ib, mb)) in enumerate(zip(a.get(key, ()), b[key])):
            if ia.shape != ib.shape:
                break
            diff = (torch.sort(ia, -1).values != torch.sort(ib, -1).values).any(-1)
            rows = torch.nonzero(diff).flatten()
            for t, m in zip(rows.tolist(), mb[rows].tolist()):
                flips.append({"key": key, "call": c, "step": c // layers, "layer": c % layers,
                              "token": t, "margin": m})
    return flips


def first_flips(flips: "list[dict]") -> "dict":
    """For each key, the flips of its first call that has any: the calls
    whose inputs differ by rounding alone."""
    first: dict = {}
    for f in flips:  # in call order within a key
        first.setdefault(f["key"], f["call"])
    return {k: [f for f in flips if f["key"] == k and f["call"] == c] for k, c in first.items()}


def flips_summary(flips: "list[dict]") -> dict:
    firsts = first_flips(flips)
    margins = [f["margin"] for f in flips]
    return {"differing_decisions": len(flips), "flips": flips,
            "margin_min": min(margins, default=None), "margin_max": max(margins, default=None),
            "first_call_flips": {str(k): v for k, v in firsts.items()},
            "first_call_margin_max": max((f["margin"] for v in firsts.values() for f in v),
                                         default=None)}


def phase_serve_moe(dev) -> dict:
    """Qwen1.5-MoE-A2.7B at full width and depth through the serve phase's
    flow (``serve_flow``: the prompts of ``SERVE_PROMPTS`` in two groups of
    ``SERVE_BATCH``, ``SERVE_NEW`` greedy steps, f32 with TF32 off): the
    kernel run (the main path: flash in the prefill), each routing decision
    recorded; the plain run with the kernel run's routing replayed, held to
    it (last-position logits of the prefill and of each step while the
    tokens agree within ``SERVE_LOGIT_TOL``; greedy tokens equal up to
    near-ties of the plain run); the plain run unpinned, its routing
    decisions that differ from the kernel run's counted with their margins
    (those of each group's first differing call must be router near-ties,
    and a request whose tokens differ, logit near-ties apart, must have
    one); then bf16, timed, after the f32 params are freed."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(MOE_ARCH)
    m, L = get_model(cfg), cfg.num_layers

    def init(dtype):  # the same seeded draws, rounded to dtype
        gen = torch.Generator(device=dev.torch_device).manual_seed(0)
        return m.init(cfg, generator=gen, device=dev.torch_device, dtype=dtype)

    params = init(torch.float32)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=(SERVE_BATCH, s), dtype=np.int32)
               for s in SERVE_PROMPTS]
    streams = [dev.create_stream() for _ in prompts]  # reused: the allocator pools per stream
    log = RouteLog()

    def run(p, impl, new=SERVE_NEW, mode=None, replay=None):
        dev.synchronize()
        log.start(mode, replay)
        reset_launch_counts()
        out = serve_flow(dev, cfg, p, prompts, streams, new, impl, routes=log)
        dev.synchronize()
        torch.cuda.empty_cache()  # each stream's cached blocks: the next run starts unfragmented
        calls = log.calls
        log.start()
        return out, launch_counts()["flash_attention"], calls

    want_launches = L * len(prompts)
    with log:
        run(params, "auto", 2)  # warm-up: cuBLAS handles, the streams' memory pools
        f32, n_f32, routes = run(params, "auto", mode="record")  # the main path
        require(n_f32 == want_launches, f"{MOE_ARCH}: flash launched {n_f32} times, "
                                        f"not {want_launches}")
        require(all(g["on_stream"] for g in f32), f"{MOE_ARCH}: a group's CUDA work left its stream")
        n_calls = {k: len(v) for k, v in routes.items()}
        require(n_calls == {g: L * (SERVE_NEW + 1) for g in range(len(prompts))},
                f"{MOE_ARCH}: route calls by group {n_calls}, not {L} a pass")
        pinned, n_pinned, _ = run(params, "ref", mode="replay", replay=routes)
        free, n_free, free_routes = run(params, "ref", mode="record")
    require(n_pinned == n_free == 0, f"{MOE_ARCH}: the plain runs launched flash "
                                     f"{n_pinned} and {n_free} times")
    decisions = int(sum(ix.shape[0] for calls in routes.values() for ix, _ in calls))
    flips = route_flips(routes, free_routes, L)
    summary = flips_summary(flips)
    firsts = first_flips(flips)
    require(all(f["margin"] < ROUTER_NEAR_TIE for v in firsts.values() for f in v),
            f"{MOE_ARCH}: a routing decision of the plain run differs from the kernel run's at "
            f"a margin of {summary['first_call_margin_max']} >= {ROUTER_NEAR_TIE} in its first "
            "differing call")
    groups = []
    for gi, (S, g, w, u) in enumerate(zip(SERVE_PROMPTS, f32, pinned, free)):
        require(g["tokens"].shape == (SERVE_BATCH, SERVE_NEW + 1), f"{MOE_ARCH}: token shape")
        require(g["logits_last"].shape == (SERVE_BATCH, cfg.vocab_size)
                and bool(np.isfinite(g["logits_last"]).all()), f"{MOE_ARCH}: bad prefill logits")
        require(bool(((g["tokens"] >= 0) & (g["tokens"] < cfg.vocab_size)).all()),
                f"{MOE_ARCH}: token out of the vocabulary")
        err = 0.0
        for j in range(SERVE_BATCH):  # every step's logits while the tokens agree
            same = int(np.argmin(np.append(g["tokens"][j] == w["tokens"][j], False)))
            err = max(err, float((g["logits_steps"][j, :same + 1]
                                  - w["logits_steps"][j, :same + 1]).abs().max()))
        require(err <= SERVE_LOGIT_TOL, f"{MOE_ARCH} S={S}: with the routing pinned the logits "
                                        f"differ from the plain run's by {err} > "
                                        f"{SERVE_LOGIT_TOL}")
        differ, cuts = greedy_cuts(g["tokens"], w["tokens"], w["gaps"])
        require(differ == 0, f"{MOE_ARCH} S={S}: with the routing pinned, {differ} request(s) "
                             "decode other greedy tokens than in the plain run")
        # Unpinned: a request whose tokens differ (logit near-ties cut) needs
        # a routing flip in its group at a router near-tie.
        free_differ, free_cuts = greedy_cuts(g["tokens"], u["tokens"], u["gaps"])
        group_first = firsts.get(gi, [])
        require(free_differ == 0 or bool(group_first),
                f"{MOE_ARCH} S={S}: unpinned, {free_differ} request(s) decode other tokens with "
                "no routing decision of the group differing")
        groups.append({"prompt": S, "batch": SERVE_BATCH, "f32": serve_times(g),
                       "plain_f32_pinned": serve_times(w), "plain_f32_unpinned": serve_times(u),
                       "max_abs_logit_err_pinned": err, "near_tie_cuts_pinned": cuts,
                       "min_gap_plain": float(w["gaps"].min()),
                       "unpinned_requests_differing": free_differ,
                       "unpinned_near_tie_cuts": free_cuts,
                       "unpinned_max_abs_logit_err": float(np.abs(g["logits_last"]
                                                                  - u["logits_last"]).max()),
                       "unpinned_differing_decisions": sum(f["key"] == gi for f in flips),
                       "unpinned_first_flips": group_first})
    f32_tokens = [g["tokens"] for g in f32]
    del f32, pinned, free, routes, free_routes, params
    torch.cuda.empty_cache()
    f32_peak = {k: getattr(torch.cuda, f"max_memory_{k}")() if dev.is_cuda else 0
                for k in ("allocated", "reserved")}

    params = init(torch.bfloat16)
    run(params, "auto", 2)
    bf16, n_bf16, _ = run(params, "auto")
    require(n_bf16 == want_launches, f"{MOE_ARCH} bf16: flash launched {n_bf16} times")
    for row, g, w in zip(groups, bf16, f32_tokens):
        require(bool(np.isfinite(g["logits_last"]).all()), f"{MOE_ARCH} bf16: non-finite logits")
        row["bf16"] = serve_times(g)
        row["bf16_tokens_equal_f32"] = int((g["tokens"] == w).sum())
        row["tokens"] = int(w.size)
    del params, bf16
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "params": cfg.param_count(), "layers": L, "d_model": cfg.d_model,
            "experts": cfg.moe.num_experts, "top_k": cfg.moe.top_k,
            "new_tokens": SERVE_NEW, "groups": groups,
            "routing": {"decisions": decisions, "router_near_tie": ROUTER_NEAR_TIE, **summary},
            "launches": {"kernel": "flash_attention", "f32": n_f32, "plain_pinned": n_pinned,
                         "plain_unpinned": n_free, "bf16": n_bf16},
            "max_memory_f32": f32_peak}


def padded_alone(dev, cfg, params, prompt: np.ndarray, new_tokens: int, impl: str,
                 extras: "dict | None" = None, max_seq: "int | None" = None) -> dict:
    """One request alone, eagerly: its ``paged_prefill`` (``impl``) seeds an
    ``init_cache`` of ``max_seq`` slots (by default prompt + ``new_tokens``;
    self K/V rows, an encdec's cross K/V, a hybrid's rings, full caches and
    SSM state through ``hybrid.seed_cache``), then ``decode_step`` (plain
    attention), as the reference's padded oracle
    (tests/test_paged_models.py).  One row is one MoE dispatch group, as
    the paged engine's per-row groups.  Returns the greedy tokens (1 +
    ``new_tokens`` - 1) and each pick's top-2 gap."""
    m, td = get_model(cfg), dev.torch_device
    S = prompt.size
    ex = None if extras is None else {k: torch.from_numpy(np.asarray(v)[None]).to(td)
                                      for k, v in extras.items()}
    k, v, state, logits = m.paged_prefill(cfg, params, torch.from_numpy(prompt[None]).to(td), ex,
                                          impl=impl)
    cache = m.init_cache(cfg, 1, max_seq or S + new_tokens, device=td, dtype=k.dtype)
    if cfg.family == "hybrid":
        m.seed_cache(cfg, cache, k, v, state)
    elif cfg.family == "encdec":
        cache["self_k"][:, 0, :S], cache["self_v"][:, 0, :S] = k[0], v[0]
        cache["cross_k"][:, 0], cache["cross_v"][:, 0] = state["cross_k"][0], state["cross_v"][0]
    else:
        cache["k"][:, 0, :S], cache["v"][:, 0, :S] = k[0], v[0]
    lasts = [logits]
    tok = torch.argmax(logits, dim=-1).view(1, 1)
    toks = [tok]
    for i in range(new_tokens - 1):
        lg, cache = m.decode_step(cfg, params, cache, tok, S + i)
        tok = torch.argmax(lg[:, -1], dim=-1).view(1, 1)
        toks.append(tok)
        lasts.append(lg[:, -1])
    return {"tokens": torch.cat(toks, dim=1)[0].cpu().numpy(),
            "gaps": torch.cat([top2_gap(x) for x in lasts]).cpu().numpy()}


def phase_serve_paged_moe(dev) -> dict:
    """Qwen1.5-MoE-A2.7B at full width and depth through
    ``PagedServeEngine.from_config``: the serve phase's requests and seeded
    f32 weights (``paged_phase_runs``: every request resident, decode on
    CUDA graphs, MoE dispatched per row).  The kernel run's tokens are held
    to the plain paged run's.  A request whose tokens differ is run again
    alone, eagerly, both ways (``padded_alone``), routes recorded: the
    difference must be a near-tie of the plain logits at the first
    differing token, or come with a routing flip whose first differing
    call's margins are router near-ties; the flips are printed."""
    cfg = get_config(MOE_ARCH)
    params, rng = paged_params(dev, cfg)
    prompts = [rng.integers(0, cfg.vocab_size, size=(SERVE_BATCH, s), dtype=np.int32)
               for s in SERVE_PROMPTS]
    out, runs = paged_phase_runs(dev, cfg, params, prompts, SERVE_NEW + 1)
    rows = [r for p in prompts for r in p]
    got, ref = runs["auto"]["tokens"], runs["ref"]["tokens"]
    explained = []
    with RouteLog() as log:
        for i in np.flatnonzero((got != ref).any(axis=1)):
            t = int(np.argmax(got[i] != ref[i]))
            alone, logs = {}, {}
            for impl in ("auto", "ref"):
                log.start("record")
                alone[impl] = padded_alone(dev, cfg, params, rows[i], SERVE_NEW + 1, impl)
                logs[impl] = log.calls
            log.start()
            flips = route_flips(logs["auto"], logs["ref"], cfg.num_layers)
            firsts = first_flips(flips).get(None, [])
            logit_tie = float(alone["ref"]["gaps"][t]) < NEAR_TIE
            router_tie = bool(firsts) and all(f["margin"] < ROUTER_NEAR_TIE for f in firsts)
            case = {"request": int(i), "prompt": int(rows[i].size), "first_differing_token": t,
                    "plain_gap_there": float(alone["ref"]["gaps"][t]),
                    "alone_tokens_differ": bool((alone["auto"]["tokens"]
                                                 != alone["ref"]["tokens"]).any()),
                    "flips": len(flips), "first_call_flips": firsts,
                    "logit_near_tie": logit_tie, "router_near_tie": router_tie}
            print(f"serve_paged_moe: request {i} (S={rows[i].size}) differs from token {t}: "
                  f"plain gap {case['plain_gap_there']:.3g}, {len(flips)} routing decisions "
                  f"differ alone, the first call's: {firsts}", flush=True)
            require(logit_tie or router_tie, f"{MOE_ARCH} paged: request {i} decodes other tokens "
                                             "than the plain paged run, with neither a logit nor "
                                             "a router near-tie")
            explained.append(case)
    del params
    out["requests_differing_kernel_vs_plain"] = len(explained)
    out["explained"] = explained
    return out


def phase_serve_paged_encdec(dev) -> dict:
    """whisper-tiny at full size through ``PagedServeEngine.from_config``
    (seeded f32 weights): ``SERVE_BATCH`` requests of each prompt length of
    ``ENCDEC_PROMPTS``, each with its own (1500, 384) f32 frames as
    ``extras``, ``ENCDEC_NEW`` tokens each (``paged_phase_runs``: flash on
    the encoder, non-causal, and on the decoder's prefill, causal;
    paged_attention in decode).  Both runs are held to the reference's
    padded oracle (``padded_alone`` on the plain path, each request alone)
    and to each other, near-ties of the oracle's logits counted."""
    cfg = get_config(ENCDEC_ARCH)
    params, rng = paged_params(dev, cfg)
    prompts = [rng.integers(0, cfg.vocab_size, size=(SERVE_BATCH, s), dtype=np.int32)
               for s in ENCDEC_PROMPTS]
    n_req = SERVE_BATCH * len(prompts)
    frames = rng.normal(0, 0.02, (n_req, cfg.encdec.encoder_seq, cfg.d_model)).astype(np.float32)
    extras = [{"frames": f} for f in frames]
    out, runs = paged_phase_runs(dev, cfg, params, prompts, ENCDEC_NEW, extras=extras)
    rows = [r for p in prompts for r in p]
    oracle = [padded_alone(dev, cfg, params, r, ENCDEC_NEW, "ref", e) for r, e in zip(rows, extras)]
    del params
    want = np.stack([o["tokens"] for o in oracle])
    gaps = np.stack([o["gaps"] for o in oracle])
    for impl, r in runs.items():
        differ, cuts = greedy_cuts(r["tokens"], want, gaps)
        require(differ == 0, f"{ENCDEC_ARCH} paged {impl}: {differ} request(s) decode other greedy "
                             "tokens than the padded oracle")
        out[impl]["near_tie_cuts_vs_oracle"] = cuts
    differ, cuts = greedy_cuts(runs["auto"]["tokens"], runs["ref"]["tokens"], gaps)
    require(differ == 0, f"{ENCDEC_ARCH} paged: {differ} request(s) decode other tokens than the "
                         "plain paged run")
    out["near_tie_cuts_kernel_vs_plain"] = cuts
    out["min_gap_oracle"] = float(gaps.min())
    out["encoder_seq"] = cfg.encdec.encoder_seq
    out["state_bytes_per_request"] = 2 * cfg.num_layers * cfg.encdec.encoder_seq * cfg.d_model * 4
    return out


def phase_serve_paged_hybrid(dev) -> dict:
    """Hymba-1.5B at full width and depth through
    ``PagedServeEngine.from_config`` (seeded f32 weights, pages of 16,
    decode on CUDA graphs): ``SERVE_BATCH`` requests of each prompt length
    of ``HYBRID_PROMPTS``, ``HYBRID_NEW`` tokens each (``paged_phase_runs``:
    flash on all 32 layers of a prefill batch that fits the window with its
    meta tokens and on the 3 global layers of a longer one, ssd_scan on
    every layer of every batch, paged_attention on the 3 global layers of
    every decode step).  Both runs are held to the padded oracle
    (``padded_alone`` on the plain path over a cache as wide as the
    engine's table, so the rings match) and to each other, near-ties of the
    oracle's logits counted."""
    cfg = get_config(HYBRID_ARCH)
    params, rng = paged_params(dev, cfg)
    prompts = [rng.integers(0, cfg.vocab_size, size=(SERVE_BATCH, s), dtype=np.int32)
               for s in HYBRID_PROMPTS]
    out, runs = paged_phase_runs(dev, cfg, params, prompts, HYBRID_NEW)
    rows = [r for p in prompts for r in p]
    oracle = [padded_alone(dev, cfg, params, r, HYBRID_NEW, "ref", max_seq=out["max_seq_len"])
              for r in rows]
    del params
    want = np.stack([o["tokens"] for o in oracle])
    gaps = np.stack([o["gaps"] for o in oracle])
    for impl, r in runs.items():
        differ, cuts = greedy_cuts(r["tokens"], want, gaps)
        require(differ == 0, f"{HYBRID_ARCH} paged {impl}: {differ} request(s) decode other "
                             "greedy tokens than the padded oracle")
        out[impl]["near_tie_cuts_vs_oracle"] = cuts
    differ, cuts = greedy_cuts(runs["auto"]["tokens"], runs["ref"]["tokens"], gaps)
    require(differ == 0, f"{HYBRID_ARCH} paged: {differ} request(s) decode other tokens than the "
                         "plain paged run")
    out["near_tie_cuts_kernel_vs_plain"] = cuts
    out["min_gap_oracle"] = float(gaps.min())
    spec = get_model(cfg).paged_spec(cfg)
    s = cfg.ssm
    di, H = s.d_inner(cfg.d_model), s.n_heads(cfg.d_model)
    conv = di + 2 * s.n_groups * s.d_state
    pages = {S: spec.pages_for(cfg.meta_tokens + S + HYBRID_NEW - 1) for S in HYBRID_PROMPTS}
    out.update(
        meta_tokens=cfg.meta_tokens, window=cfg.sliding_window, kv_layers=spec.layers,
        page_bytes=spec.page_bytes,
        kv_bytes_per_request={S: spec.page_bytes * n for S, n in pages.items()},
        state_bytes_per_request=4 * cfg.num_layers * (H * s.d_state * s.head_dim
                                                      + (s.d_conv - 1) * conv))
    return out


# ---------------------------------------------------------------------------
# fleet: partition_map through run_on_any over logical devices (fig6)
# ---------------------------------------------------------------------------


def logical_devices(n: int, platform: str = "cuda") -> list:
    """``n`` logical devices of the first card (``REPRO_LOGICAL_DEVICES``,
    set around this one discovery: the other phases keep one device a
    card)."""
    old = os.environ.get("REPRO_LOGICAL_DEVICES")
    os.environ["REPRO_LOGICAL_DEVICES"] = str(n)
    try:
        devs = get_all_devices(1, 0, platform=platform).get()
    finally:
        if old is None:
            os.environ.pop("REPRO_LOGICAL_DEVICES")
        else:
            os.environ["REPRO_LOGICAL_DEVICES"] = old
    return devs[:n]


def fleet_run(prog, args, sched, want) -> dict:
    """Every chunk of ``args`` through ``prog.run_on_any`` placed by
    ``sched``, all submitted at once; each output held bit-equal to
    ``want``.  Returns the wall time, the chunks placed on each device, the
    steals, and the buffers spilled and refetched on the fleet."""
    devs = sched.devices()
    for d in devs:
        d.spills = d.refetches = 0
    t0 = time.perf_counter()
    futs = [prog.run_on_any([a], "partition_map", block=MAP_BLOCK, scheduler=sched) for a in args]
    got = [f.get(timeout=600) for f in futs]
    for d in devs:
        d.synchronize()
    wall = time.perf_counter() - t0
    differ = sum(not torch.equal(g, w) for g, w in zip(got, want))
    require(differ == 0, f"fleet {sched.policy.name}: {differ} of {len(want)} chunks differ from "
                         "one device's partition_map")
    return {"wall_s": wall, "placed": sched.stats(), "steals": sched.steal_stats()["steals"],
            "spills": sum(d.spills for d in devs), "refetches": sum(d.refetches for d in devs)}


def phase_fleet(devs, x: "torch.Tensor") -> dict:
    """fig6 on one card: ``x`` (on ``devs[0]``'s card) in ``FLEET_CHUNKS``
    chunks, each through ``Program.run_on_any`` over the logical devices
    ``devs``.  First raw chunks (every logical device reads them in place)
    with the default scheduler (``least_loaded``, stealing on), and on one
    device; then the chunks as buffers spread round-robin over the fleet,
    once per policy with stealing off; then again under ``least_loaded``
    with each device's ``memory_limit`` at ``FLEET_LIMIT_CHUNKS`` chunks,
    so placement vetoes the full devices and spills LRU buffers to the
    host, and later launches refetch them.  Every output is held bit-equal
    to one device's ``partition_map`` of the same chunk, computed first."""
    chunks = list(x.chunk(FLEET_CHUNKS))
    if x.is_cuda:
        torch.cuda.synchronize()  # x's copy has ended before other streams read it
    want = [map_ops.partition_map(c, block=MAP_BLOCK.as_tuple()) for c in chunks]
    prog = devs[0].create_program_with_file(str(KERNEL_DIR / "partition_map" / "ops.py")).get()
    for d in devs:  # build each sibling before timing
        prog.for_device(d).build("partition_map", block=MAP_BLOCK).get()
    reset_launch_counts()
    runs = {"default": fleet_run(prog, chunks, Scheduler(devs), want),
            "one_device": fleet_run(prog, chunks, Scheduler(devs[:1], steal=False), want)}
    bufs = [devs[i % len(devs)].create_buffer_from(c).get() for i, c in enumerate(chunks)]
    for policy in FLEET_POLICIES:
        runs[policy] = fleet_run(prog, bufs, Scheduler(devs, policy=policy, steal=False), want)
    limit = FLEET_LIMIT_CHUNKS * bufs[0].nbytes
    for d in devs:
        d.memory_limit = limit
    try:
        runs["memory_limit"] = fleet_run(prog, bufs, Scheduler(devs, steal=False), want)
    finally:
        for d in devs:
            d.memory_limit = 0
    wait_all([b.free() for b in bufs])
    launched = launch_counts()["partition_map"]
    require(launched == FLEET_CHUNKS * len(runs),
            f"fleet: partition_map launched {launched} times, not {FLEET_CHUNKS} x {len(runs)} runs")
    mem = runs["memory_limit"]
    require(mem["spills"] >= 1 and mem["refetches"] >= 1,
            f"fleet: the memory-limit run spilled {mem['spills']} and refetched "
            f"{mem['refetches']} buffers, not >= 1 each")
    require(len(runs["round_robin"]["placed"]) == len(devs),
            f"fleet: round_robin placed on {runs['round_robin']['placed']}")
    return {"devices": [d.key for d in devs], "chunks": FLEET_CHUNKS,
            "chunk_bytes": chunks[0].numel() * chunks[0].element_size(),
            "memory_limit_bytes": limit, "launches": launched, "runs": runs}


# ---------------------------------------------------------------------------
# graph capture: the chain of examples/graph_replay.py on CUDA graphs
# ---------------------------------------------------------------------------


def graph_program(dev):
    """The chain's kernels: the stencil and partition_map kernels, an
    elementwise shift and, for the two-chain plan, an add."""
    return dev.create_program({"stencil": stencil_ops.stencil, "partition_map": map_ops.partition_map,
                               "shift": lambda x: x + 1.0, "add": lambda x, y: x + y},
                              name="graph").get()


def graph_chain(prog, src, a, b, c, sync: str = "ready"):
    """stencil -> partition_map -> shift, ``src`` to ``c``; eager it returns
    the last launch's future, under a capture its node."""
    prog.run([src], "stencil", block=STENCIL_BLOCK, out=[a], sync=sync)
    prog.run([a], "partition_map", block=MAP_BLOCK, out=[b], sync=sync)
    return prog.run([b], "shift", out=[c], sync=sync)


def events_ms(dev, steps) -> float:
    """Device ms a step: CUDA events on the device's default stream around
    ``steps`` (callables returning a future resolved once their work is
    enqueued), run back to back, over their number."""
    dev.synchronize()
    cs = dev.default_stream.cuda_stream
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record(cs)
    futs = [step() for step in steps]
    for f in futs:
        f.get()
    end.record(cs)
    end.synchronize()
    return start.elapsed_time(end) / len(steps)


def instantiate_as(g, mode: str):
    """``g.instantiate()`` with ``REPRO_SEGMENT_COMPILE=mode``."""
    old = os.environ.get("REPRO_SEGMENT_COMPILE")
    os.environ["REPRO_SEGMENT_COMPILE"] = mode
    try:
        return g.instantiate()
    finally:
        if old is None:
            del os.environ["REPRO_SEGMENT_COMPILE"]
        else:
            os.environ["REPRO_SEGMENT_COMPILE"] = old


def phase_graph(dev) -> dict:
    """Eager chain against its captured graph: 100 replays with fresh
    inputs, each bit-equal to the eager chain on the same input; the first
    result unchanged by the later replays; graph-internal buffers refused;
    the executor the CUDA graph (``REPRO_SEGMENT_COMPILE=fused``: at this
    size the bind-time calibration, whose choice is printed beside one at a
    host-bound size, may prefer the eager launches).  Then the host us and
    device ms a step, eager against replay, and a two-chain plan (two
    branches of one graph) against its eager chains."""
    n = GRAPH_N
    prog = graph_program(dev)
    gen = torch.Generator(device=dev.torch_device).manual_seed(0)
    fresh = lambda: torch.randn(n, generator=gen, device=dev.torch_device)  # noqa: E731
    src, a, b, c, gsrc, ga, gb, gc = (dev.create_buffer(n, np.float32).get() for _ in range(8))

    def eager(x, sync="ready"):
        src.enqueue_write(0, x)
        return graph_chain(prog, src, a, b, c, sync)

    def eager_value(x):
        eager(x).get()
        return c.array()

    def captured(mode: str, size: int = n):
        """The chain captured at ``size`` and instantiated with
        ``REPRO_SEGMENT_COMPILE=mode``: (exe, its write node)."""
        bufs = [dev.create_buffer(size, np.float32).get() for _ in range(4)] if size != n else \
            (gsrc, ga, gb, gc)
        with dev.capture("chain") as g:
            node = bufs[0].enqueue_write(0, torch.zeros(size, device=dev.torch_device))
            graph_chain(prog, *bufs)
        return instantiate_as(g, mode), node

    # What the bind-time calibration chooses for this chain, here and at a
    # host-bound size; the checks below hold the CUDA graph itself.
    calibrated = {str(size): sorted({seg.exec_mode for seg in captured("auto", size)[0]._segments})
                  for size in (n, 1 << 14)}
    t0 = time.perf_counter()
    exe, w = captured("fused")
    instantiate_s = time.perf_counter() - t0
    modes = sorted({seg.exec_mode for seg in exe._segments})
    require(modes == ["fused"] and exe.cuda_graphs == 1, f"graph: executor {modes}, {exe!r}")
    require(exe.recorded_launches == {k: 1 for k in GRAPH_KERNELS},
            f"graph: the capture recorded {exe.recorded_launches}")
    first = first_copy = None
    for i in range(GRAPH_REPLAYS):
        x = fresh()
        exe.replay(feeds={w: x}).get()
        got = gc.array()
        if first is None:
            first, first_copy = got, got.clone()
        require(torch.equal(got, eager_value(x)), f"graph: replay {i} differs from the eager chain")
    require(torch.equal(first, first_copy), "graph: a later replay changed the first result")
    for name, buf in (("write-fed", gsrc), ("intermediate", ga), ("intermediate", gb)):
        try:
            buf.enqueue_read().get()
        except RuntimeError as e:
            require("donated" in str(e), f"graph: {name} buffer read failed otherwise: {e}")
        else:
            raise SmokeFailure(f"graph: a graph-internal ({name}) buffer's read did not raise")

    xs = [fresh() for _ in range(GRAPH_TIMED)]
    host_us = {"eager": [], "replay": []}
    for _ in range(2):  # eager, replay, replay, eager
        for kind in (("eager", "replay"), ("replay", "eager"))[_]:
            t0 = time.perf_counter()
            for x in xs:
                (eager(x) if kind == "eager" else exe.replay(feeds={w: x})).get()
            host_us[kind].append((time.perf_counter() - t0) / len(xs) * 1e6)
    device_ms = None
    if dev.is_cuda:
        device_ms = {"eager": events_ms(dev, [lambda x=x: eager(x, "dispatch") for x in xs]),
                     "replay": events_ms(dev, [lambda x=x: exe.replay(feeds={w: x}, sync="dispatch")
                                               for x in xs])}

    # Two chains joined by an add: three segments, each on its chain's lane
    # with a CUDA graph of its own, one event edge.
    a2, b2, ma, mb, out2 = (dev.create_buffer(n, np.float32).get() for _ in range(5))
    with dev.capture("two-chains") as g2:
        wa, wb = a2.enqueue_write(0, fresh()), b2.enqueue_write(0, fresh())
        prog.run([a2], "stencil", block=STENCIL_BLOCK, out=[ma])
        prog.run([b2], "partition_map", block=MAP_BLOCK, out=[mb])
        prog.run([ma, mb], "add", out=[out2])
    exe2 = instantiate_as(g2, "fused")
    require(exe2._fanout and len(exe2._segments) == 3 and exe2._event_edges
            and exe2.cuda_graphs == 3 and {s.exec_mode for s in exe2._segments} == {"fused"},
            f"graph: the two-chain plan is {exe2!r}")
    pairs = [(fresh(), fresh()) for _ in range(5)]
    for i, (xa, xb) in enumerate(pairs):
        exe2.replay(feeds={wa: xa, wb: xb}).get()
        want = stencil_ops.stencil(xa, block=STENCIL_BLOCK.as_tuple()) + \
            map_ops.partition_map(xb, block=MAP_BLOCK.as_tuple())
        require(torch.equal(out2.array(), want), f"graph: two-chain replay {i} differs from eager")
    t0 = time.perf_counter()
    for xa, xb in pairs:
        exe2.replay(feeds={wa: xa, wb: xb}).get()
    two_chain_host_us = (time.perf_counter() - t0) / len(pairs) * 1e6
    two_chain_ms = None
    if dev.is_cuda:
        two_chain_ms = events_ms(dev, [lambda p=p: exe2.replay(feeds={wa: p[0], wb: p[1]},
                                                                sync="dispatch") for p in pairs])
    dev.synchronize()
    replayed = [exe.replayed_launches(), exe2.replayed_launches()]
    return {"n": n, "replays_checked": GRAPH_REPLAYS, "exec": repr(exe), "two_chains": repr(exe2),
            "calibrated_exec_mode_by_n": calibrated,
            "instantiate_s": instantiate_s, "recorded_launches": exe.recorded_launches,
            "graph_replays": exe.graph_replays + exe2.graph_replays,
            "host_us_per_step": host_us, "device_ms_per_step": device_ms,
            "two_chains_host_us_per_replay": two_chain_host_us,
            "two_chains_device_ms_per_replay": two_chain_ms,
            "_replayed": {k: sum(r.get(k, 0) for r in replayed) for k in GRAPH_KERNELS}}


# ---------------------------------------------------------------------------
# graph_fleet: a plan over the fleet's logical devices, one future a replay
# ---------------------------------------------------------------------------


def fleet_dag(prog, sched, srcs, mids, outs, sync: str = "ready") -> list:
    """Each chunk ``srcs[i]`` through partition_map -> stencil into
    ``outs[i]``, both launches through ``run_on_any`` placed by ``sched``;
    eager it returns the stencils' futures, under a capture their nodes."""
    futs = []
    for s, m, o in zip(srcs, mids, outs):
        prog.run_on_any([s], "partition_map", block=MAP_BLOCK, out=[m], sync=sync, scheduler=sched)
        futs.append(prog.run_on_any([m], "stencil", block=STENCIL_BLOCK, out=[o], sync=sync,
                                    scheduler=sched))
    return futs


def span_ms(devs, steps, extra=(), hold: int = 0) -> "tuple[float, bool]":
    """Device ms a step over several streams: a CUDA event before
    ``steps`` (callables returning futures resolved once their work is
    enqueued) run back to back, another once every stream of ``devs`` (and
    ``extra``) has reached its end, over their number.  With ``hold``, a
    sleep of that many cycles first occupies every device's default stream
    and the clock starts when it ends, so work issued meanwhile queues
    behind it and the span is the device's alone; the flag says whether
    the sleep outlasted the issuing (else the host paced it)."""
    for d in devs:
        d.synchronize()
    s = torch.cuda.Stream(devs[0].torch_device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if hold:
        wait_all([d.ops_queue.submit(torch.cuda._sleep, hold) for d in devs])
        s.wait_stream(devs[0].default_stream.cuda_stream)
    start.record(s)
    futs = [f for step in steps for f in step()]
    for f in futs:
        f.get()
    held = not start.query()
    for cs in [st.cuda_stream for d in devs for st in d.streams()] + list(extra):
        s.wait_stream(cs)
    end.record(s)
    end.synchronize()
    return start.elapsed_time(end) / len(steps), held


def phase_graph_fleet(devs) -> dict:
    """The fleet phase's shape as one captured plan: ``FLEET_CHUNKS`` chunks
    of fig4's 2**28 f32, each partition_map -> stencil recorded through
    ``run_on_any`` with ``round_robin`` over the logical devices ``devs``,
    so the two launches of a chunk land on two devices (a transfer step and
    an event edge each).  Instantiated with ``REPRO_SEGMENT_COMPILE`` fused
    (a CUDA graph a segment), staged and auto; ``GRAPH_FLEET_REPLAYS``
    replays of the fused plan with fresh feeds, each bit-equal to the same
    DAG run eagerly through ``run_on_any`` and to one device's kernels;
    then host us and device ms a replay against the eager DAG: the span
    as the host paces it, and the device's alone (the work queued behind a
    sleep)."""
    n = FIG4_N // FLEET_CHUNKS
    d0 = devs[0]
    nd = len(devs)
    prog = d0.create_program({"partition_map": map_ops.partition_map,
                              "stencil": stencil_ops.stencil}, name="graph_fleet").get()
    for d in devs:  # build each sibling before timing
        for k in GRAPH_KERNELS:
            prog.for_device(d).build(k, block=MAP_BLOCK).get()
    gen = torch.Generator(device=d0.torch_device).manual_seed(1)

    def fresh():
        xs = [torch.randn(n, generator=gen, device=d0.torch_device) for _ in range(FLEET_CHUNKS)]
        if d0.is_cuda:
            torch.cuda.synchronize()  # made on this thread's stream, read on the fleet's
        return xs

    # Chunk i's partition_map is launch 2i, so round_robin puts it on
    # device 2i mod nd and its stencil on the next: each buffer starts
    # where its writer runs.
    home = lambda i, k: devs[(2 * i + k) % nd]  # noqa: E731

    def bufs():
        return ([home(i, 0).create_buffer(n, np.float32).get() for i in range(FLEET_CHUNKS)],
                [home(i, 0).create_buffer(n, np.float32).get() for i in range(FLEET_CHUNKS)],
                [home(i, 1).create_buffer(n, np.float32).get() for i in range(FLEET_CHUNKS)])

    gsrc, gmid, gout = bufs()
    esrc, emid, eout = bufs()
    rr = lambda: Scheduler(devs, policy="round_robin", steal=False)  # noqa: E731

    def eager(xs, sync="ready"):
        for s, x in zip(esrc, xs):
            s.enqueue_write(0, x)
        return fleet_dag(prog, rr(), esrc, emid, eout, sync)

    def captured(mode: str):
        with d0.capture("graph_fleet") as g:
            nodes = [g.write(s) for s in gsrc]  # fed at every replay
            fleet_dag(prog, rr(), gsrc, gmid, gout)
        return instantiate_as(g, mode), nodes

    reserved = [torch.cuda.memory_reserved() if d0.is_cuda else 0]
    t0 = time.perf_counter()
    exe, w = captured("fused")
    instantiate_s = time.perf_counter() - t0
    reserved.append(torch.cuda.memory_reserved() if d0.is_cuda else 0)
    segs = exe._segments
    keys = sorted({seg.device.key for seg in segs})
    cross = [e for e in exe._event_edges if segs[e[0]].device is not segs[e[1]].device]
    require(len(keys) >= 4 and len(keys) == nd and len(exe._transfers) >= FLEET_CHUNKS
            and all(seg.transfer_ixs for seg in segs if seg.nodes[0].kernel == "stencil")
            and cross, f"graph_fleet: the plan is {exe!r}")
    spec = exe.graph._sym_spec
    transfer_bytes = sum(int(np.prod(spec[t[0]].shape)) * spec[t[0]].dtype.itemsize
                         for t in exe._transfers)

    def check(ex, nodes, tag: str, replays: int):
        for i in range(replays):
            xs = fresh()
            ex.replay(feeds=dict(zip(nodes, xs))).get()
            wait_all(eager(xs))
            for c, x in enumerate(xs):
                want = stencil_ops.stencil(map_ops.partition_map(x, block=MAP_BLOCK.as_tuple()),
                                           block=STENCIL_BLOCK.as_tuple())
                got = gout[c].array()
                require(torch.equal(got, eout[c].array()) and torch.equal(got, want),
                        f"graph_fleet {tag}: replay {i}, chunk {c} differs from the eager DAG "
                        "or from one device's kernels")

    check(exe, w, "fused", GRAPH_FLEET_REPLAYS)
    graph_keys = sorted({seg.device.key for seg in segs if seg.graph is not None})
    require(graph_keys == keys and exe.cuda_graphs == len(segs),
            f"graph_fleet: CUDA graphs on {graph_keys} of {keys}, {exe!r}")
    staged, ws = captured("staged")
    require(staged.cuda_graphs == 0 and {s.exec_mode for s in staged._segments} == {"staged"},
            f"graph_fleet: the staged plan is {staged!r}")
    check(staged, ws, "staged", 3)
    auto = [seg.exec_mode for seg in captured("auto")[0]._segments]

    xs = [fresh() for _ in range(GRAPH_FLEET_TIMED)]
    host_us = {"eager": [], "replay": [], "replay_submit": []}
    for order in (("eager", "replay"), ("replay", "eager")):
        for kind in order:
            t0 = time.perf_counter()
            submit = 0.0
            for x in xs:
                if kind == "eager":
                    wait_all(eager(x))
                else:
                    t1 = time.perf_counter()
                    fut = exe.replay(feeds=dict(zip(w, x)))
                    submit += time.perf_counter() - t1
                    fut.get()
            host_us[kind].append((time.perf_counter() - t0) / len(xs) * 1e6)
            if kind == "replay":
                host_us["replay_submit"].append(submit / len(xs) * 1e6)
    device_ms = device_only_ms = None
    if d0.is_cuda:
        steps = {"eager": [lambda x=x: eager(x, "dispatch") for x in xs],
                 "replay": [lambda x=x: [exe.replay(feeds=dict(zip(w, x)), sync="dispatch")]
                            for x in xs]}
        extra = {"eager": [], "replay": [exe._join_stream]}
        device_ms = {k: span_ms(devs, steps[k], extra[k])[0] for k in steps}
        device_only_ms = {k: span_ms(devs, steps[k], extra[k], hold=GRAPH_FLEET_HOLD)
                          for k in steps}
        require(all(held for _, held in device_only_ms.values()),
                f"graph_fleet: the hold ended before the work was issued: {device_only_ms}")
        device_only_ms = {k: v[0] for k, v in device_only_ms.items()}
    for d in devs:
        d.synchronize()
    return {"devices": keys, "chunks": FLEET_CHUNKS, "chunk_bytes": n * 4, "exec": repr(exe),
            "segments": len(segs), "lanes": len({id(seg.queue) for seg in segs}),
            "transfers": len(exe._transfers), "transfer_bytes_per_replay": transfer_bytes,
            "event_edges": len(exe._event_edges), "cross_device_event_edges": len(cross),
            "cuda_graphs": exe.cuda_graphs,
            "graphs_by_device": {k: sum(seg.graph is not None and seg.device.key == k
                                        for seg in segs) for k in keys},
            "auto_exec_mode_per_segment": auto, "staged_exec": repr(staged),
            "instantiate_s": instantiate_s, "memory_reserved_bytes": reserved,
            "replays_checked": GRAPH_FLEET_REPLAYS, "host_us_per_replay": host_us,
            "device_ms_per_replay": device_ms, "device_only_ms_per_replay": device_only_ms,
            "recorded_launches": exe.recorded_launches,
            "_replayed": exe.replayed_launches()}


# ---------------------------------------------------------------------------
# each kernel against its plain version, timed beside its bound
# ---------------------------------------------------------------------------


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, flops: float, flop_rate: float = F32_FLOP_PER_S) -> "tuple[float, str]":
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def entry(name, source, replaces, launches, err, ms, plain_ms, bound_pair, library_ms, **extra):
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_pair[0], "bound_by": bound_pair[1], "library_ms": library_ms,
            **extra}


def check_stencil(x: "torch.Tensor", launches: int) -> dict:
    blk = STENCIL_BLOCK.as_tuple()
    y = stencil_kernel.stencil(x, block=blk)
    err = float((y - stencil_ref(x)).abs().max())
    require(err <= 1e-6, f"stencil kernel differs from its plain version by {err}")
    w = torch.tensor([0.5, 1.0, 0.5], device=x.device).view(1, 1, 3)
    torch.backends.cudnn.allow_tf32 = False  # the yardstick in full f32
    conv = lambda: torch.nn.functional.conv1d(x.view(1, 1, -1), w, padding=1)  # noqa: E731
    n = x.numel()
    return entry("stencil", "src/repro_torch/kernels/csrc/stencil.cu",
                 "src/repro/kernels/stencil/kernel.py:30", launches, err,
                 cuda_ms(lambda: stencil_kernel.stencil(x, block=blk), 20),
                 cuda_ms(lambda: stencil_ref(x), 5), bound(8 * n, 4 * n), cuda_ms(conv, 20))


def check_partition_map(x: "torch.Tensor", launches: int) -> dict:
    blk = MAP_BLOCK.as_tuple()
    y = map_kernel.partition_map(x, block=blk)
    plain = partition_map_ref(x)
    err = float((y - plain).abs().max())
    off_one = float((y - 1.0).abs().max())
    # Both use the precise sinf/cosf and round each operation once, so they
    # agree bit for bit; the plain version strays from 1 by up to 1.2e-7,
    # so a kernel that wrote 1 (or left stale ones) fails here.
    require(bool((plain != 1).any()), "partition_map: the plain version is 1 everywhere")
    require(err == 0, f"partition_map differs from its plain version by {err}")
    require(off_one <= 1e-5, f"partition_map |y - 1| = {off_one} > 1e-5")
    n = x.numel()
    # sin, cos, two squares, one add, one sqrt: 6 operations per element.
    return entry("partition_map", "src/repro_torch/kernels/csrc/partition_map.cu",
                 "src/repro/kernels/partition_map/kernel.py:24", launches, err,
                 cuda_ms(lambda: map_kernel.partition_map(x, block=blk), 20),
                 cuda_ms(lambda: partition_map_ref(x), 5), bound(8 * n, 6 * n), None,
                 max_abs_err_vs_one=off_one)


def mandelbrot_flops(counts: "torch.Tensor", max_iter: int) -> int:
    """Flops this image's data needs: 8 per live iteration, the 3-flop test
    that ends each escaped pixel's loop, and 2 per coordinate: one per
    column for cr, one per row for ci."""
    h, w = counts.shape
    c = counts.to(torch.int64)
    return 8 * int(c.sum()) + 3 * int((c < max_iter).sum()) + 2 * (h + w)


def mandelbrot_simt(counts: "torch.Tensor", rounds: "torch.Tensor") -> float:
    """SIMT efficiency of a launch on this image: its live iterations over
    32 lanes x the most any lane of each warp round runs.  ``rounds`` holds
    each pixel's warp round, as ``mandel_kernel.warp_rounds`` reads it from
    the kernel's library: a warp runs its pixels of a round until its
    slowest escapes, and the rest of its lanes idle."""
    c = counts.reshape(-1).to(torch.int64)
    _, key = torch.unique(rounds.reshape(-1), return_inverse=True)
    most = torch.zeros(int(key.max()) + 1, dtype=torch.int64, device=c.device)
    most.scatter_reduce_(0, key, c, "amax", include_self=False)
    return int(c.sum()) / max(32 * int(most.sum()), 1)


def sass(library: "str | Path") -> str:
    """The SASS of a built ``library`` (``cuobjdump`` of the CUDA toolkit
    whose ``nvcc`` built it)."""
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    return subprocess.run([str(tool) if tool.exists() else "cuobjdump", "-sass", str(library)],
                          capture_output=True, text=True, check=True, timeout=120).stdout


def sass_instructions(text: str) -> "list[tuple[int, str, str]]":
    """(address, opcode, operands) of each instruction ``cuobjdump -sass``
    printed, the predicate dropped (``@!P0 BRA 0x13b0`` -> ``BRA``)."""
    line = r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);"
    return [(int(m.group(1), 16), m.group(2), m.group(3).strip())
            for m in re.finditer(line, text)]


def sass_count(text: str, opcode: str) -> int:
    """Instructions whose opcode, without its modifiers, is ``opcode``."""
    return sum(op.split(".")[0] == opcode for _, op, _ in sass_instructions(text))


def mandelbrot_ptxas(log: "str | None" = None) -> dict:
    """Registers and spills of the mandelbrot kernel, read from ``log`` (by
    default this run's build log); it must be there and must not spill."""
    usage = ptxas_no_spill(build_log("mandelbrot") if log is None else log, "mandelbrot",
                           "mandelbrot_kernel")
    require(len(usage) == 1 and "registers" in next(iter(usage.values()), {}),
            f"mandelbrot: no ptxas line for the kernel in the build log: {usage}")
    return next(iter(usage.values()))


def check_mandelbrot(dev, main_image: np.ndarray, launches: int) -> dict:
    blk = MANDEL_BLOCK.as_tuple()
    h = w = FIG5_SIZE
    run = lambda: mandel_kernel.mandelbrot(h, w, FIG5_ITERS, device=dev, block=blk)  # noqa: E731
    got = run()
    gx, gy, bx, by = mandel_kernel.last_geometry  # as the wrapper launched it
    rounds = mandel_kernel.warp_rounds(h, w, device=dev, block=(bx, by), grid=(gx, gy))
    want = mandelbrot_ref(h, w, FIG5_ITERS, device=dev)
    differing = int((got != want).sum())
    require(differing == 0, f"mandelbrot: {differing} pixels differ from the plain version")
    require(np.array_equal(got.cpu().numpy(), main_image), "mandelbrot: main path image differs")
    # Each operation is rounded on its own; an FFMA would be a contraction.
    code = sass(_build._target("mandelbrot"))
    ffma = sass_count(code, "FFMA")
    require(ffma == 0 and sass_count(code, "FMUL") > 0, f"mandelbrot: {ffma} FFMA in the SASS")
    flops = mandelbrot_flops(got, FIG5_ITERS)
    return entry("mandelbrot", "src/repro_torch/kernels/csrc/mandelbrot.cu",
                 "src/repro/kernels/mandelbrot/kernel.py:44", launches,
                 float((got - want).abs().max()), cuda_ms(run, 10),
                 cuda_ms(lambda: mandelbrot_ref(h, w, FIG5_ITERS, device=dev), 2),
                 bound(4 * h * w, flops), None, differing_pixels=differing, flops=flops,
                 bound_unfused_ms=flops / F32_SLOTS_PER_S * 1e3,
                 simt_efficiency=mandelbrot_simt(got, rounds),
                 grid=[gx, gy], block=[bx, by], block_steps=list(mandel_kernel.block_steps()),
                 sass_ffma=ffma, ptxas=mandelbrot_ptxas())


def attention_pairs(B: int, H: int, Sq: int, Skv: int, causal: bool) -> int:
    """Unmasked (query, key) pairs: query row r sees keys 0..r if causal."""
    if not causal:
        return B * H * Sq * Skv
    return B * H * int(np.minimum(np.arange(1, Sq + 1), Skv).sum())


def flash_bound(nbytes: float, flops: float, dtype) -> "tuple[float, str, str]":
    """The least time for flash attention's work at its dtype's accuracy:
    (ms, "bytes" or "operations", the rate that bounds the operations).
    bf16 runs on the tensor cores; f32 takes the faster of the CUDA cores
    and 3xTF32 on the tensor cores, 3 tf32 products for each f32 one."""
    if dtype == torch.bfloat16:
        rate, peak = BF16_FLOP_PER_S, "bf16 tensor cores 989 TFLOP/s"
    else:  # 495 / 3 = 165 TFLOP/s, above the CUDA cores' 67
        rate, peak = TF32_FLOP_PER_S / 3, "f32 as 3xTF32: 3 tf32 products at 495 TFLOP/s"
    return (*bound(nbytes, flops, rate), peak)


def ptxas_usage(log: str, function: str) -> "dict | None":
    """Registers and spill bytes that ``-Xptxas -v`` reported in ``log``
    for the first entry function whose mangled name holds ``function``."""
    for part in log.split("Compiling entry function")[1:]:
        if function in part.splitlines()[0]:
            return {key: int(m.group(1)) for key, pat in (
                ("registers", r"Used (\d+) registers"),
                ("spill_stores", r"(\d+) bytes spill stores"),
                ("spill_loads", r"(\d+) bytes spill loads")) for m in [re.search(pat, part)] if m}
    return None


def build_log(name: str) -> str:
    """This run's ``nvcc`` log of ``csrc/<name>.cu``."""
    return _build._target(name).with_suffix(".log").read_text()


def ptxas_no_spill(log: str, name: str, pattern: str, required: bool = True) -> dict:
    """``ptxas_usage`` of every entry function in ``log``, the build log of
    ``name``, whose mangled name holds ``pattern``; with ``required``,
    every one of them must be free of spills."""
    usage = {f: ptxas_usage(log, f)
             for f in re.findall(r"entry function '(\w*%s\w*)'" % pattern, log)}
    spills = {f: u for f, u in usage.items() if u.get("spill_stores") or u.get("spill_loads")}
    require(not (required and spills), f"{name} spills registers: {spills}")
    return usage


def flash_ptxas(dtype, D: int) -> dict:
    """``ptxas_usage`` of the flash kernel instantiated for ``dtype`` and
    ``D``; no instantiation of it may spill."""
    want = ("flash_fwdIf" if dtype == torch.float32 else "flash_fwdI13__nv_bfloat16") + f"Li{D}E"
    usage = ptxas_no_spill(build_log("flash_attention"), "flash_attention", "flash_fwd")
    found = [u for f, u in usage.items() if want in f]
    require(bool(found) and "registers" in found[0], "flash_attention: no ptxas line for "
                                                     f"{dtype} D={D} in the build log")
    return found[0]


SSD_KERNELS = ("ssd_chunk_states", "ssd_state_pass", "ssd_chunk_outputs")


def ssd_ptxas(log: "str | None" = None, required: bool = True) -> dict:
    """Registers and spills of the three ssd_scan kernels, by name and
    instantiation (``ssd_chunk_outputs<1>``: P <= 64, ``<2>``: P <= 128),
    read from ``log`` (by default this run's build log); with
    ``required``, each kernel has a line and none spills."""
    out = {}
    log = build_log("ssd_scan") if log is None else log
    for f, u in ptxas_no_spill(log, "ssd_scan", "ssd_", required).items():
        m = re.search(r"\d+(ssd_[a-z_]+)(?:ILi(\d+)E)?", f)
        out[m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")] = u
    require(not required or all(any(k.split("<")[0] == n for k in out) for n in SSD_KERNELS),
            f"ssd_scan: no ptxas line for each of {SSD_KERNELS} in the build log: {sorted(out)}")
    return out


def paged_ptxas(log: "str | None" = None) -> dict:
    """Registers and spills of every paged_attention instantiation, by
    dtype, load width W and chunks a lane NPL (``f32 W4 NPL1``: the
    vector loads at D <= 128), read from ``log`` (by default this run's
    build log); none may spill, and the log must hold them."""
    log = build_log("paged_attention") if log is None else log
    out = {}
    for f, u in ptxas_no_spill(log, "paged_attention", "paged_").items():
        m = re.search(r"paged_decodeI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)E", f)
        require(m is not None and "registers" in u, f"paged_attention: unread ptxas entry {f}")
        out[f"{'f32' if m.group(1) == 'f' else 'bf16'} W{m.group(2)} NPL{m.group(3)}"] = u
    require(len(out) >= 12, f"paged_attention: {len(out)} instantiations in the build log, not 12")
    return out


def check_flash(name: str, shape, dtype, launches: int, device, causal: bool = True,
                **extra) -> dict:
    B, S, H, K, D = shape
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(device, dtype)
               for s in ((B, S, H, D), (B, S, K, D), (B, S, K, D)))
    run = lambda: flash_kernel.flash_attention(q, k, v, causal=causal)  # noqa: E731
    plain = lambda: flash_attention_ref(q, k, v, causal=causal)  # noqa: E731
    got, want = run(), plain()
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    if dtype == torch.float32:  # both sum in f32, in other orders
        limit = {"max_abs": FLASH_F32_TOL}
        require(err <= FLASH_F32_TOL, f"{name} differs from its plain version by {err}")
    else:  # per element, about 2**-7 of its scale: see bf16_bound
        ratio = float((diff / bf16_bound(q, k, v, want)).max())
        limit = {"bf16_bound": "2**-7 * (attention of |v| + |o|)", "max_err_over_bound": ratio}
        require(ratio <= 1, f"{name} differs from its plain version by {ratio} of bf16_bound")
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=causal, enable_gqa=True)
    flops = 4 * D * attention_pairs(B, H, S, S, causal)
    nbytes = q.element_size() * 2 * (q.numel() + k.numel())  # q, k, v, o once each
    *bound_pair, peak = flash_bound(nbytes, flops, dtype)
    ms, library_ms = cuda_ms(run, 10), cuda_ms(sdpa, 10)
    return entry(name, "src/repro_torch/kernels/csrc/flash_attention.cu",
                 "src/repro/kernels/flash_attention/kernel.py:73", launches, err,
                 ms, cuda_ms(plain, 3), bound_pair, library_ms,
                 shape={"B": B, "S": S, "H": H, "K": K, "D": D}, dtype=str(dtype).split(".")[-1],
                 causal=causal, flops=flops, flop_peak=peak, tflops=flops / ms / 1e9,
                 x_library=ms / library_ms, ptxas=flash_ptxas(dtype, D), limit=limit, **extra)


def ssd_flops(Bz: int, H: int, S: int, P: int, N: int, chunk: int) -> int:
    """Flops of the chunked SSD form at chunk length ``chunk`` (the last
    chunk ragged): a row and chunk of length l take (N + P) l (l + 1) for
    C.B^T over j <= i and att.x, and 4 l N P for the incoming state's
    output and the state update."""
    ls = [min(chunk, S - c0) for c0 in range(0, S, chunk)]
    return Bz * H * sum((N + P) * l * (l + 1) + 4 * l * N * P for l in ls)


def ssd_least_flops(Bz: int, H: int, S: int, P: int, N: int) -> int:
    """The least flops that give the same y and final state: the chunked
    count falls with the chunk length (the quadratic part costs (N + P)
    (l + 1) a token, the state part 4 N P whatever l), so it is least at
    l = 1, the 4 N P a token that every form pays, plus 2 (N + P)."""
    return ssd_flops(Bz, H, S, P, N, 1)


SSD_TC_CHUNK = 16  # the shortest chunk that fills the 16 rows of an m16n8k8 tile


def ssd_bound(nbytes: float, Bz: int, H: int, S: int, P: int, N: int
              ) -> "tuple[float, str, str, int]":
    """The least time for the SSD scan's work at f32 accuracy, bounded as
    flash f32 is: (ms, "bytes" or "operations", the rate, the flops it
    counts).  The faster of two routes: the CUDA cores at 67 TFLOP/s on
    ``ssd_least_flops`` (chunk 1), and 3xTF32 on the tensor cores at
    495 / 3 TFLOP/s on the chunked count at ``SSD_TC_CHUNK``, the least
    count of a chunk the tensor cores take (it grows with the chunk)."""
    routes = []
    for flops, rate, peak in (
            (ssd_least_flops(Bz, H, S, P, N), F32_FLOP_PER_S, "f32 CUDA cores 67 TFLOP/s, chunk 1"),
            (ssd_flops(Bz, H, S, P, N, SSD_TC_CHUNK), TF32_FLOP_PER_S / 3,
             f"f32 as 3xTF32: 3 tf32 products at 495 TFLOP/s, chunk {SSD_TC_CHUNK}")):
        routes.append((*bound(nbytes, flops, rate), peak, flops))
    return min(routes, key=lambda r: r[0])


def ssd_inputs(cfg, device, S: int = max(SSM_PROMPTS)) -> "list[torch.Tensor]":
    """x, dt, A, B, C at a serve shape (by default serve_ssm's longer
    prompt) like the model's: x, B and C strided views of one xBC tensor,
    the init's dt range and A = -(1..H), from a seed."""
    s = cfg.ssm
    H, P, G, N, di = s.n_heads(cfg.d_model), s.head_dim, s.n_groups, s.d_state, s.d_inner(cfg.d_model)
    Bz = SERVE_BATCH
    rng = np.random.default_rng(7)
    xbc = torch.from_numpy(rng.standard_normal((Bz, S, di + 2 * G * N), dtype=np.float32)).to(device)
    x = xbc[..., :di].reshape(Bz, S, H, P)
    B = xbc[..., di:di + G * N].reshape(Bz, S, G, N)
    C = xbc[..., di + G * N:].reshape(Bz, S, G, N)
    dt = torch.from_numpy(np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (Bz, S, H)))
                          .astype(np.float32)).to(device)
    A = -torch.arange(1, H + 1, dtype=torch.float32, device=device)
    return [x, dt, A, B, C]


def check_ssd(cfg, launches: int, kernel_launches: int, device, *, name: str = "ssd_scan",
              prompts=SSM_PROMPTS) -> dict:
    """ssd_scan at the serve shape (``cfg``'s heads, the longer of
    ``prompts``) on ``ssd_inputs``.  y and the final state against
    ``ssd_chunked`` and against ``ssd_three_pass`` at the kernel's own chunk
    length, and against the sequential recurrence at the shorter prompt (a
    ragged last chunk).  ``launches`` and ``kernel_launches`` are the main
    path's calls and the CUDA kernels they launched, three a call.  The
    bound is ``ssd_bound``'s.  The kernels-line entry ``name``."""
    s = cfg.ssm
    x, dt, A, B, C = ssd_inputs(cfg, device, max(prompts))
    Bz, S, H, P = x.shape
    G, N = B.shape[2:]
    require(kernel_launches == len(SSD_KERNELS) * launches,
            f"{name}: {launches} calls launched {kernel_launches} kernels, "
            f"not {len(SSD_KERNELS)} each")
    chunk = ssd_kernel.chunk_length()
    run = lambda: ssd_kernel.ssd_scan(x, dt, A, B, C)  # noqa: E731
    plain = lambda: ssd_chunked(x, dt, A, B, C, s.chunk)  # noqa: E731
    (y, state), (y_want, state_want) = run(), plain()
    err_y = float((y - y_want).abs().max())
    err_state = float((state - state_want).abs().max())
    y3, state3 = ssd_three_pass(x, dt, A, B, C, chunk)
    err_three = max(float((y - y3).abs().max()), float((state - state3).abs().max()))
    del y3, state3
    S1 = min(prompts)
    y1, state1 = ssd_kernel.ssd_scan(x[:, :S1], dt[:, :S1], A, B[:, :S1], C[:, :S1])
    y1_seq, state1_seq = ssd_ops.ssd(x[:, :S1], dt[:, :S1], A, B[:, :S1], C[:, :S1], impl="ref",
                                     return_state=True)
    err_seq = float((y1 - y1_seq).abs().max())
    err_seq_state = float((state1 - state1_seq).abs().max())
    for what, err in (("y", err_y), ("final state", err_state), ("y vs sequential", err_seq),
                      ("final state vs sequential", err_seq_state),
                      (f"vs ssd_three_pass at chunk {chunk}", err_three)):
        require(err <= SSD_TOL, f"{name} {what} differs from its plain version by {err}")
    nbytes = 4 * (2 * x.numel() + dt.numel() + A.numel() + 2 * B.numel() + state.numel())
    t_bound, by, peak, flops = ssd_bound(nbytes, Bz, H, S, P, N)
    return entry(name, "src/repro_torch/kernels/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan/kernel.py:64", launches,
                 max(err_y, err_state, err_seq, err_seq_state),
                 cuda_ms(run, 10), cuda_ms(plain, 3), (t_bound, by), None,
                 shape={"Bz": Bz, "S": S, "H": H, "G": G, "N": N, "P": P, "chunk": s.chunk},
                 kernel_chunk=chunk, kernel_launches=kernel_launches,
                 kernel_launches_per_call=kernel_launches / launches,
                 workspace_bytes=ssd_kernel.workspace_bytes(Bz, S, H, N, P), ptxas=ssd_ptxas(),
                 flops=flops, flop_peak=peak,
                 flops_least=ssd_least_flops(Bz, H, S, P, N),
                 flops_at_model_chunk=ssd_flops(Bz, H, S, P, N, s.chunk),
                 flops_at_kernel_chunk=ssd_flops(Bz, H, S, P, N, chunk),
                 bytes=nbytes, max_abs_err_y=err_y, max_abs_err_state=err_state,
                 max_abs_err_vs_three_pass=err_three,
                 max_abs_err_vs_sequential={"S": S1, "y": err_seq, "state": err_seq_state},
                 limit={"max_abs": SSD_TOL},
                 library="none: no single PyTorch call computes the SSD scan")


def paged_bytes(q: "torch.Tensor", k_pages: "torch.Tensor", page_table: "torch.Tensor",
                lengths: "torch.Tensor") -> int:
    """Bytes paged attention must move for these lengths: the K and V rows
    of each valid token once per layer (whole pages past a row's length and
    the masked tail of its last page are not read), q read and o written
    once, and the table entries and lengths it reads.  q (B, H, D) or
    (L, B, H, D); pages (N, P, K, D) or (L, N, P, K, D)."""
    P, K, D = k_pages.shape[-3:]
    layers = q.shape[0] if q.dim() == 4 else 1
    n = lengths.long().clamp(0, page_table.shape[1] * P)
    kv = 2 * layers * int(n.sum()) * K * D * k_pages.element_size()
    table = 4 * int(((n + P - 1) // P).sum()) + 4 * lengths.numel()
    return kv + 2 * q.numel() * q.element_size() + table


def paged_flops(q: "torch.Tensor", lengths: "torch.Tensor", max_tokens: int) -> int:
    """4 D flops per (query head, valid token): q.k and p.v, per layer."""
    D = q.shape[-1]
    rows = q.numel() // (D * lengths.numel())  # heads x layers
    return 4 * D * rows * int(lengths.long().clamp(0, max_tokens).sum())


def paged_inputs(B: int, H: int, K: int, D: int, P: int, M: int, lengths, device,
                 dtype=torch.float32, layers: "int | None" = None, seed: int = 7):
    """A pool like the reference test's, made on the card: pages in order
    from 1 cover each row's length, and page 0, the unreferenced pages and
    the tail of each last page hold +1e6 (k) / -1e6 (v), so a masking fault
    is a blow-up.  ``layers`` folds L layers under one table."""
    N = 1 + sum(-(-n // P) for n in lengths) + 2
    tbl = np.zeros((B, M), np.int32)
    valid = np.zeros((N, P), bool)
    nxt = 1
    for b, n in enumerate(lengths):
        for j in range(-(-n // P)):
            tbl[b, j] = nxt
            valid[nxt, :min(P, n - j * P)] = True
            nxt += 1
    lead = () if layers is None else (layers,)
    gen = torch.Generator(device=device).manual_seed(seed)
    randn = lambda *shape: torch.randn(*lead, *shape, generator=gen, device=device)  # noqa: E731
    keep = torch.from_numpy(valid).to(device)[:, :, None, None]
    kp = randn(N, P, K, D).masked_fill_(~keep, 1e6).to(dtype)
    vp = randn(N, P, K, D).masked_fill_(~keep, -1e6).to(dtype)
    q = randn(B, H, D).to(dtype)
    return (q, kp, vp, torch.from_numpy(tbl).to(device),
            torch.tensor(lengths, dtype=torch.int32).to(device))


def paged_case(B: int, H: int, K: int, D: int, P: int, M: int, lengths, device, dtype,
               reps: int = 20) -> dict:
    """One timed paged_attention call beside its bound: the kernel against
    the plain version (f32: the largest difference; bf16: the largest
    difference over ``paged_attention.ref.bf16_bound``), and the blocks of
    its grid and of each cluster as the C entry recorded its launch."""
    q, kp, vp, tbl, lens = paged_inputs(B, H, K, D, P, M, lengths, device, dtype)
    got, want = paged_kernel.paged_attention(q, kp, vp, tbl, lens), paged_attention_ref(q, kp, vp,
                                                                                       tbl, lens)
    launched = {"blocks": paged_kernel.last_blocks, "cluster": paged_kernel.last_cluster}
    require(bool(got.isfinite().all()), f"paged_attention {dtype} B={B}: non-finite output")
    diff = (got.float() - want.float()).abs()
    out = {"B": B, "H": H, "K": K, "lengths": lengths, "dtype": str(dtype).split(".")[-1]}
    if dtype == torch.float32:
        out["max_abs_err"] = float(diff.max())
        require(out["max_abs_err"] <= PAGED_TOL,
                f"paged_attention B={B} differs from its plain version by {out['max_abs_err']}")
    else:
        tol = paged_bf16_bound(q, kp, vp, tbl, lens, want)
        out["max_err_over_bound"] = float((diff / tol).max())
        require(out["max_err_over_bound"] <= 1, f"paged_attention bf16 H={H} K={K} differs by "
                                                f"{out['max_err_over_bound']} of its bf16 bound")
    t, by = bound(paged_bytes(q, kp, tbl, lens), paged_flops(q, lens, M * P))
    ms = cuda_ms(lambda: paged_kernel.paged_attention(q, kp, vp, tbl, lens), reps)
    return {**out, "ms": ms, "bound_ms": t, "bound_by": by, "x_bound": ms / t, **launched}


def paged_entry(name: str, shape, lengths, launches: int, device, **extra) -> dict:
    """paged_attention at ``shape`` (B, H, K, D, P, M) over ``lengths`` in
    f32 against the plain gather version within ``PAGED_TOL``, on the vector
    loads, in clusters of ``splits()`` blocks; timed beside its bound
    (``paged_bytes``), the plain version and SDPA over a cache gathered
    beforehand (the gather excluded).  The kernels-line entry ``name``."""
    B, H, K, D, P, M = shape
    q, kp, vp, tbl, lens = paged_inputs(B, H, K, D, P, M, lengths, device)
    run = lambda: paged_kernel.paged_attention(q, kp, vp, tbl, lens)  # noqa: E731
    plain = lambda: paged_attention_ref(q, kp, vp, tbl, lens)  # noqa: E731
    got, want = run(), plain()
    err = float((got - want).abs().max())
    require(bool(got.isfinite().all()), f"{name}: non-finite output")
    require(err <= PAGED_TOL, f"{name} differs from its plain version by {err}")
    require(paged_kernel.last_load_width == 4, f"{name}: the shape did not take the vector loads")
    splits = paged_kernel.splits()
    launched = {"splits": splits, "cluster": paged_kernel.last_cluster,
                "blocks": paged_kernel.last_blocks}
    require(launched["cluster"] == splits and launched["blocks"] == splits * K * B,
            f"{name} launched {launched['blocks']} blocks in clusters of "
            f"{launched['cluster']}, not {splits * K * B} in clusters of {splits}")
    S = M * P
    kc = kp[tbl.long()].reshape(B, S, K, D).transpose(1, 2)
    vc = vp[tbl.long()].reshape(B, S, K, D).transpose(1, 2)
    mask = (torch.arange(S, device=device)[None, :] < lens[:, None])[:, None, None, :]
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        q[:, :, None], kc, vc, attn_mask=mask, enable_gqa=True)
    nbytes, flops = paged_bytes(q, kp, tbl, lens), paged_flops(q, lens, S)
    return entry(name, "src/repro_torch/kernels/csrc/paged_attention.cu",
                 "src/repro/kernels/paged_attention/kernel.py:84", launches, err,
                 cuda_ms(run, 20), cuda_ms(plain, 5), bound(nbytes, flops), cuda_ms(sdpa, 20),
                 shape={"B": B, "H": H, "K": K, "D": D, "P": P, "M": M, "lengths": lengths},
                 dtype="float32", bytes=nbytes, flops=flops, limit={"max_abs": PAGED_TOL},
                 library="SDPA over the cache gathered beforehand (gather excluded)",
                 **launched, **extra)


def check_paged(launches: int, device) -> dict:
    """paged_attention at the serve decode shape (OLMo-1B: B 8, H = K = 16,
    D 128, P 16, lengths 4 x 1000 and 4 x 2000, table width 128) in f32
    against the plain gather version (``paged_entry``); the same in bf16, a
    bf16 GQA check at StarCoder2-7B's heads, per element within
    ``paged_attention.ref.bf16_bound``, and B 1 with one 2000-token row
    (the grid at small batch), each timed beside its bound; the 16-layer
    fold against 16 single-layer launches, bit for bit; no spill in any
    instantiation."""
    B, H, K, D, P, M = SERVE_BATCH * 2, 16, 16, 128, 16, 128
    lengths = [1000] * SERVE_BATCH + [2000] * SERVE_BATCH
    Lf = get_config(SERVE_ARCH).num_layers
    fq, fk, fv, ftbl, flens = paged_inputs(B, H, K, D, P, M, lengths, device, layers=Lf)
    folded = paged_kernel.paged_attention_layers(fq, fk, fv, ftbl, flens)
    fold_blocks = paged_kernel.last_blocks
    fold_equal = all(torch.equal(folded[i], paged_kernel.paged_attention(fq[i], fk[i], fv[i],
                                                                         ftbl, flens))
                     for i in range(Lf))
    require(fold_equal, "paged_attention: the fold differs from per-layer launches")
    fold_ms = cuda_ms(lambda: paged_kernel.paged_attention_layers(fq, fk, fv, ftbl, flens), 5)
    fold_bound = bound(paged_bytes(fq, fk, ftbl, flens), paged_flops(fq, flens, M * P))
    del fq, fk, fv, folded

    GB, GH, GK = 4, 36, 4  # StarCoder2-7B's heads
    glens = [1000, 2000, 1000, 2000]
    gqa = paged_case(GB, GH, GK, D, P, M, glens, device, torch.bfloat16)
    bf16 = paged_case(B, H, K, D, P, M, lengths, device, torch.bfloat16)
    row = paged_case(1, H, K, D, P, M, [2000], device, torch.float32)
    return paged_entry("paged_attention", (B, H, K, D, P, M), lengths, launches, device,
                       ptxas=paged_ptxas(),
                       fold={"layers": Lf, "bit_equal": fold_equal, "ms": fold_ms,
                             "blocks": fold_blocks, "bound_ms": fold_bound[0],
                             "bound_by": fold_bound[1]},
                       bf16=bf16, b1_row=row,
                       gqa_bf16={**gqa, "bf16_bound": "2**-7 * (attention of |v| + |o|)"})


def check_paged_decode(name: str, arch: str, prompts, new_tokens: int, launches: int,
                       device) -> dict:
    """paged_attention at a paged phase's decode shape (``paged_entry``):
    ``SERVE_BATCH`` rows of each prompt length of ``prompts`` (a hybrid's
    meta tokens added), ``arch``'s heads, pages of 16, lengths spread across
    the ``new_tokens - 1`` decode steps, a table of the pages the longest
    row ends at."""
    cfg = get_config(arch)
    new = new_tokens - 1  # decode steps past the prompt
    lengths = [cfg.meta_tokens + s + new * i // (SERVE_BATCH - 1) for s in prompts
               for i in range(SERVE_BATCH)]
    P = 16
    shape = (len(lengths), cfg.num_heads, cfg.num_kv_heads, cfg.hd, P, -(-max(lengths) // P))
    return paged_entry(name, shape, lengths, launches, device)


def check_paged_encdec(launches: int, device) -> dict:
    """paged_attention at whisper-tiny's decode shape in serve_paged_encdec:
    B 8, H = K = 6, D 64, P 16, lengths across the decode of the 64- and
    256-token prompts (64-95 and 256-287), a table of the 18 pages the
    longest row ends at."""
    return check_paged_decode("paged_attention_encdec", ENCDEC_ARCH, ENCDEC_PROMPTS, ENCDEC_NEW,
                              launches, device)


def check_paged_hybrid(launches: int, device) -> dict:
    """paged_attention at Hymba-1.5B's decode shape in serve_paged_hybrid
    (its 3 global layers' launches): B 8, H 25 over K 5, D 64, P 16, lengths
    across the decode of the 700- and 2000-token prompts with their 128 meta
    tokens (828-859 and 2128-2159), a table of 135 pages."""
    return check_paged_decode("paged_attention_hybrid", HYBRID_ARCH, HYBRID_PROMPTS, HYBRID_NEW,
                              launches, device)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; the port's main path needs a card",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    # A run that hangs prints every thread's stack and exits non-zero.
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)

    t0 = time.perf_counter()
    _build.load_all()  # one nvcc per source, all started together
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.2f} s for {len(_build.NAMES)} libraries", flush=True)

    devices = get_all_devices(1, 0).get()  # Listing 1
    require(len(devices) >= 1 and devices[0].platform == "cuda", "no CUDA device discovered")
    dev = devices[0]
    progs = {name: dev.create_program_with_file(str(KERNEL_DIR / name / "ops.py"))
             for name in FIG_KERNELS}
    progs = {name: f.get() for name, f in progs.items()}

    rng = np.random.default_rng(0)
    fig3_hosts = [rng.standard_normal(FIG3_N, dtype=np.float32) for _ in range(FIG3_INPUTS)]
    gen = torch.Generator().manual_seed(0)
    fig4_hosts = [torch.randn(FIG4_N // FIG4_PARTS, generator=gen, pin_memory=True).mul_(10)
                  for _ in range(FIG4_PARTS)]

    reset_launch_counts()
    fig3 = phase_fig3(dev, progs["stencil"], fig3_hosts)
    fig4 = phase_fig4(dev, progs["partition_map"], fig4_hosts)
    fig5 = phase_fig5(dev, progs["mandelbrot"])
    dev.synchronize()
    launches = launch_counts()
    require(all(launches[n] > 0 for n in FIG_KERNELS), f"a kernel was not launched: {launches}")

    main_image = fig5.pop("image")
    print("fig3: " + json.dumps(fig3), flush=True)
    print("fig4: " + json.dumps(fig4), flush=True)
    print("fig5: " + json.dumps(fig5), flush=True)
    print("launches: " + json.dumps(launches), flush=True)

    dev.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    graph = phase_graph(dev)
    graph["seconds"] = time.perf_counter() - t0
    graph_replayed = graph.pop("_replayed")
    graph["launches"] = {"host": {k: launch_counts()[k] for k in GRAPH_KERNELS},
                         "replayed": graph_replayed}
    require(all(graph["launches"]["host"][k] > 0 and graph_replayed[k] >= GRAPH_REPLAYS
                for k in GRAPH_KERNELS), f"graph: a kernel was not launched: {graph['launches']}")
    print(f"graph: two-chain plan (3 CUDA graphs, one a segment) host us a replay "
          f"{graph['two_chains_host_us_per_replay']:.1f}, device ms "
          f"{graph['two_chains_device_ms_per_replay']:.4f}; the one-graph chain's "
          f"{graph['host_us_per_step']['replay']}", flush=True)
    print("graph: " + json.dumps(graph), flush=True)

    serves = {}
    for phase, arch, prompt_lens, kernel in (("serve", SERVE_ARCH, SERVE_PROMPTS, "flash_attention"),
                                             ("serve_ssm", SSM_ARCH, SSM_PROMPTS, "ssd_scan")):
        t0 = time.perf_counter()
        serve = serves[phase] = phase_serve(dev, arch, prompt_lens, kernel)
        serve["seconds"] = time.perf_counter() - t0
        for g in serve["groups"]:
            print(f"{phase} S={g['prompt']}: near-tie cuts {g['near_tie_cuts']} of {g['batch']} "
                  f"requests; bf16 greedy tokens equal to f32: {g['bf16_tokens_equal_f32']} of "
                  f"{g['tokens']}", flush=True)
        print(f"{phase}: " + json.dumps({k: v for k, v in serve.items() if k != "_plain"}),
              flush=True)
    plain = {base: serves[base].pop("_plain") for base in ("serve", "serve_ssm")}
    for phase, base, arch, prompt_lens in (("serve_paged", "serve", SERVE_ARCH, SERVE_PROMPTS),
                                           ("serve_paged_ssm", "serve_ssm", SSM_ARCH, SSM_PROMPTS)):
        t0 = time.perf_counter()
        paged = serves[phase] = phase_serve_paged(dev, arch, prompt_lens, plain[base])
        paged["seconds"] = time.perf_counter() - t0
        for impl in ("auto", "ref"):
            r = paged[impl]
            print(f"{phase} {impl}: warm counts {r['warm_counts']}, {r['graphs_captured']} graphs "
                  f"captured in {r['capture_s']:.3f} s, padded_rows {r['padded_rows']}, decode steps "
                  f"{r['eager_steps']} eager / {r['replayed_steps']} replayed; step p50/p99 "
                  f"{r['step_ms_p50']:.3f} / "
                  f"{r['step_ms_p99']:.3f} ms, TTFT p50/p99 {r['ttft_p50_s']:.4f} / "
                  f"{r['ttft_p99_s']:.4f} s, {r['decode_tokens_per_s']:.1f} decode tokens/s",
                  flush=True)
        print(f"{phase}: " + json.dumps(paged), flush=True)

    t0 = time.perf_counter()
    fleet = phase_fleet(logical_devices(FLEET_DEVICES),
                        torch.cat([h.to(dev.torch_device, non_blocking=True) for h in fig4_hosts]))
    fleet["seconds"] = time.perf_counter() - t0
    for name, r in fleet["runs"].items():
        print(f"fleet {name}: {r['wall_s']:.4f} s, chunks placed {r['placed']}, {r['steals']} "
              f"steals, {r['spills']} spills, {r['refetches']} refetches", flush=True)
    print("fleet: " + json.dumps(fleet), flush=True)

    reset_launch_counts()
    t0 = time.perf_counter()
    gf = phase_graph_fleet(logical_devices(FLEET_DEVICES))
    gf["seconds"] = time.perf_counter() - t0
    gf_replayed = gf.pop("_replayed")
    gf["launches"] = {"host": {k: launch_counts()[k] for k in GRAPH_KERNELS},
                      "replayed": {k: gf_replayed.get(k, 0) for k in GRAPH_KERNELS}}
    require(all(gf["launches"]["host"][k] > 0
                and gf["launches"]["replayed"][k] >= GRAPH_FLEET_REPLAYS * FLEET_CHUNKS
                for k in GRAPH_KERNELS),
            f"graph_fleet: a kernel was not launched: {gf['launches']}")
    dms, alone = gf["device_ms_per_replay"], gf["device_only_ms_per_replay"]
    host = gf["host_us_per_replay"]
    print(f"graph_fleet: {gf['segments']} segments on {gf['lanes']} lanes over "
          f"{len(gf['devices'])} devices, {gf['transfers']} transfers "
          f"({gf['transfer_bytes_per_replay']} bytes a replay), {gf['event_edges']} event edges "
          f"({gf['cross_device_event_edges']} across devices), {gf['cuda_graphs']} CUDA graphs "
          f"{gf['graphs_by_device']}; host us a replay {host['replay']} against the eager "
          f"run_on_any DAG's {host['eager']} (replay() returns after {host['replay_submit']}); "
          f"device ms a replay {dms['replay']:.4f} against {dms['eager']:.4f}, the device's alone "
          f"{alone['replay']:.4f} against {alone['eager']:.4f}; memory reserved "
          f"{gf['memory_reserved_bytes']} bytes around the fused instantiate; auto chose "
          f"{sorted(set(gf['auto_exec_mode_per_segment']))} for "
          f"{len(gf['auto_exec_mode_per_segment'])} segments", flush=True)
    print("graph_fleet: " + json.dumps(gf), flush=True)

    t0 = time.perf_counter()
    pf = phase_serve_paged_fleet(logical_devices(PAGED_FLEET_DEVICES), plain["serve"])
    pf["seconds"] = time.perf_counter() - t0
    for key, d in pf["per_device"].items():
        print(f"serve_paged_fleet {key}: {d['placed']} sequences placed, {d['spills']} spills, "
              f"{d['refetches']} refetches, {d['stalls']} stalls ({d['deferred_rows']} rows "
              f"deferred), {d['migrations_out']} migrations out, warm counts {d['warm_counts']}, "
              f"{d['graphs_captured']} graphs captured", flush=True)
    print(f"serve_paged_fleet: step p50/p99 {pf['step_ms_p50']:.3f} / {pf['step_ms_p99']:.3f} ms, "
          f"TTFT p50/p99 {pf['ttft_p50_s']:.4f} / {pf['ttft_p99_s']:.4f} s, "
          f"{pf['decode_tokens_per_s']:.1f} decode tokens/s", flush=True)
    print("serve_paged_fleet: " + json.dumps(pf), flush=True)

    dev.synchronize()
    t0 = time.perf_counter()
    engine = phase_engine(dev)
    engine["seconds"] = time.perf_counter() - t0
    ser, eng = engine["serial"], engine["engine"]
    print(f"engine: {engine['requests']} requests of (1, {engine['n']}) f32: serial "
          f"{ser['requests_per_s']:.1f} req/s (p50/p99 {ser['latency_p50_s']:.4f} / "
          f"{ser['latency_p99_s']:.4f} s), engine {eng['requests_per_s']:.1f} req/s (p50/p99 "
          f"{eng['latency_p50_s']:.4f} / {eng['latency_p99_s']:.4f} s, {eng['batches']} "
          f"batches, mean {eng['mean_batch_rows']:.2f} rows, padding_waste "
          f"{eng['padding_waste']:.3f}); buckets {engine['buckets']}; results bit-equal "
          f"{engine['results_bit_equal']} (serial), {engine['results_bit_equal_plain']} (plain); "
          f"partition_map {engine['launches']}", flush=True)
    print("engine: " + json.dumps(engine), flush=True)

    dev.synchronize()
    t0 = time.perf_counter()
    se = phase_serve_engine(dev)
    se["seconds"] = time.perf_counter() - t0
    print(f"serve_engine: {se['requests']} requests of {se['prompt']} tokens, TTFT "
          f"{max(se['ttft_s']):.4f} s, decode {se['decode_ms_p50']:.2f} ms a step p50 "
          f"(device compute {se['decode_compute_ms']:.2f} ms, host share "
          f"{se['host_share_of_step']:.3f}), {se['requests_per_s']:.3f} req/s, prefill "
          f"{se['prefill']['batches']} batches of {se['prefill']['mean_batch_rows']:.1f} rows, "
          f"decode {se['decode']['batches']} batches of {se['decode']['mean_batch_rows']:.1f} "
          f"rows; flash launches {se['launches']['flash_attention']}; fan-out tokens equal "
          f"{se['fanout']['tokens_equal']} of {se['requests']}", flush=True)
    print("serve_engine: " + json.dumps(se), flush=True)

    zoo = {}
    for phase, fn in (("serve_moe", phase_serve_moe), ("serve_paged_moe", phase_serve_paged_moe),
                      ("serve_paged_encdec", phase_serve_paged_encdec),
                      ("serve_paged_hybrid", phase_serve_paged_hybrid)):
        dev.synchronize()
        gc.collect()  # the earlier phases' engines and graphs
        torch.cuda.empty_cache()  # their cached blocks, before 57 GB of weights
        torch.cuda.reset_peak_memory_stats()
        print(f"{phase}: starts with {torch.cuda.memory_allocated()} bytes allocated, "
              f"{torch.cuda.memory_reserved()} reserved", flush=True)
        t0 = time.perf_counter()
        r = zoo[phase] = fn(dev)
        r["seconds"] = time.perf_counter() - t0
        r["max_memory_reserved"] = torch.cuda.max_memory_reserved()
        r["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        print(f"{phase}: {r['arch']} max_memory_reserved {r['max_memory_reserved']} bytes, "
              f"max_memory_allocated {r['max_memory_allocated']} bytes, {r['seconds']:.1f} s",
              flush=True)
        if phase == "serve_moe":
            for g in r["groups"]:
                print(f"serve_moe S={g['prompt']}: pinned routing: logits within "
                      f"{g['max_abs_logit_err_pinned']:.3g}, near-tie cuts "
                      f"{g['near_tie_cuts_pinned']}; unpinned: "
                      f"{g['unpinned_differing_decisions']} routing decisions differ, "
                      f"{g['unpinned_requests_differing']} requests decode other tokens "
                      f"({g['unpinned_near_tie_cuts']} cut at near-ties); bf16 tokens equal to "
                      f"f32: {g['bf16_tokens_equal_f32']} of {g['tokens']}", flush=True)
            rt = r["routing"]
            print(f"serve_moe routing: {rt['differing_decisions']} of {rt['decisions']} decisions "
                  f"differ unpinned (margins {rt['margin_min']} .. {rt['margin_max']}; first "
                  f"differing call's max {rt['first_call_margin_max']}); first ones: "
                  f"{rt['flips'][:MOE_PRINTED_FLIPS]}", flush=True)
        else:
            for impl in ("auto", "ref"):
                x = r[impl]
                print(f"{phase} {impl}: {x['graphs_captured']} graphs, decode steps "
                      f"{x['eager_steps']} eager / {x['replayed_steps']} replayed; step p50/p99 "
                      f"{x['step_ms_p50']:.3f} / {x['step_ms_p99']:.3f} ms, TTFT p50/p99 "
                      f"{x['ttft_p50_s']:.4f} / {x['ttft_p99_s']:.4f} s, "
                      f"{x['decode_tokens_per_s']:.1f} decode tokens/s", flush=True)
        if phase == "serve_paged_hybrid":
            la = r["launches"]["auto"]
            print(f"serve_paged_hybrid: prefill batches (rows, tokens) {r['prefill_batch_shapes']}: "
                  f"flash {la['flash_attention']}, ssd_scan {la['ssd_scan']} calls "
                  f"({la['ssd_scan_kernels']} kernels), paged_attention "
                  f"{la['paged_attention_on_device']} on the device in "
                  f"{r['auto']['decode_steps']} steps; TTFT p50/p99 {r['auto']['ttft_p50_s']:.4f} / "
                  f"{r['auto']['ttft_p99_s']:.4f} s, step p50/p99 {r['auto']['step_ms_p50']:.3f} / "
                  f"{r['auto']['step_ms_p99']:.3f} ms (plain {r['ref']['step_ms_p50']:.3f} / "
                  f"{r['ref']['step_ms_p99']:.3f} ms); KV bytes a request "
                  f"{r['kv_bytes_per_request']}, state {r['state_bytes_per_request']}; near-tie "
                  f"cuts vs the oracle {r['auto']['near_tie_cuts_vs_oracle']} (kernel) / "
                  f"{r['ref']['near_tie_cuts_vs_oracle']} (plain), kernel vs plain "
                  f"{r['near_tie_cuts_kernel_vs_plain']}; peak allocated / reserved "
                  f"{r['max_memory_allocated'] / 1e9:.2f} / {r['max_memory_reserved'] / 1e9:.2f} GB",
                  flush=True)
        print(f"{phase}: " + json.dumps(r), flush=True)

    x3 = torch.from_numpy(fig3_hosts[0]).to(dev.torch_device)
    x4 = fig4_hosts[0].to(dev.torch_device)
    kernels = [check_stencil(x3, launches["stencil"]),
               check_partition_map(x4, launches["partition_map"]),
               check_mandelbrot(dev.torch_device, main_image, launches["mandelbrot"])]
    n_flash = serves["serve"]["launches"]
    cfg = get_config(SERVE_ARCH)
    serve_shape = (SERVE_BATCH, max(SERVE_PROMPTS), cfg.num_heads, cfg.num_kv_heads, cfg.hd)
    # The GQA shape is not on the serve path: its check rides in the bf16
    # entry, and its launch count is left out.
    gqa = check_flash("flash_attention_gqa_bf16", GQA_SHAPE, torch.bfloat16, None,
                      dev.torch_device)
    gqa = {k: v for k, v in gqa.items() if k not in ("route", "source", "replaces", "launches")}
    kernels += [check_flash("flash_attention", serve_shape, torch.float32, n_flash["f32"],
                            dev.torch_device),
                check_flash("flash_attention_bf16", serve_shape, torch.bfloat16, n_flash["bf16"],
                            dev.torch_device, gqa_check=gqa),
                check_ssd(get_config(SSM_ARCH), serves["serve_ssm"]["launches"]["f32"],
                          serves["serve_ssm"]["launches"]["f32_kernels"], dev.torch_device),
                check_paged(serves["serve_paged"]["launches"]["auto"]["paged_attention"],
                            dev.torch_device)]
    kernels[-1]["launches_on_device"] = serves["serve_paged"]["launches"]["auto"][
        "paged_attention_on_device"]
    kernels[-1]["fleet_phase_launches_on_device"] = pf["launches"]["paged_attention_on_device"]
    kernels[1]["fleet_phase_launches"] = fleet["launches"]
    for k in kernels[:2]:  # the graph phases': launched by the host, run by replays
        k["graph_phase_launches"] = {part: graph["launches"][part][k["name"]]
                                     for part in ("host", "replayed")}
        k["graph_fleet_phase_launches"] = {part: gf["launches"][part][k["name"]]
                                           for part in ("host", "replayed")}
    kernels[1]["engine_phase_launches"] = {part: engine["launches"][part]
                                           for part in ("host", "replayed")}
    kernels[3]["engine_phase_launches"] = se["launches"]["flash_attention"]
    encdec_launches = zoo["serve_paged_encdec"]["launches"]["auto"]
    encdec_flash = encdec_launches["flash_attention"]
    encdec_noncausal = encdec_launches["flash_attention_noncausal"]
    kernels[3]["moe_phase_launches"] = {"serve_moe": zoo["serve_moe"]["launches"]["f32"],
                                        "serve_paged_moe": zoo["serve_paged_moe"]["launches"][
                                            "auto"]["flash_attention"]}
    kernels[4]["moe_phase_launches"] = zoo["serve_moe"]["launches"]["bf16"]
    kernels[-1]["moe_phase_launches_on_device"] = zoo["serve_paged_moe"]["launches"]["auto"][
        "paged_attention_on_device"]
    # serve_paged_encdec's shapes (whisper-tiny, f32), each with the launches
    # its phase made there: the encoder's non-causal flash, the decoder's
    # causal prefill at the longer prompt, the decode's paged_attention
    enc = get_config(ENCDEC_ARCH)
    kernels += [check_flash("flash_attention_noncausal", ENCODER_SHAPE, torch.float32,
                            encdec_noncausal, dev.torch_device, causal=False),
                check_flash("flash_attention_encdec_decoder",
                            (SERVE_BATCH, max(ENCDEC_PROMPTS), enc.num_heads, enc.num_kv_heads,
                             enc.hd), torch.float32, encdec_flash - encdec_noncausal,
                            dev.torch_device),
                check_paged_encdec(encdec_launches["paged_attention_on_device"],
                                   dev.torch_device)]
    # serve_paged_hybrid's shapes (Hymba-1.5B, f32), each with the launches
    # its phase made: flash at the longer prompt's prefill batch, ssd_scan
    # there, paged_attention in the global layers' decode
    hyb = get_config(HYBRID_ARCH)
    hyb_launches = zoo["serve_paged_hybrid"]["launches"]["auto"]
    hyb_lens = [hyb.meta_tokens + s for s in HYBRID_PROMPTS]
    kernels += [check_flash("flash_attention_hybrid",
                            (SERVE_BATCH, max(hyb_lens), hyb.num_heads, hyb.num_kv_heads, hyb.hd),
                            torch.float32, hyb_launches["flash_attention"], dev.torch_device),
                check_ssd(hyb, hyb_launches["ssd_scan"], hyb_launches["ssd_scan_kernels"],
                          dev.torch_device, name="ssd_scan_hybrid", prompts=hyb_lens),
                check_paged_hybrid(hyb_launches["paged_attention_on_device"], dev.torch_device)]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
