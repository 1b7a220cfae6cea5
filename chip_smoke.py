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
        ``async_``.

Every kernel is built from ``src/repro_torch/kernels/csrc`` first (one
``nvcc`` per source, all started together).  The launch counters are set to
0 just before the three phases and read just after; a kernel the main path
did not launch fails the run.  Then each kernel is held against its plain
PyTorch version on the card at the main path's shapes and timed beside its
bound.  The script prints the ``kernels`` JSON line, the card's name and
power limit, and, last, ``{"ok": true, "device": {...}}``.  It exits
non-zero, printing no result, without CUDA or outside a checkout of the
repository.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import Dim3, async_, dataflow, get_all_devices, wait_all  # noqa: E402
from repro_torch.kernels import _build, launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.kernels.mandelbrot import kernel as mandel_kernel  # noqa: E402
from repro_torch.kernels.mandelbrot.ref import mandelbrot_ref  # noqa: E402
from repro_torch.kernels.partition_map import kernel as map_kernel  # noqa: E402
from repro_torch.kernels.partition_map.ref import partition_map_ref  # noqa: E402
from repro_torch.kernels.stencil import kernel as stencil_kernel  # noqa: E402
from repro_torch.kernels.stencil.ref import stencil_ref  # noqa: E402

KERNEL_DIR = ROOT / "src" / "repro_torch" / "kernels"

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM3 bytes/s and
# f32 FLOP/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

FIG3_N, FIG3_INPUTS = 1 << 26, 4
FIG4_N, FIG4_PARTS = 1 << 28, 4
FIG5_SIZE, FIG5_ITERS, FIG5_IMAGES = 4096, 64, 4
STENCIL_BLOCK = Dim3(256)
MAP_BLOCK = Dim3(256)
MANDEL_BLOCK = Dim3(32, 8)


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


def bound(nbytes: float, flops: float) -> "tuple[float, str]":
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
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


def check_mandelbrot(dev, main_image: np.ndarray, launches: int) -> dict:
    blk = MANDEL_BLOCK.as_tuple()
    h = w = FIG5_SIZE
    run = lambda: mandel_kernel.mandelbrot(h, w, FIG5_ITERS, device=dev, block=blk)  # noqa: E731
    got = run()
    want = mandelbrot_ref(h, w, FIG5_ITERS, device=dev)
    differing = int((got != want).sum())
    require(differing == 0, f"mandelbrot: {differing} pixels differ from the plain version")
    require(np.array_equal(got.cpu().numpy(), main_image), "mandelbrot: main path image differs")
    flops = mandelbrot_flops(got, FIG5_ITERS)
    return entry("mandelbrot", "src/repro_torch/kernels/csrc/mandelbrot.cu",
                 "src/repro/kernels/mandelbrot/kernel.py:44", launches,
                 float((got - want).abs().max()), cuda_ms(run, 10),
                 cuda_ms(lambda: mandelbrot_ref(h, w, FIG5_ITERS, device=dev), 2),
                 bound(4 * h * w, flops), None, differing_pixels=differing, flops=flops)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; the port's main path needs a card",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()

    t0 = time.perf_counter()
    _build.load_all()  # one nvcc per source, all started together
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.2f} s for {len(_build.NAMES)} libraries", flush=True)

    devices = get_all_devices(1, 0).get()  # Listing 1
    require(len(devices) >= 1 and devices[0].platform == "cuda", "no CUDA device discovered")
    dev = devices[0]
    progs = {name: dev.create_program_with_file(str(KERNEL_DIR / name / "ops.py"))
             for name in _build.NAMES}
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
    require(all(launches[n] > 0 for n in _build.NAMES), f"a kernel was not launched: {launches}")

    main_image = fig5.pop("image")
    print("fig3: " + json.dumps(fig3), flush=True)
    print("fig4: " + json.dumps(fig4), flush=True)
    print("fig5: " + json.dumps(fig5), flush=True)
    print("launches: " + json.dumps(launches), flush=True)

    x3 = torch.from_numpy(fig3_hosts[0]).to(dev.torch_device)
    x4 = fig4_hosts[0].to(dev.torch_device)
    kernels = [check_stencil(x3, launches["stencil"]),
               check_partition_map(x4, launches["partition_map"]),
               check_mandelbrot(dev.torch_device, main_image, launches["mandelbrot"])]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
