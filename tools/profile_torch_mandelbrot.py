"""Where the mandelbrot kernel's time goes, on one CUDA card.

    python3 tools/profile_torch_mandelbrot.py [--calls 2000] [--source FILE ...]
        [--grids GX,GY ...]

Runs ``csrc/mandelbrot.cu`` as the port builds it on fig5's image (4096^2,
64 iterations, block (32, 8)) at the main path's grid and at the grids
of ``--grids`` (by default a few other pixels-a-thread choices), and
prints one JSON line for each build and geometry:

- the kernel's device ms per call, from ``torch.profiler`` over
  ``--calls`` calls, and whether the image equals the plain version's;
- the median SM clock and power of the ``nvidia-smi`` samples taken while
  the kernel ran (half a second of calls, then the profiled window);
- the SASS accounting (``sass_accounting``): instructions of one live
  step, one block of steps and one pixel's own code, from
  ``cuobjdump -sass`` of the built library (``chip_smoke.sass``);
- the launch's SIMT efficiency (``chip_smoke.mandelbrot_simt``) and the
  time those counts predict: (warm-up trips x slots a warm-up step + the
  other trips x slots a step + pixels x slots a pixel), over the SIMT
  efficiency x 128 lanes x SMs x the median clock.  The prediction is a
  model: it leaves out latency, the tail of the grid and the stores.

``--source FILE`` adds a build of another source with the same C entry
(such as the parent commit's kernel, for the accounting before a change),
into ``build/mandelbrot_<label>/``.  Its warm-up length and warp placement
are read from its library where it exports them (as
``kernel.block_steps`` and ``kernel.warp_rounds`` read the port's); a library that does not is taken to have no
warm-up and to place threads as the parent's kernel did: warps of 32
threads in order along the block's rows, one pass of the grid-stride loop
for each pixel a thread (``row_order_rounds``, a model).  Card only.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.mandelbrot import kernel as mandel_kernel  # noqa: E402
from repro_torch.kernels.mandelbrot.ref import (  # noqa: E402
    X_RANGE, Y_RANGE, mandelbrot_ref, pixel_step)

FP32_OPS = ("FMUL", "FADD", "FFMA")
DEFAULT_GRIDS = ((128, 512), (128, 64), (32, 64), (32, 128), (64, 64))


def load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def function_sass(text: str, name: str) -> str:
    """The part of ``cuobjdump -sass`` output for the one function whose
    mangled name holds ``name`` (each function's addresses start at 0)."""
    parts = re.split(r"^\s*Function : (\S+)\s*$", text, flags=re.M)
    found = [body for fn, body in zip(parts[1::2], parts[2::2]) if name in fn]
    if len(found) != 1:
        raise RuntimeError(f"{len(found)} functions named like {name} in the SASS")
    return found[0]


def row_order_rounds(height: int, width: int, grid, block, device=None) -> "torch.Tensor":
    """A model of a library that does not report its warp rounds: each
    pixel's warp (32 threads in order, x fastest, in its block) and the
    pass of the 2-D grid-stride loop that reaches it, as one id."""
    (gx, gy), (bx, by) = grid, block
    rows = torch.arange(height, device=device)[:, None]
    cols = torch.arange(width, device=device)[None, :]
    warp = ((rows // by) % gy * gx + (cols // bx) % gx) * -(-(bx * by) // 32) \
        + (rows % by * bx + cols % bx) // 32
    passes = rows // (by * gy) * -(-width // (bx * gx)) + cols // (bx * gx)
    return warp << 32 | passes


def loops(ins) -> "list[tuple[int, int]]":
    """(first, last) index of each loop: a branch back to an address at or
    before its own."""
    at = {addr: i for i, (addr, _, _) in enumerate(ins)}
    out = []
    for i, (addr, op, args) in enumerate(ins):
        m = re.match(r"0x([0-9a-f]+)", args)
        if op.split(".")[0] == "BRA" and m and int(m.group(1), 16) <= addr:
            out.append((at[int(m.group(1), 16)], i))
    return out


def sass_accounting(ins) -> dict:
    """Instruction slots of the kernel's parts, read from its instructions
    (``chip_smoke.sass_instructions``):

    - ``step``: the innermost loop with the most FP32 operations (the
      block of steps, or the parent's one-step loop), its instructions
      over its steps (FP32 operations / 8); ``block``: its instructions;
    - ``warm_up_step``: in the pixel loop (the smallest loop around it),
      the instructions from the first test (``FSETP``) before the step
      loop to the step loop, over those tests;
    - ``escape``: the instructions a block's escape runs to find the
      first failing step: from the target of the step loop's exit branch
      to the next reconvergence (``BSYNC``);
    - ``pixel``: the pixel loop's other instructions, outside every loop
      inside it: coordinates, the store, the loop's own counter."""
    def is_fp(i):
        return ins[i][1].split(".")[0] in FP32_OPS

    lps = loops(ins)
    innermost = [lp for lp in lps if not any(lp[0] <= a and b <= lp[1] and (a, b) != lp
                                             for a, b in lps)]
    step_loop = max(innermost, key=lambda lp: sum(is_fp(i) for i in range(lp[0], lp[1] + 1)))
    first, last = step_loop
    steps = max(round(sum(is_fp(i) for i in range(first, last + 1)) / 8), 1)
    around = [lp for lp in lps if lp[0] <= first and lp[1] >= last and lp != step_loop]
    pixel = min(around, key=lambda lp: lp[1] - lp[0])
    inner = [lp for lp in lps if pixel[0] <= lp[0] and lp[1] <= pixel[1] and lp != pixel]
    in_inner = {i for a, b in inner for i in range(a, b + 1)}
    tests = [i for i in range(pixel[0], first) if i not in in_inner
             and ins[i][1].startswith("FSETP")]
    warm = (first - tests[0]) / len(tests) if tests else 0.0
    escape = set()
    for i in range(first, last + 1):
        m = re.match(r"0x([0-9a-f]+)", ins[i][2])
        if ins[i][1] == "BRA" and m and int(m.group(1), 16) > ins[last][0]:
            j = next(k for k, (a, _, _) in enumerate(ins) if a == int(m.group(1), 16))
            while j <= pixel[1] and not ins[j][1].startswith("BSYNC") and j not in in_inner:
                escape.add(j)
                j += 1
    own = [i for i in range(pixel[0], pixel[1] + 1) if i not in in_inner and i not in escape]
    return {"step": (last - first + 1) / steps, "block": last - first + 1, "block_steps": steps,
            "warm_up_step": warm, "warm_up_tests": len(tests), "escape": len(escape),
            "pixel": len(own) - warm * len(tests)}


def predicted_ms(acc: dict, counts: "torch.Tensor", K0: int, simt: float, sms: int,
                 mhz: float) -> float:
    """The time the SASS counts predict at ``mhz``: trips over the warm-up's
    first ``K0`` steps at the warm-up step's slots (none where the kernel
    has no warm-up), the other trips at the step's, each pixel at the
    pixel's, over SIMT efficiency x 128 lanes x SMs x the clock."""
    c = counts.to(torch.int64)
    warm_trips = int(torch.clamp(c, max=K0).sum()) if acc["warm_up_tests"] else 0
    slots = (warm_trips * acc["warm_up_step"] + (int(c.sum()) - warm_trips) * acc["step"]
             + c.numel() * acc["pixel"])
    return slots / (simt * 128 * sms * mhz * 1e6) * 1e3


def library_rounds(lib: "ctypes.CDLL", height: int, width: int, grid,
                   block) -> "torch.Tensor | None":
    """The warp rounds a library reports (``mandelbrot_warp_rounds``, as
    ``kernel.warp_rounds`` reads the port's), or None where it has none."""
    if not hasattr(lib, "mandelbrot_warp_rounds"):
        return None
    fn = lib.mandelbrot_warp_rounds
    fn.argtypes, fn.restype = mandel_kernel._ROUNDS_ARGS, ctypes.c_int
    out = torch.empty((height, width), dtype=torch.int64, device="cuda")
    err = fn(out.data_ptr(), height, width, *grid, *block, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"mandelbrot_warp_rounds: CUDA error {err}")
    return out


def build_copy(label: str, src: str) -> "tuple[ctypes.CDLL, Path]":
    """``src`` built with the port's flags into ``build/mandelbrot_<label>/``."""
    out = _build.build_dir() / f"mandelbrot_{label}"
    out.mkdir(parents=True, exist_ok=True)
    (out / "mandelbrot.cu").write_text(src)
    done = subprocess.run([_build._nvcc(), *_build.FLAGS, "-o", str(out / "libmandelbrot.so"),
                           str(out / "mandelbrot.cu")], capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed for the {label} copy:\n{done.stdout}{done.stderr}")
    (out / "build.log").write_text(done.stdout + done.stderr)
    return ctypes.CDLL(str(out / "libmandelbrot.so")), out / "libmandelbrot.so"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=2000)
    ap.add_argument("--source", action="append", default=[])
    ap.add_argument("--grids", nargs="*", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_mandelbrot: needs a CUDA device", file=sys.stderr)
        return 1
    smoke = load_smoke()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    h = w = smoke.FIG5_SIZE
    it = smoke.FIG5_ITERS
    block = smoke.MANDEL_BLOCK.as_tuple()[:2]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    main_grid = mandel_kernel.geometry(h, w, block, sms=sms)[:2]
    grids = [main_grid] + [g for g in (tuple(int(v) for v in s.split(",")) for s in args.grids)
                           if g != main_grid] if args.grids is not None else \
        [main_grid] + [g for g in DEFAULT_GRIDS if g != main_grid]

    builds = [("port", _build.load("mandelbrot"), _build._target("mandelbrot"))]
    for src in args.source:
        lib, path = build_copy(Path(src).stem, Path(src).read_text())
        builds.append((Path(src).stem, lib, path))

    with profile(activities=[ProfilerActivity.CUDA]):  # its first start is slow
        torch.cuda.synchronize()
    want = mandelbrot_ref(h, w, it, device="cuda")
    out = torch.empty((h, w), dtype=torch.int32, device="cuda")
    for label, lib, path in builds:
        lib.mandelbrot_i32.argtypes = mandel_kernel._ARGS
        lib.mandelbrot_i32.restype = ctypes.c_int
        K0 = lib.mandelbrot_warm_up_steps() if hasattr(lib, "mandelbrot_warm_up_steps") else 0
        code = function_sass(smoke.sass(path), "mandelbrot_kernel")
        acc = sass_accounting(smoke.sass_instructions(code))
        for grid in grids:
            def call():
                err = lib.mandelbrot_i32(
                    out.data_ptr(), h, w, it, X_RANGE[0], Y_RANGE[0], pixel_step(*X_RANGE, w),
                    pixel_step(*Y_RANGE, h), grid[0], grid[1], block[0], block[1],
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"mandelbrot ({label}): CUDA error {err}")
            out.fill_(-1)
            call()
            equal = bool(torch.equal(out, want))
            for _ in range(3):
                call()
            torch.cuda.synchronize()
            smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                                    "--format=csv,noheader,nounits", "-lms", "20"],
                                   stdout=subprocess.PIPE, text=True)
            try:
                # keep the card busy while the first samples come in
                t0 = time.perf_counter()
                while time.perf_counter() - t0 < 0.5:
                    call()
                    torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(args.calls):
                        call()
                    torch.cuda.synchronize()
            finally:
                smi.terminate()
            lines = [ln.split(",") for ln in smi.communicate()[0].splitlines() if "," in ln]
            samples = sorted((float(a), float(b)) for a, b in lines)
            mhz, watts = samples[len(samples) // 2] if samples else (None, None)
            kern = [ev for ev in prof.key_averages() if "mandelbrot_kernel" in ev.key]
            n = sum(ev.count for ev in kern)
            ms = sum(ev.device_time_total for ev in kern) / 1e3 / n if n else None
            rounds = library_rounds(lib, h, w, grid, block)
            simt = smoke.mandelbrot_simt(
                want, row_order_rounds(h, w, grid, block, "cuda") if rounds is None else rounds)
            pred = predicted_ms(acc, want, K0, simt, sms, mhz) if mhz else None
            print(json.dumps({
                "build": label, "grid": list(grid), "block": list(block),
                "pixels_a_thread": h * w / (grid[0] * grid[1] * block[0] * block[1]),
                "equal_to_plain": equal, "device_ms": ms, "kernels_profiled": n,
                "sm_mhz": mhz, "power_w": watts, "smi_samples": len(samples), "sass": acc,
                "simt_efficiency": simt, "simt_from": "model" if rounds is None else "library",
                "predicted_ms": pred,
                "predicted_over_measured": pred / ms if pred and ms else None}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
