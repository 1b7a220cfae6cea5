"""Where the ssd_scan kernel's time goes, on one CUDA card.

    python3 tools/profile_torch_ssd_scan.py [--calls 50]

Builds ``csrc/ssd_scan.cu`` as the port does, and a copy of it with the
other chunk length the kernel takes (64 or 128: the ``L`` constant
edited, built into ``build/ssd_scan_l<chunk>/``), runs each build on
``chip_smoke.ssd_inputs`` (Mamba2-130M's serve shape: Bz 4, S 4000, H 24,
G 1, N 128, P 64) and prints one JSON line per build: the device ms per
call of each of the three kernels (``torch.profiler`` over ``--calls``
calls), their sum, the registers and spills ``ptxas`` reported, the
largest difference from the main build's y and state, and the SM clock
and power that ``nvidia-smi`` read during the window.  Beside each time:
the work the kernel does by its design (``kernel_work``: FMAs of the two
product kernels, bytes of the state pass), as TFLOP/s or TB/s.  Card only.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel  # noqa: E402


def load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_at_chunk(chunk: int) -> "tuple[ctypes.CDLL, str]":
    """``csrc/ssd_scan.cu`` with its chunk length set to ``chunk``, built
    with the port's flags: the library and its ``nvcc`` log."""
    src = (_build.CSRC / "ssd_scan.cu").read_text()
    edited, n = re.subn(r"constexpr int L = \d+;", f"constexpr int L = {chunk};", src)
    if n != 1:
        raise RuntimeError("ssd_scan.cu: no single `constexpr int L = ...;` to edit")
    out = _build.build_dir() / f"ssd_scan_l{chunk}"
    out.mkdir(parents=True, exist_ok=True)
    (out / "ssd_scan.cu").write_text(edited)
    done = subprocess.run([_build._nvcc(), *_build.FLAGS, "-o", str(out / "libssd_scan.so"),
                           str(out / "ssd_scan.cu")], capture_output=True, text=True)
    log = done.stdout + done.stderr
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed for ssd_scan.cu at chunk {chunk}:\n{log}")
    lib = ctypes.CDLL(str(out / "libssd_scan.so"))
    lib.kernel_error_string.argtypes, lib.kernel_error_string.restype = [ctypes.c_int], \
        ctypes.c_char_p
    return lib, log


def kernel_work(Bz: int, S: int, H: int, N: int, P: int, chunk: int) -> dict:
    """What each ssd kernel does at this shape by its design, not the
    bound: FMAs of ssd_chunk_states (N P a token) and ssd_chunk_outputs
    (C.s_in over every row of each chunk; C.B^T over the column groups of
    16 at or below each warp's band of chunk / 8 rows; att.x over the
    rows below the band), and the bytes ssd_state_pass reads and writes
    (each chunk state once each way, cum_last, the final state)."""
    nc, band = -(-S // chunk), chunk // 8
    att = sum(band * 16 * -(-(w + 1) * band // 16) * N for w in range(8))
    intra = sum(band * P * (w + 1) * band for w in range(8))
    return {"ssd_chunk_states": {"fma": Bz * H * S * N * P},
            "ssd_chunk_outputs": {"fma": Bz * H * nc * (chunk * N * P + att + intra)},
            "ssd_state_pass": {"bytes": 4 * Bz * H * (nc * (2 * N * P + 1) + N * P)}}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_ssd_scan: needs a CUDA device", file=sys.stderr)
        return 1
    smoke = load_smoke()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    main_lib = _build.load("ssd_scan")
    chunk = ssd_kernel.chunk_length()
    builds = [(main_lib, smoke.build_log("ssd_scan")), build_at_chunk(192 - chunk)]
    x, dt, A, B, C = smoke.ssd_inputs(smoke.get_config(smoke.SSM_ARCH), "cuda")
    main_out = None
    for lib, log in builds:
        call = lambda: ssd_kernel.ssd_scan(x, dt, A, B, C, lib)  # noqa: E731
        y, state = call()
        if main_out is None:
            main_out = (y, state)
        diff = max(float((y - main_out[0]).abs().max()), float((state - main_out[1]).abs().max()))
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                                "--format=csv,noheader", "-lms", "50"],
                               stdout=subprocess.PIPE, text=True)
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(args.calls):
                    call()
                torch.cuda.synchronize()
        finally:
            smi.terminate()
        samples = [ln for ln in smi.communicate()[0].splitlines() if ln.strip()]
        kernels = {}
        for ev in prof.key_averages():
            for name in smoke.SSD_KERNELS:
                if name in ev.key:
                    kernels[name] = kernels.get(name, 0.0) + ev.device_time_total / 1e3 / args.calls
        chunk = lib.ssd_scan_f32_chunk()
        Bz, S, H, P = x.shape
        work = kernel_work(Bz, S, H, B.shape[3], P, chunk)
        for name, w in work.items():
            ms = kernels.get(name)
            if ms and "fma" in w:
                w["tflops"] = 2 * w["fma"] / ms / 1e9
            elif ms:
                w["TB_per_s"] = w["bytes"] / ms / 1e9
        print(json.dumps({"chunk": chunk, "device_ms": kernels, "work": work,
                          "total_ms": sum(kernels.values()),
                          "ptxas": smoke.ssd_ptxas(log, required=False),
                          "max_abs_diff_vs_main_build": diff,
                          "smi_clock_power_mid_window": samples[len(samples) // 2] if samples
                          else None}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
