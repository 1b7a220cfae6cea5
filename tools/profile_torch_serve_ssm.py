"""Where a Mamba2-130M serving group's time goes in the PyTorch port, on
one CUDA card.

    python3 tools/profile_torch_serve_ssm.py [--prompt 4000]

What ``tools/profile_torch_serve.py`` does for OLMo-1B, for
``chip_smoke.py``'s ``serve_ssm`` arch, set up as ``chip_smoke.phase_serve``
sets up the served path: TF32 off for matmuls and cuDNN, and the bf16
params drawn from the same seed in bf16 (A_log, D and dt_bias stay f32).
One group of requests alone through ``chip_smoke.serve_group`` (prefill,
greedy decode from the prefill's own cache), f32 and then bf16: run once
to warm up, once to time on the host, and once under ``torch.profiler``.
One JSON line per dtype with the host times, the device ms per part of
the flow (``chip_smoke.SERVE_SPANS``), the kernels that take most of it
and the decode's device idle share.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import get_all_devices  # noqa: E402
from repro_torch.models import get_model  # noqa: E402


def load_tool():
    spec = importlib.util.spec_from_file_location("profile_torch_serve",
                                                  ROOT / "tools" / "profile_torch_serve.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--prompt", type=int, default=4000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_serve_ssm: needs a CUDA device", file=sys.stderr)
        return 1
    tool = load_tool()
    smoke = tool.load_smoke()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = get_all_devices(1, 0).get()[0]
    stream = dev.create_stream()
    cfg = get_config(smoke.SSM_ARCH)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (smoke.SERVE_BATCH, args.prompt),
                                               dtype=np.int32)
    new = smoke.SERVE_NEW

    def group(p, new_tokens):
        with torch.cuda.stream(stream.cuda_stream):
            return smoke.serve_group(dev, stream, cfg, p, prompt, new_tokens, "auto",
                                     time.perf_counter())

    for dtype in (torch.float32, torch.bfloat16):
        gen = torch.Generator(device=dev.torch_device).manual_seed(0)
        p = get_model(cfg).init(cfg, generator=gen, device=dev.torch_device, dtype=dtype)
        group(p, 2)  # warm-up
        timed = group(p, new)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            group(p, new)
        spans = tool.span_device_ms(prof, smoke.SERVE_SPANS)
        decode = spans[smoke.SERVE_SPANS[-1]]
        decode["device_ms_per_step"] = decode["device_ms"] / new
        decode["device_idle_share"] = 1 - decode["device_ms_per_step"] / timed["decode_ms_per_step"]
        print(json.dumps({"arch": cfg.name, "dtype": str(dtype).split(".")[-1],
                          "batch": smoke.SERVE_BATCH, "prompt": args.prompt, "new_tokens": new,
                          **smoke.serve_times(timed), "on_stream": timed["on_stream"],
                          "spans": spans}), flush=True)
        del p
    return 0


if __name__ == "__main__":
    sys.exit(main())
