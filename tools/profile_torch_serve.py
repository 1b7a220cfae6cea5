"""Where a serving group's time goes in the PyTorch port, on one CUDA card.

    python3 tools/profile_torch_serve.py [--prompt 1000] [--arch olmo-1b]

Runs one group of requests alone through ``chip_smoke.serve_group``, the
serve phase's own flow (prefill, its KV copied into a cache, greedy
decode), at ``chip_smoke.py``'s size, with the seeded random weights of
``--arch`` (OLMo-1B by default; ``qwen2-moe-a2.7b`` is the serve_moe
phase's model) in f32 (TF32 off) and then in bf16, drawn anew for each
dtype after the last one's are freed.  Per dtype it runs the group once
to warm up, once to time on the host, and once under ``torch.profiler``,
and prints one JSON line: the host times of the timed run, and for each part of the
flow (``chip_smoke.SERVE_SPANS``) the device time of the kernels that
started in it and the kernels that take most of it, with the decode's
device idle share (1 - device ms per step / host ms per step).  The group
runs on the calling thread, with its CUDA work on a port stream, so that
the profiler sees its ranges.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import get_all_devices  # noqa: E402
from repro_torch.models import get_model  # noqa: E402


def load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def span_device_ms(prof, spans, top: int = 6) -> dict:
    """For each host range of ``spans`` (in the order recorded): the device
    ms of the kernels and copies that started between its start and the
    next range's, their count, and the ``top`` of them by time."""
    events = prof.events()
    starts = sorted((e.time_range.start, e.name) for e in events
                    if e.name in spans and e.device_type == DeviceType.CPU)
    device = [e for e in events if e.device_type == DeviceType.CUDA and e.name not in spans]
    out = {}
    for i, (start, name) in enumerate(starts):
        end = starts[i + 1][0] if i + 1 < len(starts) else float("inf")
        mine = [e for e in device if start <= e.time_range.start < end]
        by_name = Counter()
        for e in mine:
            by_name[e.name] += e.time_range.elapsed_us() / 1e3
        out[name] = {"device_ms": sum(by_name.values()), "launches": len(mine),
                     "top": [[k[:60], t] for k, t in by_name.most_common(top)]}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--prompt", type=int, default=1000)
    ap.add_argument("--arch", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_serve: needs a CUDA device", file=sys.stderr)
        return 1
    smoke = load_smoke()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = get_all_devices(1, 0).get()[0]
    stream = dev.create_stream()
    cfg = get_config(args.arch or smoke.SERVE_ARCH)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (smoke.SERVE_BATCH, args.prompt),
                                               dtype=np.int32)
    new = smoke.SERVE_NEW

    def group(p, new_tokens):
        with torch.cuda.stream(stream.cuda_stream):
            return smoke.serve_group(dev, stream, cfg, p, prompt, new_tokens, "auto",
                                     time.perf_counter())

    for dtype in (torch.float32, torch.bfloat16):
        gen = torch.Generator(device=dev.torch_device).manual_seed(0)  # the same draws, rounded
        p = get_model(cfg).init(cfg, generator=gen, device=dev.torch_device, dtype=dtype)
        group(p, 2)  # warm-up
        timed = group(p, new)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            group(p, new)
        spans = span_device_ms(prof, smoke.SERVE_SPANS)
        decode = spans[smoke.SERVE_SPANS[-1]]
        decode["device_ms_per_step"] = decode["device_ms"] / new
        decode["device_idle_share"] = 1 - decode["device_ms_per_step"] / timed["decode_ms_per_step"]
        print(json.dumps({"arch": cfg.name, "dtype": str(dtype).split(".")[-1],
                          "batch": smoke.SERVE_BATCH, "prompt": args.prompt, "new_tokens": new,
                          **smoke.serve_times(timed), "on_stream": timed["on_stream"],
                          "spans": spans}), flush=True)
        del p
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
