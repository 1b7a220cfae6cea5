"""Where a batched paged decode step's time goes in the PyTorch port, on one
CUDA card: the step replayed as a CUDA graph against the same step run
eagerly.

    python3 tools/profile_torch_serve_paged.py [--arch olmo-1b] [--steps 16]

Sets up ``chip_smoke.py``'s ``serve_paged`` requests (the serve phase's 8
prompts and seeded f32 weights, TF32 off) in one
``PagedServeEngine.from_config`` engine: each group of 4 prefilled in one
call of the engine's prefill and paged in with ``PagedKVCache.append``.
Then it drives the decode lane on the calling thread over all 8 resident
requests, so that ``torch.profiler`` never runs beside the engine's lane
threads, two ways on the same requests:

  replay  the lane's own ``_step``: at the warm count 8 a replay of the
          step's CUDA graph (its first call ran eagerly and captured it);
  eager   the same step's inputs through an eager ``decode_fn`` call
          (``_prepare``, ``_eager``, ``_advance``: what ``_step`` ran before
          the graphs), which launches every kernel from the host.

Each way: a few steps to warm up, ``--steps`` timed on the host (each ends
with the logits on the host), ``--steps`` under the profiler (device
activity only), in turns (replay, eager, eager, replay).  Prints one JSON
line per way: host ms per step, device ms per step, the launches the host
issued (``cudaLaunchKernel``/``cudaLaunchKernelExC``/``cudaGraphLaunch``
calls the profiler saw) and the kernels the device ran per step, the
device idle share (1 - device ms / host ms), the paged_attention kernel's
device ms a step and its kernels a step, and the kernels that take most of
the time.  The replay line also carries the graph's recorded launches (the
count the smoke multiplies by the replays), which its paged_attention
kernels per step must equal.  ``--arch mamba2-130m`` profiles the
``serve_paged_ssm`` requests instead, ``--arch qwen2-moe-a2.7b`` the
``serve_paged_moe`` ones, ``--arch hymba-1.5b`` the ``serve_paged_hybrid``
ones (prompts of 700 and 2000 tokens behind 128 meta tokens: paged_attention
on the 3 global layers, the 16 SWA producers' rings gathered from the pages
in plain PyTorch).
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
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
from repro_torch.core import Promise, get_all_devices  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.serving import PagedServeEngine  # noqa: E402
from repro_torch.serving.paged import _PagedRequest  # noqa: E402

# Runtime calls that put work on the device: a kernel, or a whole graph.
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch", "cuGraphLaunch")


def load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--steps", type=int, default=16)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_serve_paged: needs a CUDA device", file=sys.stderr)
        return 1
    smoke = load_smoke()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = get_all_devices(1, 0).get()[0]
    cfg = get_config(args.arch)
    m = get_model(cfg)
    gen = torch.Generator(device=dev.torch_device).manual_seed(0)
    params = m.init(cfg, generator=gen, device=dev.torch_device)
    lens = {"ssm": smoke.SSM_PROMPTS, "hybrid": smoke.HYBRID_PROMPTS}.get(cfg.family,
                                                                         smoke.SERVE_PROMPTS)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=(smoke.SERVE_BATCH, s), dtype=np.int32)
               for s in lens]
    spec = m.paged_spec(cfg)
    steps = 8 + 4 * args.steps
    meta = cfg.meta_tokens  # a hybrid's meta tokens page in with the prompt
    eng = PagedServeEngine.from_config(
        cfg, params=params, devices=[dev],
        max_seq_len=1 << (meta + max(lens) + steps + 1).bit_length(),
        pool_pages=2 + sum(smoke.SERVE_BATCH * spec.pages_for(meta + s + steps) for s in lens),
        name="profile")
    try:
        reqs = []
        with eng._on_stream():
            for p in prompts:  # one prefill call per group, as the engine's prefill lane
                k, v, state, logits = eng.prefill_fn(torch.from_numpy(p).to(dev.torch_device),
                                                     None)
                for i, row in enumerate(p):
                    r = _PagedRequest(row, steps + 2, Promise(), time.monotonic(), rid=len(reqs))
                    r.seq = eng.kv.new_seq(dev)
                    eng.kv.append(r.seq, k[i], v[i])
                    if state is not None:
                        r.seq.set_state({n: t[i] for n, t in state.items()})
                    r.out.append(int(torch.argmax(logits[i])))
                    reqs.append(r)
                del k, v, state
        lane = eng._lane_for(dev)

        def eager_step():
            prep = lane._prepare(reqs)
            with lane._on_stream():
                for r in prep[0]:
                    r.seq._wait_ready()
                logits, state = lane._eager(*prep[1])
            lane._advance(prep[0], prep[1][0], logits, state, time.monotonic())

        ways = {"replay": lambda: lane._step(reqs), "eager": eager_step}
        for _ in range(4):  # warm-up (capture at count 8), the profiler's first start included
            for step in ways.values():
                with profile(activities=[ProfilerActivity.CUDA]):
                    step()
        host_ms = {k: [] for k in ways}
        traces = {k: [] for k in ways}
        for name in ("replay", "eager", "eager", "replay"):
            step = ways[name]
            for _ in range(args.steps // 2):
                t0 = time.perf_counter()
                step()  # ends with the logits on the host
                host_ms[name].append((time.perf_counter() - t0) * 1e3)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(args.steps // 2):
                    step()
                torch.cuda.synchronize()
            traces[name].append(prof)
        recorded = dict(lane._graphs._counts[len(reqs)].recorded)
        decode = eng.metrics()["decode"]
    finally:
        eng.close()
    n = 2 * (args.steps // 2)
    for name in ways:
        device, host_launches = [], 0
        for prof in traces[name]:
            evs = prof.events()
            device += [e for e in evs if e.device_type == DeviceType.CUDA]
            host_launches += sum(1 for e in evs if e.device_type != DeviceType.CUDA
                                 and e.name.startswith(LAUNCH_CALLS))
        kernels = [e for e in device if not e.name.startswith(("Memcpy", "Memset"))]
        by_name = Counter()
        for e in device:
            by_name[e.name] += e.time_range.elapsed_us() / 1e3
        device_ms = sum(by_name.values()) / n
        paged = [e for e in kernels if "paged_decode" in e.name]
        paged_ms = sum(e.time_range.elapsed_us() for e in paged) / 1e3 / n
        step_ms = statistics.median(host_ms[name])
        row = {"arch": cfg.name, "way": name, "rows": len(reqs), "prompts": list(lens),
               "host_ms_per_step_median": step_ms, "host_ms_per_step": host_ms[name],
               "device_ms_per_step": device_ms,
               "host_launches_per_step": host_launches / n,
               "device_kernels_per_step": len(kernels) / n,
               "device_ops_per_step": len(device) / n,
               "device_idle_share": 1 - device_ms / step_ms,
               "paged_attention_ms_per_step": paged_ms,
               "paged_attention_kernels_per_step": len(paged) / n,
               "top_ms_per_step": [[k[:60], t / n] for k, t in by_name.most_common(12)]}
        if name == "replay":
            row.update(graph_recorded_launches=recorded, decode=decode)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
