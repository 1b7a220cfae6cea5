"""Where a training step's time goes in the PyTorch port, on one CUDA card.

    python3 tools/profile_torch_train.py [--arch olmo-1b] [--batch 4] [--seq 2048]
        [--workers N [--devices K] | --mesh]

Builds the step ``chip_smoke.py``'s train phases run (``plan_for`` the
shape, ``make_train_step`` with ``donate=True``, seeded random weights at
full width and depth, one ``SyntheticTokens`` batch), runs 2 steps to warm
up, times 3 on the host (each ends on ``float(loss)``), then runs one under
``torch.profiler`` and prints one JSON line: the host ms a step, and for
each part of the step (``train_step.TRAIN_SPANS``: forward, backward with
its recompute, AdamW) the device ms of the kernels that started in it,
their count and the kernels that take most of it; the step's device ms
and its device idle share (1 - device ms / host ms), peak memory, and the
device ms by kind of kernel (products, the hand-written kernels,
elementwise and the rest, by name).

With ``--workers N`` it profiles one step of the elastic trainer instead
(``training.elastic.ElasticTrainer``, as ``chip_smoke.py``'s
``train_elastic`` phase builds it): N local workers on the card's first
device, or spread over ``--devices K`` logical devices of it, each shard
replayed as a captured graph.  The warm-up steps capture the graphs; the
parts are ``elastic.ELASTIC_SPANS`` (the shards' dispatch, replays and
their wait; the gradient combine; AdamW), and the line adds the graphs
captured and the kernels their replays ran.

With ``--mesh`` the same step runs as ``train(mesh=make_host_mesh(1, 1))``
runs it: params, moments and batch as ``DTensor``s over a one-rank
("data", "model") mesh, under the plan's rules.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from profile_torch_serve import span_device_ms  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core import get_all_devices  # noqa: E402
from repro_torch.data.pipeline import SyntheticTokens  # noqa: E402
from repro_torch.distribution.recipes import plan_for  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.training import elastic  # noqa: E402
from repro_torch.training.elastic import ELASTIC_SPANS, ElasticTrainer  # noqa: E402
from repro_torch.training.optimizer import OptConfig  # noqa: E402
from repro_torch.training.train_step import TRAIN_SPANS, make_init, make_train_step  # noqa: E402

# substrings of kernel names, first match wins: the products (cuBLAS,
# CUTLASS), the port's hand-written kernels, then the rest of PyTorch's
KINDS = (("products", ("gemm", "xmma", "cutlass", "cublas", "nvjet", "sm90_")),
         ("flash_attention", ("flash_fwd",)), ("ssd_scan", ("ssd_",)),
         ("softmax", ("softmax",)), ("reduce", ("reduce", "norm")),
         ("copy_cast", ("copy", "cast")), ("index_scatter", ("index", "scatter", "gather")),
         ("conv", ("conv", "cudnn")), ("elementwise", ("elementwise", "vectorized")))


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def logical_devices(n: int) -> list:
    """``n`` logical devices of the first card (``REPRO_LOGICAL_DEVICES``,
    set around this one discovery)."""
    os.environ["REPRO_LOGICAL_DEVICES"] = str(n)
    try:
        return get_all_devices(1, 0).get()[:n]
    finally:
        os.environ.pop("REPRO_LOGICAL_DEVICES")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--workers", type=int, default=0,
                    help="profile an elastic step over this many local workers")
    ap.add_argument("--devices", type=int, default=0,
                    help="spread the workers over this many logical devices of the card")
    ap.add_argument("--mesh", action="store_true",
                    help="run the step on DTensors over a one-rank device mesh")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_train: needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    _build.load_all()
    cfg = get_config(args.arch)
    shape = ShapeConfig("profile", seq_len=args.seq, global_batch=args.batch, kind="train")
    plan = plan_for(cfg, shape)
    extra = {}
    ctx = contextlib.nullcontext()
    if args.workers:
        spans_of = ELASTIC_SPANS
        trainer = ElasticTrainer(args.arch, use_smoke=False, batch=args.batch, seq=args.seq,
                                 workers=args.workers, total_steps=100, device="cuda",
                                 devices=logical_devices(args.devices) if args.devices else None)
        extra = {"workers": args.workers, "logical_devices": args.devices or 1}
        run = trainer.step
    else:
        spans_of = TRAIN_SPANS
        opt = OptConfig(warmup_steps=1, total_steps=100)
        params, state = make_init(cfg, opt, device="cuda")(0)
        step = make_train_step(cfg, shape, opt, plan, donate=True)
        batch = {k: torch.from_numpy(v).cuda()
                 for k, v in SyntheticTokens(cfg.vocab_size, args.seq, args.batch).batch(0).items()}
        if args.mesh:
            from repro_torch.distribution.sharding import axis_rules
            from repro_torch.launch.mesh import make_host_mesh
            from repro_torch.launch.train import _place

            mesh = make_host_mesh(1, 1)
            ctx = axis_rules(plan.rules, mesh)
            params, state, bsh = _place(mesh, cfg, shape, plan.rules, params, state)
            batch = {k: bsh[k].distribute(v) if k in bsh else v for k, v in batch.items()}
            extra = {"mesh": list(mesh.shape)}

        def run():
            nonlocal params, state
            params, state, metrics = step(params, state, batch)
            loss = metrics["loss"]
            return float(loss.full_tensor() if hasattr(loss, "full_tensor") else loss)

    with ctx:
        for _ in range(2):
            run()
        torch.cuda.reset_peak_memory_stats()
        host = []
        for _ in range(3):
            t0 = time.perf_counter()
            run()
            host.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
        spans = span_device_ms(prof, spans_of, top=8)
        kinds = Counter()
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and e.name not in spans_of:
                kinds[kind_of(e.name)] += e.time_range.elapsed_us() / 1e3
        device_ms = sum(s["device_ms"] for s in spans.values())
        host_ms = sorted(host)[1]
        print(json.dumps({"arch": cfg.name, "params": cfg.param_count(), "batch": args.batch,
                          "seq": args.seq, "remat": plan.remat,
                          "compute_dtype": plan.compute_dtype,
                          "host_ms_per_step": host, "device_ms_per_step": device_ms,
                          "device_idle_share": 1 - device_ms / host_ms,
                          "tokens_per_s": args.batch * args.seq / host_ms * 1e3,
                          "max_memory_allocated": torch.cuda.max_memory_allocated(),
                          "max_memory_reserved": torch.cuda.max_memory_reserved(),
                          "device_ms_by_kind": dict(kinds.most_common()), "spans": spans,
                          **extra}),
              flush=True)
    if args.workers:
        gexecs = [e[0] for e in elastic._GEXECS.values()]
        print(json.dumps({"graphs_captured": len(gexecs),
                          "graph_replays": sum(g.graph_replays for g in gexecs),
                          "recorded_launches": [g.recorded_launches for g in gexecs]}),
              flush=True)
        trainer.close()
    if args.mesh:
        from repro_torch.core.executor import reset_runtime

        reset_runtime()  # destroys the mesh's one-rank group
    return 0


if __name__ == "__main__":
    sys.exit(main())
