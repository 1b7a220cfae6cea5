"""Where a parcel-route training step spends its host time: the parcel
codec and the copies around it, at a model's full parameter size.

The elastic trainer's parcel route (``ElasticTrainer(port=...)``) ships a
worker its shard as one ``invoke`` parcel carrying every f32 param leaf,
and the worker replies with every f32 grad leaf.  This script times, on
the model's params (seeded random values of its shapes), each copy that
route makes one way:

  d2h      the driver's params to host arrays (``parcel.host_value``)
  dumps    encoding them (``parcel.dumps``: with the shared-memory lane,
           a copy into a fresh segment; inline, into the blob)
  loads    decoding them on the other side (a copy out of the segment or
           the blob)
  h2d      the decoded arrays onto the card (a pageable copy, as the
           shard graph's feeds are)

each the median of ``--reps`` runs after one warm-up, with and without the
shared-memory lane.  It prints one JSON line.  Card only (the d2h and h2d
rows need CUDA).

    python3 tools/profile_torch_parcel.py [--arch mamba2-130m] [--reps 5]
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import parcel  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.pytree import tree_flatten  # noqa: E402
from repro_torch.training.elastic import _shape_tree  # noqa: E402


def timed(fn, reps: int) -> "tuple[float, object]":
    out = fn()  # warm-up
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts), out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_parcel: needs a CUDA card", file=sys.stderr)
        return 1
    cfg = get_config(args.arch)
    shapes = tree_flatten(_shape_tree(get_model(cfg).param_shapes(cfg)))[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = [torch.randn(tuple(s), generator=gen, device="cuda") for s in shapes]
    nbytes = sum(p.numel() * 4 for p in params)
    d2h, host = timed(lambda: [parcel.host_value(p) for p in params], args.reps)
    out = {"arch": cfg.name, "leaves": len(params), "bytes": nbytes,
           "shm_min_bytes": parcel._SHM_MIN, "d2h_s": d2h}
    for lane in ("shm", "inline"):
        if lane == "shm" and not parcel.shm_available():
            out[lane] = "no shared memory"
            continue

        def round_trip(lane=lane):
            """dumps, then loads (which consumes the dumps' segments)."""
            t0 = time.perf_counter()
            blob = parcel.dumps({"params": host}, shm_sink=[] if lane == "shm" else None)
            t1 = time.perf_counter()
            dec = parcel.loads(blob)
            return t1 - t0, time.perf_counter() - t1, dec

        runs = []
        for i in range(args.reps + 1):  # the first is a warm-up
            t_dumps, t_loads, decoded = round_trip()
            if i:
                runs.append((t_dumps, t_loads))
        dumps_s = statistics.median(r[0] for r in runs)
        loads_s = statistics.median(r[1] for r in runs)
        h2d_s, _ = timed(lambda: [torch.from_numpy(a).to("cuda") for a in decoded["params"]]
                         + [torch.cuda.synchronize()], args.reps)
        one_way = d2h + dumps_s + loads_s + h2d_s
        out[lane] = {"dumps_s": dumps_s, "loads_s": loads_s, "h2d_s": h2d_s,
                     "one_way_s": one_way, "GBps_one_way": nbytes / one_way / 1e9}
    out["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True, text=True,
                                 timeout=60).stdout.strip()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
