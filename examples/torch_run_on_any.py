"""Scheduler-routed launches, "any kernel on any device" (the PyTorch port
of ``examples/run_on_any.py``).

Splits the first card into 4 logical devices (``REPRO_LOGICAL_DEVICES=4``,
the counterpart of the reference's forced host devices), then drives the
fig6 partition map through ``Program.run_on_any`` under each placement
policy, and once more with a per-device memory limit that makes the
scheduler spill cold buffers to host memory and the launches refetch them.
Every result is checked bit-equal to one device's.  Last, a graph recorded
through ``run_on_any`` over two of the devices is replayed through one
future (a segment a device, a transfer step between them).  Without a card it runs
on the CPU's logical devices, with the plain version of the kernel.

    python3 examples/torch_run_on_any.py [--n 4194304] [--chunks 16]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import (Scheduler, capture, get_all_devices, get_all_localities,  # noqa: E402
                              wait_all)
from repro_torch.kernels.partition_map.ops import partition_map  # noqa: E402


def main(n: int = 1 << 22, chunks: int = 16) -> int:
    os.environ.setdefault("REPRO_LOGICAL_DEVICES", "4")
    platform = "cuda" if torch.cuda.is_available() else "cpu"
    devices = get_all_devices(1, 0, platform=platform).get()
    print(f"fleet: {devices}")
    print(f"localities: {get_all_localities(1, 0, platform=platform).get()}")
    x = torch.randn(n, generator=torch.Generator().manual_seed(0)).mul_(100)
    parts = list(x.to(devices[0].torch_device).chunk(chunks))
    want = [partition_map(p) for p in parts]
    prog = devices[0].create_program({"partition_map": partition_map}, "partition").get()
    # chunks as buffers spread round-robin: affinity follows the AGAS
    # placement records (no copy); other policies pay a copy when they
    # place a chunk away from its home
    bufs = [devices[i % len(devices)].create_buffer_from(p).get() for i, p in enumerate(parts)]

    def pipeline(sched):
        futs = [prog.run_on_any([b], "partition_map", scheduler=sched) for b in bufs]
        got = [f.get() for f in futs]
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise SystemExit(f"{sched.policy.name}: a chunk differs from one device's result")

    for policy in ("static", "round_robin", "least_loaded", "affinity"):
        sched = Scheduler(devices, policy=policy, steal=False)
        pipeline(sched)  # warm-up: builds each sibling program the policy reaches
        t0 = time.perf_counter()
        pipeline(sched)
        print(f"{policy:>13}: {(time.perf_counter() - t0) * 1e3:8.2f} ms  placements={sched.stats()}")

    sched = Scheduler(devices)  # least_loaded with the steal pool
    pipeline(sched)
    print(f"{'stealing':>13}: steals={sched.steal_stats()['steals']} placements={sched.stats()}")

    for d in devices:  # three chunks a device fit; the fourth spills
        d.memory_limit = 3 * bufs[0].nbytes
    pipeline(Scheduler(devices, steal=False))
    print(f"{'memory limit':>13}: {sum(d.spills for d in devices)} buffers spilled, "
          f"{sum(d.refetches for d in devices)} refetched, results bit-equal")
    wait_all([b.free() for b in bufs])

    # capture a graph over two devices through run_on_any; a replay is ONE
    # future (a segment a device, a transfer step between them)
    d0, d1 = devices[0], devices[1]
    prog2 = d0.create_program({"inc": lambda x: x + 1.0, "scale": lambda x: x * 3.0}, "g").get()
    b_in = d0.create_buffer(16, np.float32).get()
    t_mid = d0.create_buffer(16, np.float32).get()
    t_out = d1.create_buffer(16, np.float32).get()
    rr = Scheduler([d0, d1], policy="round_robin")
    with capture("xdev") as g:
        b_in.enqueue_write(0, np.ones(16, np.float32))
        prog2.run_on_any([b_in], "inc", out=[t_mid], scheduler=rr)
        prog2.run_on_any([t_mid], "scale", out=[t_out], scheduler=rr)
        r = t_out.enqueue_read()
    exe = g.instantiate()
    print(exe)  # 2 segments, 1 transfer, 1 event edge, fan-out
    res = exe.replay().get()
    print(f"graph result: {res[r][:4]} ... (expect 6.0 = (1+1)*3)")
    if not np.array_equal(res[r], np.full(16, 6.0, np.float32)):
        raise SystemExit("the captured graph over two devices gave a wrong result")
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 22, help="f32 elements in all")
    ap.add_argument("--chunks", type=int, default=16, help="launches a run")
    args = ap.parse_args()
    sys.exit(main(args.n, args.chunks))
