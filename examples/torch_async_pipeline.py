"""Partition pipeline (paper Fig. 4) as a reusable pattern (the PyTorch port
of ``examples/async_pipeline.py``).

Slices a vector into partitions and streams each through H2D copy ->
kernel -> D2H copy, with the three stages of different partitions
overlapping through the future graph.  The kernel is the hand-written
``partition_map`` CUDA kernel, where the reference runs its plain version.
Prints synchronous and futurized timings, and checks that the futurized
results equal the synchronous ones.  It runs on the card; ``--cpu`` runs it
on the CPU device instead (the kernel's plain version).

    python3 examples/torch_async_pipeline.py [--cpu]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import get_all_devices, wait_all  # noqa: E402
from repro_torch.kernels.partition_map.ops import partition_map  # noqa: E402


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(cpu: bool = False, n: int = 1 << 23, parts: int = 4) -> int:
    # n defaults large: each partition's work must dwarf the host's cost of
    # a future's hop (paper: "negligible ... for large enough vector sizes")
    devices = get_all_devices(1, 0, platform="cpu" if cpu else "cuda").get()
    if not devices:
        print("no CUDA device: pass --cpu to run on the CPU", file=sys.stderr)
        return 1
    dev = devices[0]
    tdev = dev.torch_device
    prog = dev.create_program({"k": partition_map}, "pipeline").get()
    hosts = np.array_split(np.random.default_rng(0).normal(size=(n,)).astype(np.float32), parts)
    hosts = [np.ascontiguousarray(h) for h in hosts]

    # warm-up both paths (the kernel's build happens here, asynchronously)
    futs = [dev.create_buffer_from(h) for h in hosts]
    wait_all([f.then(lambda b: prog.run([b], "k", out=[b]).get()) for f in futs])
    partition_map(torch.from_numpy(hosts[0]).to(tdev))
    _sync(tdev)

    # --- fully synchronous reference
    t0 = time.perf_counter()
    want = []
    for h in hosts:
        x = torch.from_numpy(h).to(tdev)
        _sync(tdev)
        y = partition_map(x)
        _sync(tdev)
        want.append(y.cpu().numpy())
    t_sync = time.perf_counter() - t0

    # --- futurized pipeline: stages overlap across partitions
    t0 = time.perf_counter()
    reads = []
    for h in hosts:
        buf = dev.create_buffer_from(h)  # async H2D
        ran = buf.then(lambda b: prog.run([b], "k", out=[b]).get())  # async launch
        reads.append(ran.then(lambda bl: bl[0].enqueue_read().get()))  # async D2H
    wait_all(reads)
    t_async = time.perf_counter() - t0

    print(f"partitions={parts} n={n} on {dev.key}")
    print(f"synchronous: {t_sync * 1e3:8.2f} ms")
    print(f"futurized:   {t_async * 1e3:8.2f} ms   ({(t_sync - t_async) / t_sync:+.1%})")
    if not all(np.array_equal(np.asarray(r.get()), w) for r, w in zip(reads, want)):
        print("futurized results differ from the synchronous ones", file=sys.stderr)
        return 1
    print("futurized results equal the synchronous ones")
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--n", type=int, default=1 << 23)
    ap.add_argument("--parts", type=int, default=4)
    a = ap.parse_args()
    sys.exit(main(a.cpu, a.n, a.parts))
