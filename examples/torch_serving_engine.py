"""Continuous-batching serving demo (the PyTorch port of
``examples/serving_engine.py``).

Many "clients" fire single-row requests at a ``RequestEngine``; the engine
assembles micro-batches under a latency deadline, pads them to bucketed
shapes, replays the captured step (one CUDA graph a bucket) on an
engine-owned stream, and resolves each client's future with exactly its
rows.  The same requests then run one by one through ``Program.run``
(serial) for comparison; every result must be bit-equal to the serial one.
The step is four rounds of the hand-written ``partition_map`` kernel.  It
runs on the card; ``--cpu`` runs it on the CPU device instead (the kernel's
plain version, the graph replayed eagerly).

    python3 examples/torch_serving_engine.py [--cpu]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.core import Scheduler, get_all_devices, wait_all  # noqa: E402
from repro_torch.kernels.partition_map.ops import partition_map  # noqa: E402
from repro_torch.serving import RequestEngine  # noqa: E402


def step(x):
    v = x
    for _ in range(4):
        v = partition_map(v.reshape(-1)).reshape(v.shape) * 0.5 + v * 0.5
    return v


N, REQUESTS = 256, 48


def main(cpu: bool = False) -> int:
    devices = get_all_devices(1, 0, platform="cpu" if cpu else "cuda").get()
    if not devices:
        print("no CUDA device: pass --cpu to run on the CPU", file=sys.stderr)
        return 1
    dev = devices[0]
    rng = np.random.default_rng(0)
    payloads = [rng.normal(size=(1, N)).astype(np.float32) for _ in range(REQUESTS)]

    # -- per-request serial baseline ---------------------------------------
    prog = dev.create_program({"step": step}, "serve-demo").get()
    prog.run([payloads[0]], "step").get()  # warm the step
    t0 = time.perf_counter()
    serial = [prog.run([p], "step").get().cpu().numpy() for p in payloads]
    t_serial = time.perf_counter() - t0

    # -- continuous batching ------------------------------------------------
    engine = RequestEngine(step, max_batch=8, max_delay_s=0.002,
                           scheduler=Scheduler([dev], policy="least_loaded"), name="demo")
    try:
        wait_all([engine.submit(p) for p in payloads])  # capture the bucket routes
        t0 = time.perf_counter()
        futs = [engine.submit(p) for p in payloads]
        wait_all(futs)
        t_batched = time.perf_counter() - t0
        for want, f in zip(serial, futs):
            got = f.get(timeout=60)
            if not (got.dtype == want.dtype and np.array_equal(got, want)):
                raise SystemExit("engine result differs from the serial run")
        m = engine.metrics()
    finally:
        engine.close()
    graphs = sum(e.exe.cuda_graphs for e in engine._graphs.values() if e is not None)
    print(f"{REQUESTS} requests, step=(1,{N}) partition_map x4 on {dev.key}")
    print(f"  serial : {t_serial * 1e3:7.1f} ms  ({REQUESTS / t_serial:7.0f} req/s)")
    print(f"  engine : {t_batched * 1e3:7.1f} ms  ({REQUESTS / t_batched:7.0f} req/s)  "
          f"[{m['batches']} micro-batches incl. warm-up, mean {m['mean_batch_rows']:.1f} rows, "
          f"{graphs} CUDA graphs]")
    print(f"  speedup: {t_serial / t_batched:.2f}x, results bit-equal")
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    a = ap.parse_args()
    sys.exit(main(a.cpu))
