"""Task-graph capture and replay on a CUDA graph (the PyTorch port of
``examples/graph_replay.py``).

Drives the same three-kernel chain two ways on one CUDA card:
  eager   — every launch pays a future, a lane hop and a launch from Python
            (Listing-2 style);
  graph   — the chain is captured once into one ``torch.cuda.CUDAGraph``
            and replayed with one lane hop, one graph launch and one future.

The chain is the port's own kernels: the stencil kernel, the
partition_map kernel, then an elementwise shift.

    python3 examples/torch_graph_replay.py [--n 262144] [--steps 50]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import get_all_devices  # noqa: E402
from repro_torch.kernels.partition_map.ops import partition_map  # noqa: E402
from repro_torch.kernels.stencil.ops import stencil  # noqa: E402


def main(n: int = 1 << 18, steps: int = 50) -> int:
    devices = get_all_devices(1, 0).get()
    if not devices:
        print("torch_graph_replay: needs a CUDA device", file=sys.stderr)
        return 1
    dev = devices[0]
    prog = dev.create_program({"stencil": stencil, "map": partition_map,
                               "shift": lambda x: x + 1.0}, "graph-demo").get()

    host = np.random.default_rng(0).normal(size=(n,)).astype(np.float32)
    src = dev.create_buffer_from(host).get()
    a, b, c = (dev.create_buffer(n, np.float32).get() for _ in range(3))

    # --- eager chain (warm the kernels and the allocator first)
    def eager_step():
        prog.run([src], "stencil", out=[a]).get()
        prog.run([a], "map", out=[b]).get()
        prog.run([b], "shift", out=[c]).get()

    eager_step()
    want = c.enqueue_read_sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        eager_step()
    t_eager = (time.perf_counter() - t0) / steps

    # --- captured once, replayed as one CUDA graph (a and b become
    #     graph-internal: invalid after a replay until written again)
    with dev.capture("chain") as g:
        prog.run([src], "stencil", out=[a])
        prog.run([a], "map", out=[b])
        prog.run([b], "shift", out=[c])
        r = c.enqueue_read()
    exe = g.instantiate()
    print(exe)

    result = exe.replay().get()  # warm
    t0 = time.perf_counter()
    for _ in range(steps):
        result = exe.replay().get()
    t_graph = (time.perf_counter() - t0) / steps

    final = result[r]
    assert np.array_equal(final, want), "replay differs from the eager chain"
    print(f"{torch.cuda.get_device_name(0)}: n={n} steps={steps}  checksum={final.sum():.4f} "
          "(bit-equal to eager)")
    print(f"eager futurized: {t_eager * 1e6:9.1f} us/step  (3 hops, 3 futures, 3 launches)")
    print(f"graph replay:    {t_graph * 1e6:9.1f} us/step  (1 hop, 1 future, 1 graph launch)  "
          f"[{(t_eager - t_graph) / t_eager:+.1%}]")
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 18)
    ap.add_argument("--steps", type=int, default=50)
    args = ap.parse_args()
    sys.exit(main(args.n, args.steps))
