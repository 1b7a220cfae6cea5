"""Quickstart: the paper's Listing 1 + Listing 2 workflow (the PyTorch port
of ``examples/quickstart.py``).

Discovers devices, allocates buffers, builds a kernel from a source file
on the device's compile queue, overlaps the data transfers with that build
through futures, runs the kernel with an explicit grid and block, and reads
the result back.  It runs on the card; ``--cpu`` runs it on the CPU device
instead.  The buffers are int32, where the reference's are uint32: PyTorch
has no uint32 sum.

    python3 examples/torch_quickstart.py [--cpu]
"""
import argparse
import os
import sys
import tempfile
import textwrap

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.core import Dim3, get_all_devices, wait_all  # noqa: E402

KERNEL_SRC = textwrap.dedent(
    """
    import torch

    def sum_kernel(x, acc, grid=None, block=None):
        return acc + torch.sum(x, dtype=acc.dtype)

    KERNELS = {"sum": sum_kernel}
    """
)


def main(cpu: bool = False) -> int:
    # Listing 1: gather all (local and remote) devices with capability >= 1.0
    devices = get_all_devices(1, 0, platform="cpu" if cpu else "cuda").get()
    if not devices:
        print("no CUDA device: pass --cpu to run on the CPU", file=sys.stderr)
        return 1
    print(f"devices: {devices}")
    dev = devices[0]

    # host data (Listing 2 lines 4-12)
    n = 1000
    input_data = np.ones(n, dtype=np.int32)
    result = np.zeros(1, dtype=np.int32)

    futures = []

    # buffers + async writes (lines 16-22): cudaMalloc + cudaMemcpyAsync
    inbuf = dev.create_buffer(n, np.int32).get()
    futures.append(inbuf.enqueue_write(0, input_data))
    resbuf = dev.create_buffer(1, np.int32).get()
    futures.append(resbuf.enqueue_write(0, result))

    with tempfile.TemporaryDirectory() as tmp:
        # kernel built from a source file on the compile queue (lines 24-25)
        path = os.path.join(tmp, "quickstart_kernel.py")
        with open(path, "w") as f:
            f.write(KERNEL_SRC)
        prog = dev.create_program_with_file(path).get()
        futures.append(prog.build("sum"))

        # barrier: copies + build must finish (line 38)
        wait_all(futures)

    # launch with explicit geometry (lines 27-40)
    prog.run([inbuf, resbuf], "sum", grid=Dim3(1), block=Dim3(32), out=[resbuf]).get()

    # synchronous read-back (line 42)
    res = resbuf.enqueue_read_sync(0, 1)
    print(f"sum of {n} ones = {int(res[0])}")
    if int(res[0]) != n:
        print(f"expected {n}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    sys.exit(main(ap.parse_args().cpu))
