"""Two-stream double buffering, overlapped with host-side work (the
PyTorch port of ``examples/overlap_pipeline.py``).

A chunked pipeline, H2D -> kernel -> D2H -> host consume, alternates
chunks between two streams over two buffer slots, with completion events
serialising the kernels onto one compute engine (the CUDA copy-engine
pattern).  While the device works on chunk ``i``, stream ``i+1`` stages and
ships the next chunk, and the main thread does host work of its own the
whole time: transfers, launches and host computation all overlap.  The
streams are CUDA streams and the events CUDA events; it runs on the card,
and ``--cpu`` runs it on the CPU device instead.

    python3 examples/torch_overlap_pipeline.py [--cpu]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import get_all_devices  # noqa: E402


def kernel(x, grid=None, block=None):
    for _ in range(2):
        x = torch.sin(x) * 1.0001 + x * 0.5
    return x


def main(cpu: bool = False) -> int:
    devices = get_all_devices(platform="cpu" if cpu else "cuda").get()
    if not devices:
        print("no CUDA device: pass --cpu to run on the CPU", file=sys.stderr)
        return 1
    dev = devices[0]
    prog = dev.create_program({"work": kernel}, "overlap").get()

    n, nchunks = 1 << 20, 8
    rng = np.random.default_rng(0)
    chunks = [rng.normal(size=(n,)).astype(np.float32) for _ in range(nchunks)]

    # Double buffering: two slots, reused alternately.  Same-stream FIFO
    # guarantees slot i%2's previous read finished before it is rewritten.
    inb = [dev.create_buffer(n, np.float32).get() for _ in range(2)]
    outb = [dev.create_buffer(n, np.float32).get() for _ in range(2)]
    streams = [dev.create_stream("pipe-a"), dev.create_stream("pipe-b")]

    t0 = time.perf_counter()
    checksums, prev_kernel = [], None
    for i, chunk in enumerate(chunks):
        s = streams[i % 2]
        s.enqueue_write(inb[i % 2], 0, chunk)              # H2D on this stream
        if prev_kernel is not None:
            s.wait_event(prev_kernel)                      # one compute engine
        s.launch(prog, [inb[i % 2]], "work", out=[outb[i % 2]])
        prev_kernel = s.record()                           # fires at kernel COMPLETION
        r = s.enqueue_read(outb[i % 2])                    # D2H on this stream
        # Host-side consume, stream-ordered (cudaLaunchHostFunc analogue).
        checksums.append(s.submit(lambda f=r: float(np.abs(f.get()).sum())))

    # The pipeline is in flight: the main core is free.  Overlap it with
    # host work of its own (the paper's "work on the main cores").
    host_acc, host_rounds = 0.0, 0
    while not all(f.done() for f in checksums):
        host_acc += float(np.sin(np.arange(1 << 14)).sum())
        host_rounds += 1
    wall = time.perf_counter() - t0

    total = sum(f.get() for f in checksums)
    want = sum(float(np.abs(kernel(torch.from_numpy(c)).numpy()).sum()) for c in chunks)
    hwm = dev._dispatcher.high_water()
    print(f"pipelined {nchunks} chunks x {n * 4 / 1e6:.1f} MB in {wall * 1e3:.0f} ms")
    print(f"checksum {total:.1f}; host did {host_rounds} rounds of its own work meanwhile")
    print(f"peak concurrent lanes on {dev.key}: {hwm} (>1 == overlap really happened)")
    dev.synchronize()  # drains every stream, not just the default
    if hwm <= 1:
        print("expected at least two lanes running concurrently", file=sys.stderr)
        return 1
    if abs(total - want) > 1e-4 * want:
        print(f"checksum {total} differs from the host's {want}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    sys.exit(main(ap.parse_args().cpu))
