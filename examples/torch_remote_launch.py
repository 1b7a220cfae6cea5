"""Remote launches end-to-end on the PyTorch port: "any kernel on any (local
or remote) device" (the port of ``examples/remote_launch.py``).

Spawns a 2-worker ``LocalClusterParcelport`` (each worker is a separate
process — a remote locality with its own CUDA context on the card, its own
runtime and AGAS registry), discovers the cluster-wide localities, places
the hand-written mandelbrot kernel on a remote one by name, overlaps the
remote launch with a local partition_map launch, and joins everything with
one ``wait_all`` — the paper's Listing 2 pattern stretched across
processes.  Then ``run_on_any`` over the port's scheduler lets the
percolation policy pick the locality.  Every remote result is checked bit
for bit against the same kernel run here.  It runs on the card; ``--cpu``
asks for CPU localities (the kernels' plain versions).

    python3 examples/torch_remote_launch.py [--cpu]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402


def main(platform: str = "cuda") -> int:
    from repro_torch.core import (LocalClusterParcelport, Program, get_all_devices,
                                  get_all_localities, wait_all)
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.mandelbrot.ops import mandelbrot
    from repro_torch.kernels.partition_map.ops import partition_map

    t0 = time.perf_counter()
    port = LocalClusterParcelport(n_workers=2, heartbeat_timeout=60.0, platform=platform)
    print(f"cluster up in {time.perf_counter() - t0:.1f}s")
    try:
        # 1. discover: this locality + every remote one the port reaches
        locs = get_all_localities(platform=platform, cluster=port).get()
        for loc in locs:
            print(f"  {loc}: {[d.key for d in loc]}")
        remote = next(loc for loc in locs if not loc.is_local)
        rdev = remote.devices[0]
        dev = get_all_devices(platform=platform).get()[0]

        # 2. place a kernel on the remote locality (percolates BY NAME — the
        #    worker resolves and builds it there, NVRTC-style)
        prog = rdev.create_program(["mandelbrot"], name="mandel").get()
        size = np.array([2048, 2048], np.int32)
        t1 = time.perf_counter()
        remote_fut = prog.run([size], "mandelbrot", block=(32, 8, 1))

        # 3. overlap with a local launch while the remote locality computes
        local_prog = dev.create_program({"partition_map": partition_map}, "pm").get()
        x = np.random.default_rng(0).normal(size=(1 << 22,)).astype(np.float32)
        local_fut = local_prog.run([x], "partition_map", block=(256, 1, 1))

        # 4. one barrier for both worlds (hpx::wait_all, Listing 2 l.38)
        wait_all([remote_fut, local_fut])
        dt = time.perf_counter() - t1
        img = np.asarray(remote_fut.get()[0])
        here = mandelbrot(size, block=(32, 8, 1)).cpu().numpy() if platform == "cuda" else \
            mandelbrot(size).numpy()
        ok = img.tobytes() == here.tobytes()
        print(f"remote mandelbrot {img.shape} ({img.dtype}) + local partition_map "
              f"overlapped in {dt * 1e3:.1f} ms; bit-equal to the launch here: {ok}")

        # 5. scheduler-routed: the percolation policy over local + remote
        #    devices picks where each launch runs (hpx::async by policy)
        pm = Program(dev, {"partition_map": partition_map}, "pm-any")
        sched = port.scheduler()
        ins = [np.full(1 << 16, i, np.float32) for i in range(8)]
        futs = [pm.run_on_any([a], "partition_map", scheduler=sched) for a in ins]
        wait_all(futs)
        outs = [f.get() for f in futs]
        outs = [np.asarray(o[0] if isinstance(o, list) else o.cpu()) for o in outs]
        ok_any = all(np.allclose(o, 1.0, rtol=1e-5) for o in outs)
        print(f"run_on_any placements: {sched.stats()}; all results 1: {ok_any}")
        worker_counts = {d.key: port.call(d.locality_id, "invoke",
                                          {"fn": "repro_torch.kernels:launch_counts"}).get()
                         for d in port.devices()}
        print(f"launches here: {launch_counts()}; in the workers: {worker_counts}")
    finally:
        port.shutdown()
    print("done")
    return 0 if ok and ok_any else 1


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="CPU localities (no card)")
    sys.exit(main("cpu" if ap.parse_args().cpu else "cuda"))
