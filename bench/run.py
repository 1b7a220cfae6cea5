"""Runs one cell of the benchmark once and prints its result line.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  ``--trace 0`` reports the cell's end-to-end
metrics; ``--trace 1`` its per-layer metrics, read from the program's
counters and a device trace of part of the window.  ``--control 1``
(calibration only) also reads the correctness control: the plain reference
in the precision below the configuration's, in the program's place.

The cell, its configuration, its traffic mix and the per-layer metrics are
found by the names ``BENCHMARK.json`` gives them (``benchlib.registry``).
Set-up (weights from the seed, the engine or train step, every shape the
window uses) runs before the window opens; nothing compiles inside it.
The last lines on standard error name each compared number and its limit;
the last line on standard output is the result.  Exits non-zero without a
result when no card (or too few) is present, or when the JAX package or
its stack was loaded.
"""
from __future__ import annotations

import argparse
import faulthandler
import os
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from benchlib.result import Clock  # noqa: E402

_CLOCK = Clock()


def cache_env(root: Path) -> None:
    """Every build and kernel cache at a fixed directory inside the
    checkout, so a second run there finds it."""
    cache = root / "bench" / ".cache"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(cache / "kernels")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(cache / "inductor")
    os.environ["USE_FLAX"] = "0"


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


class Cell:
    """What a driver gets: the cell's parts by name, the run's arguments,
    the card (or, in the harness's own tests, the CPU) and the clock."""

    def __init__(self, args, root: Path, device_kind: str, clock: Clock):
        from benchlib import registry

        self.root = root
        self.bench_dir = root / "bench"
        self.benchmark = registry.load_benchmark(root)
        self.workload = registry.find(self.benchmark["workloads"], args.workload, "workload")
        self.config = registry.load_json("configs", self.workload["config"], bench=self.bench_dir)
        self.traffic = registry.load_json("traffic", self.workload["traffic"], bench=self.bench_dir)
        self.limits = registry.load_json("limits", self.workload["name"], bench=self.bench_dir)
        self.e2e = registry.metrics_of(self.benchmark, self.workload, "end_to_end")
        self.per_layer = registry.metrics_of(self.benchmark, self.workload, "per_layer")
        self.seed = int(args.seed)
        self.seconds = float(args.seconds)
        self.trace = bool(args.trace)
        self.control = bool(args.control)
        self.device_kind = device_kind
        self.clock = clock

    def module(self, kind: str, name: str):
        from benchlib import registry

        return registry.load_module(kind, name, bench=self.bench_dir)

    def read_per_layer(self, run) -> dict:
        """Each per-layer metric's reader over what the traced run kept; a
        reader that finds nothing returns None and its metric is left out."""
        out = {}
        for m in self.per_layer:
            value = self.module("metrics", m["name"]).read(run)
            if value is not None:
                out[m["name"]] = {"value": float(value), "unit": m["unit"]}
        return out


def main(argv=None, *, root: "Path | None" = None, require_chip: bool = True,
         clock: "Clock | None" = None) -> int:
    """One run; ``root``, ``require_chip=False`` and ``clock`` serve the
    harness's own tests."""
    args = parse(argv)
    root = Path(root) if root is not None else BENCH.parent
    if require_chip:
        # a run that hangs prints every thread's stack and exits before the
        # time a run is allowed: 360 s, 1200 s for the first in a checkout,
        # which builds the kernels
        built = any((root / "bench" / ".cache" / "kernels").glob("*.so"))
        faulthandler.dump_traceback_later(350 if built else 1190, exit=True)
    cache_env(root)
    import torch

    from benchlib import registry
    from benchlib.result import emit, forbidden_modules

    bench = registry.load_benchmark(root)
    workload = registry.find(bench["workloads"], args.workload, "workload")
    chips = int(workload["chips"])
    if require_chip:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"run: cell {workload['name']} needs {chips} CUDA device(s); found {n}",
                  file=sys.stderr)
            return 2
        kind = "cuda"
    else:
        kind = "cuda" if torch.cuda.is_available() else "cpu"
    cell = Cell(args, root, kind, clock or _CLOCK)
    driver = cell.module("drivers", cell.traffic["driver"])
    res = driver.run(cell)
    found = forbidden_modules()
    if found:
        print(f"run: the JAX package or its stack was loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    checks = res.pop("checks")
    emit(res, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
