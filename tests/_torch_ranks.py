"""Run a piece of code in N gloo ranks on the CPU, one process a rank.

``run_ranks(code, world, tmp_path, timeout)`` starts ``world`` Python
processes that join one ``torch.distributed`` process group (gloo, a
``FileStore`` under ``tmp_path``, so files of tests spawned at once never
share a rendezvous), each running ``code`` with ``RANK`` and ``WORLD`` in
its globals.  ``code`` reports by calling ``report(obj)`` (JSON).  Returns
every rank's reports, rank by rank; raises with the ranks' stderr if one
fails, or ``TimeoutExpired`` if the run outlives ``timeout`` seconds, and
kills every rank left.  The ranks write to files under ``tmp_path``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PRELUDE = textwrap.dedent(
    """
    import json, os, sys
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    RANK, WORLD = int(sys.argv[1]), int(sys.argv[2])
    dist.init_process_group("gloo", store=dist.FileStore(sys.argv[3], WORLD), rank=RANK,
                            world_size=WORLD)

    def report(obj):
        print("REPORT " + json.dumps(obj), flush=True)
    """
)

_EPILOGUE = "\ndist.barrier()\ndist.destroy_process_group()\n"


def run_ranks(code: str, world: int, tmp_path, timeout: float = 240) -> "list[list]":
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    src = _PRELUDE + textwrap.dedent(code) + _EPILOGUE
    logs = [(os.path.join(str(tmp_path), f"rank{r}.out"), os.path.join(str(tmp_path),
                                                                      f"rank{r}.err"))
            for r in range(world)]
    procs = []
    for r, (out, err) in enumerate(logs):
        with open(out, "w") as fo, open(err, "w") as fe:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", src, str(r), str(world),
                 os.path.join(str(tmp_path), "store")], env=env, cwd=ROOT, stdout=fo,
                stderr=fe))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    texts = [(open(out).read(), open(err).read()) for out, err in logs]
    bad = [(r, p.returncode, err[-3000:]) for r, (p, (_, err)) in enumerate(zip(procs, texts))
           if p.returncode != 0]
    assert not bad, bad
    return [[json.loads(line[7:]) for line in out.splitlines() if line.startswith("REPORT ")]
            for out, _ in texts]
