"""The run's clock, its statistics, the guard against the JAX package, and
the lines a run prints last."""
from __future__ import annotations

import json
import math
import os
import sys
import time

# the JAX package and what it stands on: none may be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_age_s() -> float:
    """Seconds since this process started, from ``/proc`` (0 where the
    system has no ``/proc``)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


class Clock:
    """``setup_s`` runs from the process's start to ``open_window``."""

    def __init__(self):
        self.t_top = time.perf_counter()
        self.age_at_top = process_age_s()
        self.setup_s: "float | None" = None

    def open_window(self) -> float:
        now = time.perf_counter()
        self.setup_s = (now - self.t_top) + self.age_at_top
        return now


def percentile(xs, q: float) -> float:
    """The ``q``-th percentile (0-100) of ``xs``, linear between order
    statistics (numpy's default)."""
    v = sorted(float(x) for x in xs)
    if not v:
        raise ValueError("percentile of nothing")
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def forbidden_modules() -> "list[str]":
    """Loaded modules whose top-level name, compared whole, is the JAX
    package's or one of its stack's."""
    return sorted({m for m in list(sys.modules) if m.split(".", 1)[0] in FORBIDDEN})


def emit(result: dict, checks: dict, out=None, err=None) -> None:
    """Print each compared number beside its limit as the last lines on
    standard error, then the result as the last line on standard output,
    ``checks`` its last key."""
    out = out or sys.stdout
    err = err or sys.stderr
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=err)
    err.flush()
    line = dict(result)
    line["checks"] = checks
    print(json.dumps(line), file=out)
    out.flush()
