"""Finds every part of a cell by the name ``BENCHMARK.json`` gives it.

A configuration is ``configs/<name>.json``, a traffic mix
``traffic/<name>.json`` (whose ``driver`` names ``drivers/<driver>.py``), a
per-layer metric ``metrics/<name>.py``, a kernel's counts
``counts/<kernel>.py``, a plain reference ``reference/<family>.py`` and a
cell's correctness limits ``limits/<workload>.json``.  Nothing here lists
names: a later change adds a part by adding its file.
"""
from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def _checked(name: str) -> str:
    if not _NAME.match(name or ""):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def load_json(kind: str, name: str, *, bench: Path = BENCH) -> dict:
    """``<bench>/<kind>/<name>.json`` as a dict."""
    path = bench / kind / f"{_checked(name)}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1] if kind.endswith('s') else kind} named "
                                f"{name!r} ({path})")
    return json.loads(path.read_text())


def load_module(kind: str, name: str, *, bench: Path = BENCH):
    """``<bench>/<kind>/<name>.py`` imported under a module name of its own
    (a metric's name may hold dots, so it is loaded from its path)."""
    path = bench / kind / f"{_checked(name)}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module named {name!r} ({path})")
    mod_name = "bench_" + kind + "_" + re.sub(r"[^A-Za-z0-9_]", "_", name)
    mod = sys.modules.get(mod_name)
    if mod is not None and getattr(mod, "__file__", None) == str(path):
        return mod
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_benchmark(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"no BENCHMARK.json at {root}")
    return json.loads(path.read_text())


def find(entries: "list[dict]", name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


def metrics_of(bench: dict, workload: dict, kind: str) -> "list[dict]":
    """The ``kind`` ("end_to_end" or "per_layer") metrics that ``workload``
    reports: those listing it under ``workloads``; a metric without the key
    goes to every cell (a per-layer one: every cell reporting the
    end-to-end metric it moves)."""
    e2e = {m["name"] for m in bench["end_to_end"]
           if m.get("workloads") is None or workload["name"] in m["workloads"]}
    out = []
    for m in bench[kind]:
        cells = m.get("workloads")
        if cells is not None:
            if workload["name"] in cells:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out

