"""Compare two directories of dry-run records, cell by cell.

Each directory holds ``<arch>__<shape>__<singlepod|multipod>.json``
records, as ``python -m repro_torch.launch.dryrun`` writes them (the
port's ``results/torch_dryrun/``) or as the JAX package's dry run writes
them (``results/dryrun/``): both carry ``hlo.flops``,
``hlo.collective_wire_bytes`` and ``memory``.  For every record in both
(or the ``--arch``/``--cell`` ones) prints FLOPs, wire bytes a device and
argument + temp GB of each side and their ratios B / A, and the records
whose ratio of any of them is off 1 by ``--moved`` or more.  With
``--max-rel`` exits 1 if any FLOPs or wire ratio is off 1 by more (a
record traced on the card's torch held to the CPU's count).

    python tools/compare_dryrun_records.py A_DIR B_DIR [--arch mamba2-130m]
        [--cell whisper-tiny:train_4k] [--moved 0.005] [--max-rel 0.01]
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def _records(d: Path) -> dict:
    out = {}
    for p in sorted(d.glob("*__*__*.json")):
        rec = json.loads(p.read_text())
        if "error" not in rec and "hlo" in rec:
            out[p.stem] = rec
    return out


def _gb(rec) -> float:
    mem = rec["memory"]
    return (mem["argument_bytes"] + mem["temp_bytes"]) / 1e9


def _ratio(a: float, b: float) -> float:
    return b / a if a else float("inf") if b else 1.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("a", type=Path)
    ap.add_argument("b", type=Path)
    ap.add_argument("--arch", action="append", default=[])
    ap.add_argument("--cell", action="append", default=[], help="arch:shape")
    ap.add_argument("--moved", type=float, default=0.005)
    ap.add_argument("--max-rel", type=float, default=None)
    args = ap.parse_args(argv)
    a, b = _records(args.a), _records(args.b)
    keep = {tuple(c.split(":")) for c in args.cell}
    names = [n for n in a if n in b and (not (args.arch or keep) or n.split("__")[0] in args.arch
                                         or tuple(n.split("__")[:2]) in keep)]
    print("| record | FLOPs A | FLOPs B | ratio | wire A | wire B | ratio | GB A | GB B |")
    print("|---|---|---|---|---|---|---|---|---|")
    moved, off = [], []
    for n in names:
        ha, hb = a[n]["hlo"], b[n]["hlo"]
        rf = _ratio(ha["flops"], hb["flops"])
        rw = _ratio(ha["collective_wire_bytes"], hb["collective_wire_bytes"])
        ga = _gb(a[n]) if "memory" in a[n] else float("nan")
        gb = _gb(b[n]) if "memory" in b[n] else float("nan")
        print(f"| {n} | {ha['flops']:.6g} | {hb['flops']:.6g} | {rf:.5f} | "
              f"{ha['collective_wire_bytes']:.6g} | {hb['collective_wire_bytes']:.6g} | "
              f"{rw:.5f} | {ga:.4g} | {gb:.4g} |")
        if any(abs(r - 1) >= args.moved for r in (rf, rw, _ratio(ga, gb))):
            moved.append(n)
        if args.max_rel is not None and max(abs(rf - 1), abs(rw - 1)) > args.max_rel:
            off.append(n)
    print(f"{len(names)} records in both; moved by {args.moved} or more: {len(moved)}"
          + (f" ({', '.join(moved)})" if moved else ""))
    if args.max_rel is not None:
        print(f"FLOPs or wire off by more than {args.max_rel}: {len(off)}"
              + (f" ({', '.join(off)})" if off else ""))
        return 1 if off or not names else 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
