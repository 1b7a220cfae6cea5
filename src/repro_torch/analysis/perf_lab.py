"""Perf lab: the hypothesis -> change -> trace again -> analyse loop
(``src/repro/analysis/perf_lab.py`` on the port's dry run).

Traces one cell with plan/rule overrides (``launch.dryrun.lower_cell``,
the overridden config passed to it), computes roofline terms, and diffs
them against the cell's recorded dry run.

    PYTHONPATH=src python -m repro_torch.analysis.perf_lab \\
        --cell qwen2-moe-a2.7b:train_4k --tag ep-over-tp \\
        --set moe_strategy=ep --set remat=dots [--device cpu]

Each run writes results/torch_perf/<cell>__<tag>.json.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

from repro_torch.analysis.roofline import roofline_terms
from repro_torch.configs import get_config, get_shape
from repro_torch.distribution.recipes import _moe_overrides, plan_for
from repro_torch.launch.dryrun import RESULTS_DIR, cell_path, lower_cell

PERF_DIR = RESULTS_DIR.parent / "torch_perf"


def apply_overrides(cfg, plan, sets: "dict[str, str]"):
    """Apply --set key=value overrides to the plan (and derived rules)."""
    plan_kw = {}
    rules = dict(plan.rules)
    for key, val in sets.items():
        if key.startswith("rules."):
            rules[key[6:]] = None if val in ("none", "None") else (
                tuple(val.split("+")) if "+" in val else val
            )
        elif key == "moe_strategy":
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, strategy=val))
            rules.update(_moe_overrides(cfg))
        elif key in ("remat", "compute_dtype", "cache_dtype"):
            plan_kw[key] = val
        elif key in ("q_block", "num_microbatches", "moe_groups"):
            plan_kw[key] = None if val in ("none", "None") else int(val)
        else:
            raise KeyError(f"unknown override {key}")
    plan = dataclasses.replace(plan, rules=rules, **plan_kw)
    return cfg, plan


def run_experiment(cell: str, tag: str, sets: "dict[str, str]", multi_pod: bool = False,
                   device_type: str = "cuda") -> dict:
    arch, shape_name = cell.split(":")
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    plan = plan_for(cfg, shape, multi_pod=multi_pod)
    cfg, plan = apply_overrides(cfg, plan, sets)
    rec = lower_cell(arch, shape_name, multi_pod=multi_pod, plan=plan, cfg=cfg,
                     device_type=device_type)

    rec["tag"] = tag
    rec["overrides"] = sets
    terms = roofline_terms(rec)
    rec["roofline"] = terms

    # baseline diff
    base_path = cell_path(arch, shape_name, multi_pod)
    if base_path.exists():
        base = json.loads(base_path.read_text())
        if "error" not in base:
            bt = roofline_terms(base)
            rec["baseline_roofline"] = bt
            rec["delta"] = {
                k: (terms[k] - bt[k]) / bt[k] if isinstance(bt[k], float) and bt[k] else None
                for k in ("compute_s", "memory_s", "collective_s", "step_seconds", "mfu")
            }

    PERF_DIR.mkdir(parents=True, exist_ok=True)
    out = PERF_DIR / f"{arch}__{shape_name}__{tag}.json"
    out.write_text(json.dumps(rec, indent=1, default=str))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True, help="arch:shape")
    ap.add_argument("--tag", required=True)
    ap.add_argument("--set", action="append", default=[], help="key=value")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the mesh's device type (cuda unless the caller asks for the CPU)")
    args = ap.parse_args(argv)
    sets = dict(s.split("=", 1) for s in args.set)
    rec = run_experiment(args.cell, args.tag, sets, args.multi_pod, args.device)
    t = rec["roofline"]
    print(f"== {args.cell} [{args.tag}] {rec.get('overrides')}")
    print(
        f"   compute {t['compute_s']:.3e}s  memory {t['memory_s']:.3e}s  "
        f"collective {t['collective_s']:.3e}s  bound={t['bound']}  mfu={t['mfu']*100:.2f}%"
    )
    if "delta" in rec:
        d = rec["delta"]
        print(
            "   vs baseline: "
            + "  ".join(f"{k}:{v * 100:+.1f}%" for k, v in d.items() if v is not None)
        )


if __name__ == "__main__":
    main()
