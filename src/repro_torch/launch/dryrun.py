"""Dry run of the production cells (``src/repro/launch/dryrun.py`` on
PyTorch).

Lays one (architecture x input-shape) cell, or every one, out over the
production mesh, 16x16 = 256 ranks or, with ``--multi-pod``, 2x16x16 =
512, all in this process (``launch.mesh.fake_world``), and runs the cell's
train step, prefill or decode step once on fake tensors: params,
optimizer state, batch and cache are shapes and dtypes placed by the
plan's rules, and nothing is allocated.  ``analysis.op_analysis`` records
the step's ops on one device and its live storage, and the record of
per-device memory, FLOPs, HBM traffic and collectives goes to
``results/torch_dryrun/<arch>__<shape>__<singlepod|multipod>.json``, the
op table beside it (``.ops.jsonl.gz``; ``--reanalyze`` recomputes the
records' ``hlo`` from the tables).  ``analysis.roofline`` turns the
records into roofline terms.

The step runs with ``impl="ref"``: plain attention and scans, which is
what the reference lowers (its model path is plain ``jnp``), and no
hand-written kernel can take a fake tensor (a kernel reads its inputs'
addresses).  So attention FLOPs and bytes are the plain path's, an upper
bound where the card runs the flash kernel.

Usage:
    python -m repro_torch.launch.dryrun --all [--both-meshes] [--device cpu]
    python -m repro_torch.launch.dryrun --cell olmo-1b:train_4k --multi-pod

``--device`` is the mesh's device type: ``cuda`` unless the caller asks
for the CPU (fake tensors need no card either way).
"""
from __future__ import annotations

import argparse
import dataclasses
import gzip
import json
import time
import traceback
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis import op_analysis
from repro_torch.configs import cells, get_config, get_shape
from repro_torch.distribution.recipes import plan_for
from repro_torch.distribution.sharding import axis_rules, tree_sharding
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.models import batch_logical_specs, get_model, input_specs
from repro_torch.pytree import tree_flatten, tree_unflatten
from repro_torch.serving.serve_step import make_prefill, make_serve_step
from repro_torch.training.optimizer import OptConfig, init_opt_state
from repro_torch.training.train_step import make_train_step

__all__ = ["RESULTS_DIR", "cell_path", "lower_cell", "main", "ops_path", "reanalyze_all",
           "run_cell", "trace_step"]

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "torch_dryrun"


class _ZeroScalars(TorchDispatchMode):
    """Reads a fake tensor's data-dependent scalar as 0 (False), so an
    init's rejection loop (``trunc_normal_``) ends at once: the values of
    fake params are never used."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            return False if args[0].dtype == torch.bool else 0
        return func(*args, **(kwargs or {}))


def _place(tree, shardings):
    """``tree``'s leaves as ``DTensor``s by ``shardings`` (a matching tree),
    each rank slicing its own shard without communication."""
    flat, tdef = tree_flatten(tree)
    sh = tree_flatten(shardings)[0]
    return tree_unflatten(tdef, [s.distribute(x, src_data_rank=None) for x, s in zip(flat, sh)])


def _storages(tree) -> "dict[int, int]":
    """Distinct local storages of a tree's tensors: address -> bytes."""
    from torch.distributed.tensor import DTensor

    out = {}
    for x in tree_flatten(tree)[0]:
        if isinstance(x, torch.Tensor):
            st = (x._local_tensor if isinstance(x, DTensor) else x).untyped_storage()
            out[st._cdata] = int(st.nbytes())
    return out


def _fake_inputs(m, cfg, shape, plan, mesh, device):
    """(the step's inputs, its function name, the step, the params): fake
    tensors on ``device``, laid out over ``mesh`` (if there is one) by the
    plan's rules; a serving step closes over its params."""

    def put(tree, names):
        if mesh is None:
            return tree
        return _place(tree, tree_sharding(mesh, names, plan.rules, tree))

    batch = put({k: torch.zeros(v.shape, dtype=v.dtype, device=device)
                 for k, v in input_specs(cfg, shape).items()}, batch_logical_specs(cfg, shape))
    dtype = torch.float32 if shape.kind == "train" else torch.bfloat16
    with _ZeroScalars():
        params = m.init(cfg, generator=torch.Generator(device=device).manual_seed(0),
                        device=device, dtype=dtype)
    pspecs = m.param_specs(cfg)
    if shape.kind == "train":
        opt = put(init_opt_state(params), {"m": pspecs, "v": pspecs, "step": ()})
        params = put(params, pspecs)
        step = make_train_step(cfg, shape, OptConfig(), plan, impl="ref", donate=True)
        return (params, opt, batch), "train_step", step, params
    params = put(params, pspecs)
    if shape.kind == "prefill":
        return ((batch,), "prefill", make_prefill(cfg, params, q_block=plan.q_block, impl="ref"),
                params)
    cache = put(m.init_cache(cfg, shape.global_batch, shape.seq_len, device=device),
                m.cache_specs(cfg))
    pos = shape.seq_len - cfg.meta_tokens - 1  # the step that fills the cache's last slot
    return (cache, batch["tokens"], pos), "serve_step", make_serve_step(cfg, params), params


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool = False, mesh=None, plan=None,
               device_type: str = "cuda", cfg=None, ops_file: "Path | None" = None) -> dict:
    """Trace one cell on fake tensors over ``mesh`` (by default the
    production mesh over a fake world of 256 or 512 ranks) and return its
    record.  ``cfg`` replaces ``get_config(arch)`` (``perf_lab``'s
    overrides, a smoke config); ``ops_file`` receives the op table."""
    cfg = cfg if cfg is not None else get_config(arch)
    shape = get_shape(shape_name)
    plan = plan if plan is not None else plan_for(cfg, shape, multi_pod=multi_pod)
    if plan.moe_groups is not None and cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, dispatch_groups=plan.moe_groups))
    if mesh is None:
        with fake_world(512 if multi_pod else 256, device_type=device_type):
            mesh = make_production_mesh(multi_pod=multi_pod, device_type=device_type)
            return _lower(arch, shape_name, cfg, shape, plan, mesh, ops_file)
    return _lower(arch, shape_name, cfg, shape, plan, mesh, ops_file)


def trace_step(cfg, shape, plan=None, *, device_type: str = "cuda") -> dict:
    """The record of one device running ``shape``'s step of ``cfg`` with
    no mesh (``shape`` a ``ShapeConfig``, any size): fake tensors on
    ``device_type``, ``impl="ref"``, the plan's remat, microbatches and
    compute dtype, as an unsharded run on the card takes them."""
    plan = plan if plan is not None else plan_for(cfg, shape)
    return _lower(cfg.name, shape.name, cfg, shape, plan, None, None, device_type)


def _placement_mesh(mesh):
    """The mesh the tensors are placed on: the mesh itself, or for one with
    a ``pod`` axis its (pod x data, model) flattening, over the same ranks.
    Every rule shards ``pod`` and ``data`` together (the batch, FSDP), so
    the placements, the shards and the collectives' groups are the same;
    ``DTensor``'s redistribution planner, which searches over mesh dims,
    takes minutes a step on three of them and seconds on two."""
    from torch.distributed.device_mesh import init_device_mesh

    names = tuple(mesh.mesh_dim_names)
    if "pod" not in names:
        return mesh
    sizes = dict(zip(names, mesh.shape))
    return init_device_mesh(mesh.device_type, (sizes["pod"] * sizes["data"], sizes["model"]),
                            mesh_dim_names=("data", "model"))


def _lower(arch, shape_name, cfg, shape, plan, mesh, ops_file, device_type=None) -> dict:
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    m = get_model(cfg)
    device = torch.device(mesh.device_type if mesh is not None else device_type)
    placed = _placement_mesh(mesh) if mesh is not None else None
    t0 = time.time()
    with FakeTensorMode(allow_non_fake_inputs=True):
        args, fn_name, step, params = _fake_inputs(m, cfg, shape, plan, placed, device)
        arg_st = _storages((args, params))
        with axis_rules(plan.rules, placed), implicit_replication(), \
                op_analysis.Recorder() as rec:
            out = step(*args)
        out_st = _storages(out)
    t_lower = time.time() - t0
    t0 = time.time()
    hlo = op_analysis.analyze(rec.table)
    t_analyze = time.time() - t0
    if ops_file is not None:
        _write_table(ops_file, rec.table)

    n_dev = mesh.size() if mesh is not None else 1
    return {
        "arch": arch,
        "shape": shape_name,
        "kind": shape.kind,
        "fn": fn_name,
        "impl": "ref",
        "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)) if mesh is not None else {},
        "placed_on": dict(zip(placed.mesh_dim_names, placed.shape)) if placed is not None else {},
        "devices": int(n_dev),
        "plan": {
            "remat": plan.remat,
            "q_block": plan.q_block,
            "num_microbatches": plan.num_microbatches,
        },
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "memory": {
            "argument_bytes": sum(arg_st.values()),
            "output_bytes": sum(out_st.values()),
            "temp_bytes": rec.peak_bytes,
            "alias_bytes": sum(b for k, b in out_st.items() if k in arg_st),
            "code_bytes": None,
        },
        "cost_analysis": {"flops": hlo["flops"], "bytes_accessed": hlo["hbm_bytes"]},
        "hlo": hlo,
        "timing_s": {"lower": t_lower, "compile": None, "analyze": t_analyze},
    }


def _write_table(path: Path, table) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    with gzip.open(path, "wt", compresslevel=3) as f:
        for row in table:
            f.write(json.dumps(row, separators=(",", ":")) + "\n")


def _read_table(path: Path) -> "list[dict]":
    with gzip.open(path, "rt") as f:
        return [json.loads(line) for line in f]


def cell_path(arch: str, shape_name: str, multi_pod: bool) -> Path:
    tag = "multipod" if multi_pod else "singlepod"
    return RESULTS_DIR / f"{arch}__{shape_name}__{tag}.json"


def ops_path(arch: str, shape_name: str, multi_pod: bool) -> Path:
    return cell_path(arch, shape_name, multi_pod).with_suffix(".ops.jsonl.gz")


def run_cell(arch, shape_name, multi_pod, mesh=None, force=False, device_type="cuda") -> dict:
    path = cell_path(arch, shape_name, multi_pod)
    if path.exists() and not force:
        rec = json.loads(path.read_text())
        if "error" not in rec:
            print(f"[cached] {arch}:{shape_name} ({'multi' if multi_pod else 'single'})")
            return rec
    print(f"[lower ] {arch}:{shape_name} ({'multi' if multi_pod else 'single'}) ...", flush=True)
    try:
        rec = lower_cell(arch, shape_name, multi_pod=multi_pod, mesh=mesh,
                         device_type=device_type, ops_file=ops_path(arch, shape_name, multi_pod))
        mem = rec["memory"]
        tot = (mem["argument_bytes"] + mem["temp_bytes"]) / 1e9
        print(
            f"[ok    ] {arch}:{shape_name} lower={rec['timing_s']['lower']:.1f}s "
            f"mem/dev={tot:.2f}GB colls={sum(rec['hlo']['collective_counts'].values())}",
            flush=True,
        )
    except Exception:  # noqa: BLE001 - a failed cell is a record, the run goes on
        rec = {
            "arch": arch,
            "shape": shape_name,
            "multi_pod": multi_pod,
            "error": traceback.format_exc(limit=20),
        }
        print(f"[FAIL  ] {arch}:{shape_name}\n{rec['error']}", flush=True)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(rec, indent=1))
    return rec


def reanalyze_all() -> int:
    """Recompute rec['hlo'] (and ``cost_analysis``) from the stored op
    tables, without tracing again."""
    n = 0
    for z in sorted(RESULTS_DIR.glob("*.ops.jsonl.gz")):
        stem = z.name[: -len(".ops.jsonl.gz")]
        rec_path = RESULTS_DIR / f"{stem}.json"
        if not rec_path.exists():
            continue
        rec = json.loads(rec_path.read_text())
        rec["hlo"] = op_analysis.analyze(_read_table(z))
        rec["cost_analysis"] = {"flops": rec["hlo"]["flops"],
                                "bytes_accessed": rec["hlo"]["hbm_bytes"]}
        rec_path.write_text(json.dumps(rec, indent=1))
        n += 1
        print(f"[reanalyzed] {stem}")
    return n


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--cell", action="append", default=[], help="arch:shape")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--reanalyze", action="store_true",
                    help="recompute the records' op analysis from the stored tables")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the mesh's device type (cuda unless the caller asks for the CPU)")
    args = ap.parse_args(argv)

    if args.reanalyze:
        n = reanalyze_all()
        print(f"reanalyzed {n} records")
        return

    todo = []
    if args.all:
        todo = cells()
    elif args.arch:
        todo = [(a, s) for a, s in cells() if a == args.arch]
    for c in args.cell:
        a, s = c.split(":")
        todo.append((a, s))
    if not todo:
        ap.error("nothing to do; pass --all or --cell arch:shape")

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = 0
    t0 = time.time()
    for mp in meshes:
        with fake_world(512 if mp else 256, device_type=args.device):
            mesh = make_production_mesh(multi_pod=mp, device_type=args.device)
            for arch, shape_name in todo:
                rec = run_cell(arch, shape_name, mp, mesh=mesh, force=args.force,
                               device_type=args.device)
                failures += 1 if "error" in rec else 0
    print(f"done: {len(todo) * len(meshes)} cells, {failures} failures, "
          f"{time.time() - t0:.1f}s")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
