"""The port's dry run and roofline (``repro_torch.launch.dryrun``,
``repro_torch.analysis.roofline``/``perf_lab``) against the JAX package's.

* ``model_flops`` and ``hbm_floor_bytes`` equal the reference's for every
  cell; with the reference's constants patched in, ``roofline_terms``
  equals the reference's on the same record; ``apply_overrides`` gives a
  plan field-equal to the reference's for the same ``--set``s (run in the
  reference child: importing its perf lab forces 512 host devices).
* each family's ``cache_specs`` is the reference's, leaf for leaf.
* ``lower_cell`` at ``smoke()`` width over a 2 x 2 fake world on the CPU,
  for every family and every kind, gives a record with the reference's
  keys and collective traffic in training, and counts FLOPs within 2% of
  the reference's ``lower_cell`` of the same smoke config on a 2 x 2 JAX
  host mesh (4 forced host devices, in a subprocess, as
  ``tests/test_multidevice_train.py`` runs them), and collective wire
  bytes a device within a ceiling a cell over the reference's
  (``WIRE_CEILING``).
* one production cell, olmo-1b decode_32k, over 256 fake ranks; records
  go to ``results/torch_dryrun/``, never the reference's directory.
* a guard per product ``DTensor`` used to place: the smoke decode cells'
  attention runs each rank's rows against its own slots of the cache
  (flash decoding, as the plan shards the slots), and OLMo-1B's train
  step over 256 fake ranks holds no whole 2048 x 2048 weight and counts
  the FLOPs torch 2.11 counted on the card.
* the models under a mesh, held to the reference's placements: a rank's
  train FLOPs and temporaries fall when the data ranks double (2 x 2 to
  4 x 2) for every family; the prefill's stacked KV cache is sharded over
  batch and kv heads; the MoE dispatch buffer and expert products are
  placed over ("exp_groups", "experts") or, TP-MoE, the experts' d_ff; the
  plain SSD's chunk products run on each rank's rows and heads; a MoE and
  an ssm train cell count FLOPs near the reference's; and the train step
  of whisper-tiny's multi-pod cell gathers no logits gradient over the
  batch ranks (its unembedding's weight gradient is each rank's product
  of its own rows, summed).
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro.analysis import roofline as jax_roofline
from repro.configs import cells as jax_cells, get_config as jax_get_config
from repro.configs import get_shape as jax_get_shape
from repro.models import get_model as jax_get_model
from repro_torch.analysis import roofline
from repro_torch.analysis.perf_lab import PERF_DIR, apply_overrides
from repro_torch.configs import ALL_ARCHS, cells, get_config, get_shape, smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.distribution.recipes import plan_for
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.models import get_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# one config a family, the kinds every cell has
FAMILY_ARCHS = {"dense": "olmo-1b", "moe": "qwen2-moe-a2.7b", "vlm": "qwen2-vl-72b",
                "ssm": "mamba2-130m", "hybrid": "hymba-1.5b", "encdec": "whisper-tiny"}
KIND_SHAPES = {"train": "train_4k", "prefill": "prefill_32k", "decode": "decode_32k"}
# every family and kind: FLOPs held to the reference's lower_cell within 2%
PARITY_CELLS = tuple((FAMILY_ARCHS[f], KIND_SHAPES[k]) for f in FAMILY_ARCHS for k in KIND_SHAPES)
# cut sizes for the smoke lowerings: the op count, not the shapes, costs
# time on fake tensors, and a chunked SSD scan or a blocked attention runs
# a loop step a chunk or block
SMALL = {"train_4k": (64, 8), "prefill_32k": (64, 8)}
# the parity cells lowered at SMALL's sizes on both sides: at the full
# shapes the port's SSD scans take 85-200 s to trace.  At hymba's full
# train_4k (and prefill_32k) the reference also pads its q-blocked global
# attention's 4100 (32772) queries to whole blocks of 512, 4608 (33280)
# rows, which the port does not, so the port counts 8.4% (1.5%) fewer
# FLOPs; with those rows the train counts agree to 0.002%.  SMALL's 68
# rows run in one block.
PARITY_SMALL = {("mamba2-130m", "train_4k"), ("mamba2-130m", "prefill_32k"),
                ("hymba-1.5b", "train_4k"), ("hymba-1.5b", "prefill_32k")}
OVERRIDES = (
    {"remat": "dots", "q_block": "none"},
    {"num_microbatches": "2", "rules.seq": "data+model", "rules.vocab": "none"},
    {"moe_strategy": "ep", "moe_groups": "4", "compute_dtype": "float32"},
)

_REF_CHILD = textwrap.dedent(
    """
    import dataclasses, json, os, sys
    from pathlib import Path
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                               + os.environ.get("XLA_FLAGS", ""))
    import repro.launch.dryrun as D
    from repro.analysis.perf_lab import apply_overrides
    from repro.configs import get_config, get_shape, smoke
    from repro.configs.base import ShapeConfig
    from repro.distribution.recipes import plan_for
    from repro.launch.mesh import make_host_mesh

    spec = json.loads(sys.argv[1])
    D.RESULTS_DIR = Path(spec["tmp"]) / "dryrun"  # its HLO goes beside, not into the repo
    D.get_config = lambda a: smoke(get_config(a))
    flops, wire, by_kind = {}, {}, {}
    for a, s in spec["cells"]:
        cut = spec["small"].get(f"{a}:{s}")
        D.get_shape = (lambda n, cut=cut: ShapeConfig(n, *cut, get_shape(n).kind)) if cut \
            else get_shape
        hlo = D.lower_cell(a, s, mesh=make_host_mesh(2, 2))["hlo"]
        flops[f"{a}:{s}"] = hlo["flops"]
        wire[f"{a}:{s}"] = hlo["collective_wire_bytes"]
        by_kind[f"{a}:{s}"] = hlo["collective_by_kind"]
    plans = []
    for sets in spec["overrides"]:
        cfg = get_config("qwen2-moe-a2.7b")
        cfg, plan = apply_overrides(cfg, plan_for(cfg, get_shape("train_4k")), sets)
        plans.append({"plan": dataclasses.asdict(plan), "moe": dataclasses.asdict(cfg.moe)})
    print("REF " + json.dumps({"flops": flops, "wire": wire, "by_kind": by_kind,
                               "plans": plans}))
    """
)


def _jsonable(x):
    return json.loads(json.dumps(x))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's lower_cell FLOPs, collective wire bytes a device and
    their split by kind of PARITY_CELLS (smoke configs at the cells'
    shapes, PARITY_SMALL's at SMALL's, on a 2 x 2 host mesh) and its
    apply_overrides of OVERRIDES."""
    spec = {"tmp": str(tmp_path_factory.mktemp("ref_dryrun")), "cells": PARITY_CELLS,
            "small": {f"{a}:{s}": SMALL[s] for a, s in PARITY_SMALL}, "overrides": OVERRIDES}
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", _REF_CHILD, json.dumps(spec)], env=env,
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = next(ln for ln in out.stdout.splitlines() if ln.startswith("REF "))
    return json.loads(line[4:])


def _small_shape(n):
    return ShapeConfig(n, *SMALL[n], get_shape(n).kind) if n in SMALL else get_shape(n)


@pytest.fixture
def small_shapes(monkeypatch):
    monkeypatch.setattr(dryrun, "get_shape", _small_shape)


def _smoke_lower(arch, shape_name, mesh_shape=(2, 2), ops_file=None, cfg=None):
    from torch.distributed.device_mesh import init_device_mesh

    with fake_world(mesh_shape[0] * mesh_shape[1], device_type="cpu"):
        mesh = init_device_mesh("cpu", mesh_shape, mesh_dim_names=("data", "model"))
        return dryrun.lower_cell(arch, shape_name, mesh=mesh,
                                 cfg=cfg if cfg is not None else smoke(get_config(arch)),
                                 device_type="cpu", ops_file=ops_file)


def _smoke_outputs(arch, shape_name, mesh_shape=(2, 2)):
    """The outputs of ``shape_name``'s step of ``arch``'s smoke config on
    fake tensors over a fake (data, model) mesh, as ``lower_cell`` runs it."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distribution.sharding import axis_rules

    cfg, shape = smoke(get_config(arch)), dryrun.get_shape(shape_name)
    plan = plan_for(cfg, shape)
    with fake_world(mesh_shape[0] * mesh_shape[1], device_type="cpu"):
        mesh = init_device_mesh("cpu", mesh_shape, mesh_dim_names=("data", "model"))
        with FakeTensorMode(allow_non_fake_inputs=True):
            args, _, step, _ = dryrun._fake_inputs(get_model(cfg), cfg, shape, plan, mesh,
                                                   torch.device("cpu"))
            with axis_rules(plan.rules, mesh), implicit_replication():
                return cfg, step(*args)


# ---------------------------------------------------------------------------
# roofline arithmetic
# ---------------------------------------------------------------------------

def test_cells_are_the_references():
    assert cells() == jax_cells() and len(cells()) == 32


@pytest.mark.parametrize("arch,shape_name", jax_cells())
def test_model_flops_and_floor_equal_reference(arch, shape_name):
    cfg, shape = get_config(arch), get_shape(shape_name)
    jcfg, jshape = jax_get_config(arch), jax_get_shape(shape_name)
    assert roofline.model_flops(cfg, shape) == jax_roofline.model_flops(jcfg, jshape)
    for dev in (256, 512):
        assert (roofline.hbm_floor_bytes(cfg, shape, dev)
                == jax_roofline.hbm_floor_bytes(jcfg, jshape, dev))


def test_constants_are_an_h100s():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (989e12, 3.35e12, 50e9)
    assert roofline.RESULTS_DIR.name == "torch_dryrun"
    assert dryrun.RESULTS_DIR == roofline.RESULTS_DIR
    assert PERF_DIR.name == "torch_perf"


@pytest.mark.parametrize("arch,shape_name,devices", [
    ("olmo-1b", "train_4k", 256), ("deepseek-67b", "decode_32k", 512),
    ("mamba2-130m", "long_500k", 256), ("qwen2-moe-a2.7b", "prefill_32k", 512)])
def test_roofline_terms_equal_reference_with_its_constants(monkeypatch, arch, shape_name,
                                                           devices):
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(roofline, name, getattr(jax_roofline, name))
    rec = {"arch": arch, "shape": shape_name, "devices": devices,
           "hlo": {"flops": 3.1e13, "hbm_bytes": 7.7e11, "collective_wire_bytes": 2.9e9}}
    assert roofline.roofline_terms(rec) == jax_roofline.roofline_terms(rec)


def test_roofline_summarize_reads_records(monkeypatch, tmp_path):
    monkeypatch.setattr(roofline, "RESULTS_DIR", tmp_path)
    rec = {"arch": "olmo-1b", "shape": "decode_32k", "devices": 256,
           "hlo": {"flops": 1e10, "hbm_bytes": 5e9, "collective_wire_bytes": 1e6}}
    (tmp_path / "olmo-1b__decode_32k__singlepod.json").write_text(json.dumps(rec))
    (tmp_path / "olmo-1b__train_4k__singlepod.json").write_text(
        json.dumps({"arch": "olmo-1b", "shape": "train_4k", "error": "x"}))
    table = roofline.summarize()
    assert "| olmo-1b | decode_32k | **memory** |" in table
    assert "| olmo-1b | train_4k | ERROR |" in table


def test_apply_overrides_equal_reference(reference):
    for sets, ref in zip(OVERRIDES, reference["plans"]):
        cfg = get_config("qwen2-moe-a2.7b")
        cfg, plan = apply_overrides(cfg, plan_for(cfg, get_shape("train_4k")), dict(sets))
        assert _jsonable(dataclasses.asdict(plan)) == ref["plan"], sets
        assert _jsonable(dataclasses.asdict(cfg.moe)) == ref["moe"], sets
    with pytest.raises(KeyError, match="unknown override"):
        apply_overrides(get_config("olmo-1b"), plan_for(get_config("olmo-1b"),
                                                        get_shape("train_4k")), {"x": "1"})


# ---------------------------------------------------------------------------
# cache specs and meshes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_cache_specs_equal_reference(arch):
    cfg = smoke(get_config(arch))
    specs = get_model(cfg).cache_specs(cfg)
    assert specs == jax_get_model(jax_get_config(arch)).cache_specs(jax_get_config(arch))
    cache = get_model(cfg).init_cache(cfg, 2, 16, device="cpu")
    assert set(specs) == set(cache)
    assert all(len(specs[k]) == cache[k].ndim for k in cache)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_over_a_fake_world(multi_pod):
    n = 512 if multi_pod else 256
    with pytest.raises(ValueError, match="no process group"):
        make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    with fake_world(n, device_type="cpu"):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        assert mesh.size() == n
        assert mesh.mesh_dim_names == (("pod", "data", "model") if multi_pod
                                       else ("data", "model"))
        with pytest.raises(ValueError, match=f"has {n}"):  # the other mesh's size
            make_production_mesh(multi_pod=not multi_pod, device_type="cpu")
    assert not torch.distributed.is_initialized()


# ---------------------------------------------------------------------------
# lower_cell
# ---------------------------------------------------------------------------

REF_KEYS = {"arch", "shape", "kind", "fn", "mesh", "devices", "plan", "params", "active_params",
            "memory", "cost_analysis", "hlo", "timing_s"}


@pytest.mark.parametrize("kind", sorted(KIND_SHAPES))
@pytest.mark.parametrize("family", sorted(FAMILY_ARCHS))
def test_lower_cell_every_family_and_kind(small_shapes, family, kind):
    arch = FAMILY_ARCHS[family]
    rec = _smoke_lower(arch, KIND_SHAPES[kind])
    assert REF_KEYS <= set(rec) and "error" not in rec
    assert rec["kind"] == kind and rec["devices"] == 4
    assert rec["mesh"] == {"data": 2, "model": 2}
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes",
                                  "alias_bytes", "code_bytes"}
    assert set(rec["hlo"]) == {"flops", "hbm_bytes", "collective_wire_bytes",
                               "collective_by_kind", "collective_counts", "num_computations"}
    assert rec["hlo"]["flops"] > 0 and rec["hlo"]["hbm_bytes"] > 0
    assert rec["cost_analysis"] == {"flops": rec["hlo"]["flops"],
                                    "bytes_accessed": rec["hlo"]["hbm_bytes"]}
    mem = rec["memory"]
    assert mem["argument_bytes"] > 0 and mem["temp_bytes"] > 0
    if kind == "train":  # params and moments donated, written in place
        assert rec["fn"] == "train_step"
        assert rec["hlo"]["collective_wire_bytes"] > 0
        assert sum(rec["hlo"]["collective_counts"].values()) > 0
        assert 0 < mem["alias_bytes"] <= mem["output_bytes"]
    if kind == "decode":  # the cache, updated in place
        assert mem["alias_bytes"] > 0


_PARITY_RECORDS: dict = {}


def _parity_record(arch, shape_name):
    """The port's smoke record of a parity cell (PARITY_SMALL's at SMALL's
    sizes), traced once for the FLOPs and the wire-bytes tests."""
    key = (arch, shape_name)
    if key not in _PARITY_RECORDS:
        with pytest.MonkeyPatch.context() as mp:
            if key in PARITY_SMALL:
                mp.setattr(dryrun, "get_shape", _small_shape)
            _PARITY_RECORDS[key] = _smoke_lower(arch, shape_name)
    return _PARITY_RECORDS[key]


@pytest.mark.parametrize("arch,shape_name", PARITY_CELLS)
def test_lower_cell_flops_match_reference(reference, arch, shape_name):
    rec = _parity_record(arch, shape_name)
    assert rec["hlo"]["flops"] == pytest.approx(reference["flops"][f"{arch}:{shape_name}"],
                                                rel=0.02)


# the most collective wire bytes a device the port may move, over the
# reference's, a cell: 1.05x the ratio measured when the SSM, cross-cache
# and input-gradient repairs went in (rounded up), so that a repair undone
# or a collective added fails.  The two counts keep different conventions
# (the op tables): the reference charges its f32 collectives tied to a
# product at bf16 width and its collective permutes nothing; the port
# counts the dtypes that run.  Hence, by cause:
#  - train (0.55-0.71): the reference all-gathers FSDP weights (6.7e7 of
#    olmo-1b's bytes) and all-reduces their gradients where the port
#    reduce-scatters them;
#  - prefill (0.83-0.89): its embedding all-reduce, tied to no product,
#    counts at f32;
#  - decode (0.64-0.77): its decode attention's collectives are not halved;
#  - MoE (0.42-0.52): its dispatch buffer is an f32 scatter-add all-reduce;
#  - whisper-tiny train_4k (1.30): its biases stay f32, so the residual
#    stream and most activation all-reduces run in f32 on both sides (the
#    reference's einsums promote): 16 of the port's 18 (128, 4096, 64)
#    all-reduces, 2.15e9 of its 2.29e9 bytes; the reference charges its
#    1.69e9, some 25 such, at bf16 width.
WIRE_CEILING = {
    ("olmo-1b", "train_4k"): 0.75, ("olmo-1b", "prefill_32k"): 0.88,
    ("olmo-1b", "decode_32k"): 0.68,
    ("qwen2-moe-a2.7b", "train_4k"): 0.55, ("qwen2-moe-a2.7b", "prefill_32k"): 0.44,
    ("qwen2-moe-a2.7b", "decode_32k"): 0.47,
    ("qwen2-vl-72b", "train_4k"): 0.75, ("qwen2-vl-72b", "prefill_32k"): 0.88,
    ("qwen2-vl-72b", "decode_32k"): 0.70,
    ("mamba2-130m", "train_4k"): 0.59, ("mamba2-130m", "prefill_32k"): 0.91,
    ("mamba2-130m", "decode_32k"): 1.01,
    ("hymba-1.5b", "train_4k"): 0.66, ("hymba-1.5b", "prefill_32k"): 0.94,
    ("hymba-1.5b", "decode_32k"): 0.81,
    ("whisper-tiny", "train_4k"): 1.37, ("whisper-tiny", "prefill_32k"): 1.05,
    ("whisper-tiny", "decode_32k"): 0.68,
}


@pytest.mark.parametrize("arch,shape_name", PARITY_CELLS)
def test_lower_cell_wire_bytes_within_reference(reference, arch, shape_name):
    """The collective wire bytes a device of every family and kind, held
    to the reference's ``lower_cell`` of the same cell within the cell's
    ``WIRE_CEILING``: the SSM mixer gathers B and C once a layer (not xBC
    three times in f32), whisper's decode reads its cross cache on each
    rank's own slots, and projections of one input reduce their input
    gradients once."""
    rec = _parity_record(arch, shape_name)
    key = f"{arch}:{shape_name}"
    assert rec["hlo"]["collective_wire_bytes"] <= (
        WIRE_CEILING[arch, shape_name] * reference["wire"][key]), (
        rec["hlo"]["collective_by_kind"], reference["by_kind"][key])


def test_production_decode_cell_over_256_fake_ranks():
    rec = dryrun.lower_cell("olmo-1b", "decode_32k", device_type="cpu")
    assert not torch.distributed.is_initialized()  # its fake world is gone
    assert rec["devices"] == 256 and rec["mesh"] == {"data": 16, "model": 16}
    assert rec["plan"] == {"remat": "none", "q_block": None, "num_microbatches": 1}
    cfg = get_config("olmo-1b")
    # bf16 params: vocab and heads over the 16 model ranks, replicated over data
    assert rec["memory"]["argument_bytes"] > 2 * cfg.param_count() / 16
    # one token of 128 rows against a 32k cache: at least the analytic work a device
    mf = roofline.model_flops(cfg, get_shape("decode_32k")) / 256
    assert rec["hlo"]["flops"] >= 0.9 * mf
    terms = roofline.roofline_terms(rec)
    assert terms["bound"] in ("compute", "memory", "collective")
    assert terms["step_seconds"] == max(terms["compute_s"], terms["memory_s"],
                                        terms["collective_s"])


# OLMo-1B train_4k's FLOPs a device over 256 fake ranks as the card's torch
# 2.11 counted them (chip_smoke.py's dryrun phase)
OLMO_TRAIN_FLOPS = 4.4313e13


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen2-vl-72b"])
def test_decode_attention_runs_each_ranks_rows_on_its_own_slots(tmp_path, arch):
    """The smoke decode cell on the 2 x 2 mesh: the kv heads do not divide
    the plan's 16-rank model axis, so the plan shards the cache's slots over
    "model", and every attention product is of the rank's rows and every
    query head against the rank's half of the slots (flash decoding, as the
    reference's GSPMD partitions it): no rank scores every head against
    every slot, and no collective moves the cache."""
    ops = tmp_path / "ops.jsonl.gz"
    rec = _smoke_lower(arch, "decode_32k", ops_file=ops)
    cfg, shape = smoke(get_config(arch)), get_shape("decode_32k")
    rows, slots = shape.global_batch // 2, shape.seq_len // 2
    att = [r for r in dryrun._read_table(ops) if r["op"] == "aten.bmm.default"
           and any(d >= slots for a in r["args"][:2] for d in a["s"])]
    assert len(att) == 2 * cfg.num_layers  # scores and weighted values, a layer
    for r in att:
        (b, m, k), n = r["args"][0]["s"], r["args"][1]["s"][2]
        assert max(k, n) == slots and b * m == rows * cfg.num_heads
    assert rec["hlo"]["collective_wire_bytes"] < 1e6  # a gathered cache: 5.4e8


def test_olmo_train_over_256_fake_ranks_holds_no_whole_weight(tmp_path):
    """OLMo-1B train_4k over 256 fake ranks: each projection is of the
    rank's heads or d_ff columns (its weight gathered over the batch ranks
    only), so no product, forward or backward, holds a whole d_model x
    H * hd (2048 x 2048) weight or gradient, and the FLOPs a device are the
    card's torch 2.11 count (torch 2.13's DTensor plan gathered one a layer,
    +37%)."""
    ops = tmp_path / "ops.jsonl.gz"
    rec = dryrun.lower_cell("olmo-1b", "train_4k", device_type="cpu", ops_file=ops)
    d = get_config("olmo-1b").d_model
    whole = [r for r in dryrun._read_table(ops)
             if r["op"] in ("aten.mm.default", "aten.bmm.default")
             and any(t["s"][-2:] == [d, d] for t in r["args"][:2] + r["out"])]
    assert not whole
    assert rec["hlo"]["flops"] == pytest.approx(OLMO_TRAIN_FLOPS, rel=0.02)


def test_run_cell_writes_record_and_table_and_reanalyzes(monkeypatch, small_shapes, tmp_path):
    from torch.distributed.device_mesh import init_device_mesh

    monkeypatch.setattr(dryrun, "RESULTS_DIR", tmp_path)
    monkeypatch.setattr(dryrun, "get_config", lambda a: smoke(get_config(a)))
    with fake_world(4, device_type="cpu"):
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        rec = dryrun.run_cell("olmo-1b", "prefill_32k", False, mesh=mesh, device_type="cpu")
    path = tmp_path / "olmo-1b__prefill_32k__singlepod.json"
    table = tmp_path / "olmo-1b__prefill_32k__singlepod.ops.jsonl.gz"
    assert path.exists() and table.exists() and "error" not in rec
    assert json.loads(path.read_text())["hlo"] == rec["hlo"]
    stale = dict(rec, hlo={}, cost_analysis={})
    path.write_text(json.dumps(stale))
    assert dryrun.reanalyze_all() == 1
    assert json.loads(path.read_text())["hlo"] == rec["hlo"]
    # a cached record is read back, not traced again
    assert dryrun.run_cell("olmo-1b", "prefill_32k", False, mesh=None)["hlo"] == rec["hlo"]


# ---------------------------------------------------------------------------
# the models under a mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["dense", "moe", "ssm", "hybrid", "encdec"])
def test_train_step_shrinks_when_the_data_ranks_double(small_shapes, family):
    """2 x 2 to 4 x 2 ranks: a rank's train FLOPs fall by at least 1.8x and
    its temporaries fall (a MoE buffer or an SSD scan held whole on every
    data rank would keep them flat)."""
    arch = FAMILY_ARCHS[family]
    small, big = (_smoke_lower(arch, "train_4k", m) for m in ((2, 2), (4, 2)))
    assert small["hlo"]["flops"] >= 1.8 * big["hlo"]["flops"]
    assert big["memory"]["temp_bytes"] < small["memory"]["temp_bytes"]


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen2-moe-a2.7b", "qwen2-vl-72b"])
def test_prefill_kv_cache_is_sharded_over_batch_and_kv_heads(small_shapes, arch):
    """The stacked prefill cache of every layer is placed as ``cache_specs``
    names it: each rank holds its batch rows and kv heads (a buffer of the
    global shape on every rank is the fault)."""
    from torch.distributed.tensor import DTensor

    cfg, (_, cache) = _smoke_outputs(arch, "prefill_32k")
    B, S = SMALL["prefill_32k"][1], SMALL["prefill_32k"][0]
    K = cfg.num_kv_heads
    for name in ("k", "v"):
        t = cache[name]
        assert isinstance(t, DTensor)
        assert tuple(t.shape) == (cfg.num_layers, B, S, K, cfg.hd)
        assert tuple(t.to_local().shape) == (cfg.num_layers, B // 2, S,
                                             K // 2 if K % 2 == 0 else K, cfg.hd)


@pytest.mark.parametrize("arch,experts_local,mlp_local", [
    ("phi3.5-moe-42b-a6.6b", 2, 1),  # EP: experts over model
    ("qwen2-moe-a2.7b", 1, 2),       # TP-MoE: the experts' d_ff over model
])
def test_moe_dispatch_and_products_are_placed_over_groups_and_experts(
        small_shapes, monkeypatch, arch, experts_local, mlp_local):
    """Under a 2 x 2 mesh with 8 dispatch groups, each rank scatters into a
    buffer of its own groups and experts (EP) and multiplies only those:
    the local shapes the dispatch and the expert products see."""
    from repro_torch.models import moe as M

    seen = {}

    def spy(name, fn):
        def wrapped(*args, **kw):
            seen.setdefault(name, [list(a.shape) for a in args])
            return fn(*args, **kw)
        return wrapped

    for name in ("_dispatch", "_gate_up", "_down"):
        monkeypatch.setattr(M, name, spy(name, getattr(M, name)))
    cfg = smoke(get_config(arch))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dispatch_groups=8))
    _smoke_lower(arch, "train_4k", cfg=cfg)
    e = cfg.moe
    G, E, f = 8, e.num_experts, e.d_ff_expert
    xg, slot, keep, experts = seen["_dispatch"]
    assert xg[0] == G // 2 and slot[0] == G // 2 and experts == [E // experts_local]
    xe, wi_gate, wi_up = seen["_gate_up"]
    assert xe[:2] == [G // 2, E // experts_local]
    assert wi_gate == wi_up == [E // experts_local, cfg.d_model, f // mlp_local]
    h, wo = seen["_down"]
    assert h[:2] == [G // 2, E // experts_local] and h[3] == f // mlp_local
    assert wo == [E // experts_local, f // mlp_local, cfg.d_model]


def test_moe_one_group_combines_each_ranks_own_tokens(small_shapes, monkeypatch):
    """With one dispatch group (every config's default, as the reference's)
    every data rank holds the whole buffer, as the reference's plan holds
    it, but combines only the slot-requests of its own tokens."""
    from repro_torch.models import moe as M

    seen = []
    orig = M._combine

    def spy(ye, slot, keep, weights, experts, **kw):
        seen.append((list(ye.shape), list(slot.shape), list(weights.shape)))
        return orig(ye, slot, keep, weights, experts, **kw)

    monkeypatch.setattr(M, "_combine", spy)
    cfg = smoke(get_config("qwen2-moe-a2.7b"))
    _smoke_lower("qwen2-moe-a2.7b", "train_4k", cfg=cfg)
    S, B = SMALL["train_4k"]
    T, k = S * B, cfg.moe.top_k
    ye, slot, weights = seen[0]
    assert ye[0] == 1 and ye[1] == cfg.moe.num_experts  # the whole buffer
    assert slot == [1, T * k // 2] and weights == [1, T // 2, k]  # the rank's tokens


def test_plain_ssd_runs_on_each_ranks_rows_and_heads(small_shapes, tmp_path):
    """mamba2's plain SSD under a 2 x 2 mesh: every chunk product (a bmm
    over batch x heads) is of the rank's own rows and heads, so no chunk
    product runs on gathered tensors."""
    ops = tmp_path / "ops.jsonl.gz"
    _smoke_lower("mamba2-130m", "train_4k", ops_file=ops)
    cfg = smoke(get_config("mamba2-130m"))
    H = cfg.ssm.n_heads(cfg.d_model)
    local = SMALL["train_4k"][1] // 2 * H // 2
    bmms = [r["args"][0]["s"][0] for r in dryrun._read_table(ops) if r["op"] == "aten.bmm.default"]
    assert bmms and max(bmms) <= local


def test_whisper_multipod_train_gathers_no_logits_gradient_over_the_batch(tmp_path):
    """whisper-tiny train_4k over 512 fake ranks (its 51865-wide vocab
    divides no model axis, so the vocab is whole on every rank): no
    all-gather over the 32 batch ranks yields the global batch's logits or
    their gradient, and the unembedding's weight gradient is a product of
    the rank's own rows."""
    ops = tmp_path / "ops.jsonl.gz"
    rec = dryrun.lower_cell("whisper-tiny", "train_4k", multi_pod=True, device_type="cpu",
                            ops_file=ops)
    assert "error" not in rec and rec["devices"] == 512
    shape, V = get_shape("train_4k"), get_config("whisper-tiny").vocab_size
    table = dryrun._read_table(ops)
    gathers = [r["out"][0]["s"] for r in table if r.get("coll") == "all-gather"]
    assert not [s for s in gathers if s[0] == shape.global_batch and s[-1] == V]
    rows = shape.global_batch // 32 * shape.seq_len
    wgrad = [r["args"][0]["s"] for r in table if r["op"] == "aten.mm.default"
             and r["args"][1]["s"][-1] == V and r["args"][0]["s"][0] != r["args"][1]["s"][0]]
    assert all(a[1] <= rows for a in wgrad)


def test_cross_entropy_is_vocab_parallel_under_a_sharded_vocab(small_shapes, tmp_path):
    """olmo's train step over 4 x 2 ranks (the smoke vocab over the 2 model
    ranks): no all-gather yields logits or their gradient, of a rank's
    columns or of the whole vocab: the cross-entropy combines each rank's
    maximum, sum of exponentials and gold logit over the vocab ranks."""
    ops = tmp_path / "ops.jsonl.gz"
    _smoke_lower("olmo-1b", "train_4k", (4, 2), ops_file=ops)
    V, (S, B) = smoke(get_config("olmo-1b")).vocab_size, SMALL["train_4k"]
    logits_like = [r["out"][0]["s"] for r in dryrun._read_table(ops)
                   if r.get("coll") == "all-gather" and len(r["out"][0]["s"]) == 3
                   and r["out"][0]["s"][1] == S and r["out"][0]["s"][-1] in (V, V // 2)]
    assert not logits_like
