"""Heads that do not divide the model axis, run in head groups as the
reference's GSPMD runs them, and the vocab-parallel embedding lookup.

With H heads over a model axis of m ranks, H % m != 0, the plan keeps the
heads whole; the reference's GSPMD runs them in g = gcd(H, m) groups of
m / g ranks, each rank its group's H / g heads (``layers.head_groups``),
and the out-projection on each rank's own 1/m of the columns.  The smoke
configs here have 6 heads (whisper-tiny MHA, starcoder2-7b over 2 kv
heads) or 6 SSM heads (mamba2-130m and hymba-1.5b at d_model 48) on a
(1, 4) mesh: g = 2 groups of 2 ranks, 3 heads a rank.

* FLOPs and wire bytes: the port's ``lower_cell`` over a fake (1, 4)
  world against the reference's on ``make_host_mesh(1, 4)`` (4 forced XLA
  host devices, in a subprocess), train_4k and prefill_32k at ``SMALL``'s
  sizes: FLOPs within 2%, wire bytes a device within a ceiling a cell
  (``WIRE_CEILING``).
* values on four gloo ranks as a (1, 4) mesh (``tests/_torch_ranks.py``):
  attention with its projections, the SSM mixer, the embedding with the
  smoke vocab of 256 sharded over the 4 ranks, each model's loss and a
  prefill's cache, outputs and gradients against one device's, and the
  shapes each rank's attention, scan and lookup see.
* wire bytes: the smoke qwen2-vl-72b decode_32k step's embedding moves no
  more than its (B, S, D) all-reduce (the table is not gathered).
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest

from _torch_ranks import run_ranks
from repro_torch.configs import get_config, get_shape, smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_world

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ARCHS = ("whisper-tiny", "starcoder2-7b", "mamba2-130m", "hymba-1.5b")
SHAPES = ("train_4k", "prefill_32k")
SMALL = {"train_4k": (64, 8), "prefill_32k": (64, 8)}

# the smoke configs with 6 heads (or 6 SSM heads: d_inner 96 of head_dim 16)
_CONFIGS = """
def six_heads(cfg, arch):
    if arch == "whisper-tiny":
        return dataclasses.replace(cfg, num_heads=6, num_kv_heads=6)
    if arch == "starcoder2-7b":
        return dataclasses.replace(cfg, num_heads=6, num_kv_heads=2)
    return dataclasses.replace(cfg, d_model=48)
"""
exec(_CONFIGS)  # noqa: S102 - the same definition the children run

_REF_CHILD = """
import dataclasses, json, os, sys
from pathlib import Path
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           + os.environ.get("XLA_FLAGS", ""))
import repro.launch.dryrun as D
from repro.configs import get_config, get_shape, smoke
from repro.configs.base import ShapeConfig
from repro.launch.mesh import make_host_mesh
""" + _CONFIGS + """
spec = json.loads(sys.argv[1])
D.RESULTS_DIR = Path(spec["tmp"]) / "dryrun"
D.get_shape = lambda n: ShapeConfig(n, *spec["small"][n], get_shape(n).kind)
out = {"flops": {}, "wire": {}, "by_kind": {}}
for a in spec["archs"]:
    D.get_config = lambda _a, a=a: six_heads(smoke(get_config(a)), a)
    for s in spec["shapes"]:
        hlo = D.lower_cell(a, s, mesh=make_host_mesh(1, 4))["hlo"]
        out["flops"][f"{a}:{s}"] = hlo["flops"]
        out["wire"][f"{a}:{s}"] = hlo["collective_wire_bytes"]
        out["by_kind"][f"{a}:{s}"] = hlo["collective_by_kind"]
print("REF " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's lower_cell FLOPs, collective wire bytes a device and
    their split by kind of the six-head configs at SMALL's sizes on a
    (1, 4) host mesh."""
    spec = {"tmp": str(tmp_path_factory.mktemp("ref_groups")), "archs": ARCHS,
            "shapes": SHAPES, "small": SMALL}
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", _REF_CHILD, json.dumps(spec)], env=env,
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = next(ln for ln in out.stdout.splitlines() if ln.startswith("REF "))
    return json.loads(line[4:])


def _lower(arch, shape_name, mesh_shape=(1, 4), cfg=None, ops_file=None):
    from torch.distributed.device_mesh import init_device_mesh

    with fake_world(mesh_shape[0] * mesh_shape[1], device_type="cpu"):
        mesh = init_device_mesh("cpu", mesh_shape, mesh_dim_names=("data", "model"))
        return dryrun.lower_cell(arch, shape_name, mesh=mesh, device_type="cpu",
                                 cfg=cfg if cfg is not None else six_heads(
                                     smoke(get_config(arch)), arch),
                                 ops_file=ops_file)


_RECORDS: dict = {}


def _record(arch, shape_name):
    """The port's record of a six-head cell at SMALL's sizes over (1, 4),
    traced once for the FLOPs and the wire-bytes tests."""
    if (arch, shape_name) not in _RECORDS:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(dryrun, "get_shape",
                       lambda n: ShapeConfig(n, *SMALL[n], get_shape(n).kind))
            _RECORDS[arch, shape_name] = _lower(arch, shape_name)
    return _RECORDS[arch, shape_name]


@pytest.mark.parametrize("shape_name", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_head_groups_flops_match_reference(reference, arch, shape_name):
    """Each rank computes its group's 3 of the 6 heads, so the FLOPs a
    device are the reference's (every head on every rank: 1.19-1.45x)."""
    rec = _record(arch, shape_name)
    assert rec["hlo"]["flops"] == pytest.approx(reference["flops"][f"{arch}:{shape_name}"],
                                                rel=0.02)


# the most collective wire bytes a device the port may move, over the
# reference's, a cell: 1.05x the ratio measured when the head-group
# gathers went over a group's own ranks (rounded up), so that a repair
# undone or a collective added fails.  All are below 1.0 (the op tables):
# the reference all-gathers 1.1-6.6x the port's bytes (its GSPMD's
# resharding in the group layout; not examined collective by collective)
# and charges its f32 collectives tied to a product at bf16 width, where
# the port counts the dtypes that run (whisper-tiny's and starcoder2-7b's
# biases keep their activations f32).
WIRE_CEILING = {
    ("whisper-tiny", "train_4k"): 0.84, ("whisper-tiny", "prefill_32k"): 0.73,
    ("starcoder2-7b", "train_4k"): 0.50, ("starcoder2-7b", "prefill_32k"): 0.66,
    ("mamba2-130m", "train_4k"): 0.69, ("mamba2-130m", "prefill_32k"): 0.86,
    ("hymba-1.5b", "train_4k"): 0.68, ("hymba-1.5b", "prefill_32k"): 0.76,
}


@pytest.mark.parametrize("arch,shape_name", [(a, s) for a in ARCHS for s in SHAPES])
def test_head_groups_wire_bytes_within_reference(reference, arch, shape_name):
    """Head groups move what the reference's GSPMD moves: a group's heads
    gathered over its own ranks (not all 4), the SSM's x projected on its
    ranks' columns and B and C alone gathered, a prefill's state gathered
    over one rank of each group; the wire bytes a device within the
    cell's ``WIRE_CEILING`` of the reference's."""
    rec = _record(arch, shape_name)
    key = f"{arch}:{shape_name}"
    assert rec["hlo"]["collective_wire_bytes"] <= (
        WIRE_CEILING[arch, shape_name] * reference["wire"][key]), (
        rec["hlo"]["collective_by_kind"], reference["by_kind"][key])


_CHILD = """
import dataclasses, functools
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_config, smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.distribution.recipes import plan_for
from repro_torch.distribution.sharding import axis_rules, sharding_for, tree_sharding
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import get_model, layers as L, ssm as SSM
from repro_torch.pytree import tree_flatten, tree_unflatten
""" + _CONFIGS + """
mesh = make_host_mesh(1, 4, device_type="cpu")
B, S = 4, 8
ARCHS = ("whisper-tiny", "starcoder2-7b", "mamba2-130m", "hymba-1.5b")


def rules_for(cfg, kind):
    return plan_for(cfg, ShapeConfig(kind, seq_len=S, global_batch=B, kind=kind)).rules


def put(tree, specs, rules):
    sh = tree_flatten(tree_sharding(mesh, specs, rules, tree))[0]
    flat, tdef = tree_flatten(tree)
    return tree_unflatten(tdef, [s.distribute(x.detach().clone()).requires_grad_(x.is_floating_point())
                                 for x, s in zip(flat, sh)])


def leaves(tree):
    return tree_flatten(tree)[0]


def whole(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def err(a, b):
    return max(float((whole(x) - y).detach().abs().max()) for x, y in zip(a, b))


def grads(loss, xs):
    return torch.autograd.grad(loss, xs, allow_unused=True)


def seen_by(mod, name):
    seen, orig = [], getattr(mod, name)
    def spy(*xs, **kw):
        seen.append([list(x.shape) for x in xs if isinstance(x, torch.Tensor)])
        return orig(*xs, **kw)
    setattr(mod, name, spy)
    return seen, lambda: setattr(mod, name, orig)


def compare(fn, tree, specs, rules, extra=(), extra_names=()):
    # fn(tree, *extra) -> output: values and gradients of (output * w).sum()
    # on one device and on the mesh
    ref = [t.detach().clone().requires_grad_(t.is_floating_point()) for t in leaves(tree)]
    tdef = tree_flatten(tree)[1]
    ex = [t.detach().clone().requires_grad_(t.is_floating_point()) for t in extra]
    want = fn(tree_unflatten(tdef, ref), *ex)
    w = torch.randn(want.shape, generator=torch.Generator().manual_seed(7))
    diff = [t for t in ref + ex if t.requires_grad]
    want_g = grads((want * w).sum(), diff)
    with axis_rules(rules, mesh), implicit_replication():
        dtree = put(tree, specs, rules)
        dex = [sharding_for(mesh, n, rules, shape=tuple(t.shape)).distribute(t.detach().clone())
               .requires_grad_(t.is_floating_point()) for t, n in zip(extra, extra_names)]
        got = fn(dtree, *dex)
        ddiff = [t for t in leaves(dtree) + dex if t.requires_grad]
        got_g = grads((whole(got) * w).sum(), ddiff)
    return err([got], [want]), err([g for g in got_g if g is not None],
                                   [g for g in want_g if g is not None])


gen = lambda s: torch.Generator().manual_seed(s)  # noqa: E731

# attention with its projections: whisper-tiny (MHA) and starcoder2-7b (6 over 2)
for arch in ("whisper-tiny", "starcoder2-7b"):
    cfg = six_heads(smoke(get_config(arch)), arch)
    p = L.tree_map(lambda leaf: L.init_leaf(leaf, generator=gen(3), device="cpu"), L.attn_layout(cfg))
    x = torch.randn(B, S, cfg.d_model, generator=gen(4))

    def block(p, x):
        q, k, v = L.qkv_proj(cfg, p, x)
        return L.out_proj(cfg, p, L.attention(q, k, v, causal=True, impl="ref"))

    seen, undo = seen_by(L, "_plain_attention")
    e, ge = compare(block, p, L.attn_specs(cfg), rules_for(cfg, "train"), (x,),
                    (("batch", "seq", "embed"),))
    undo()
    report({"what": "attention", "arch": arch, "err": e, "gerr": ge, "seen": seen[-1]})

# the SSM mixer: out and gradients, and a prefill's state
for arch in ("mamba2-130m", "hymba-1.5b"):
    cfg = six_heads(smoke(get_config(arch)), arch)
    p = SSM.init_ssm(cfg, generator=gen(5), device="cpu")
    x = torch.randn(B, S, cfg.d_model, generator=gen(6))
    seen, undo = seen_by(SSM, "ssd_chunked")
    e, ge = compare(lambda p, x: SSM.ssm_block(cfg, p, x, impl="ref"), p, SSM.ssm_specs(cfg),
                    rules_for(cfg, "train"), (x,), (("batch", "seq", "embed"),))
    undo()
    _, want = SSM.ssm_prefill(cfg, p, x, impl="ref")
    rules = rules_for(cfg, "prefill")
    with axis_rules(rules, mesh), implicit_replication(), torch.no_grad():
        _, got = SSM.ssm_prefill(cfg, put(p, SSM.ssm_specs(cfg), rules),
                                 sharding_for(mesh, ("batch", "seq", "embed"), rules,
                                              shape=tuple(x.shape)).distribute(x), impl="ref")
    report({"what": "ssm", "arch": arch, "err": e, "gerr": ge, "seen": seen[-1],
            "state": list(got["state"].shape), "state_err": err([got["state"]], [want["state"]])})

# the embedding: the smoke vocab of 256 over the 4 model ranks
cfg = smoke(get_config("olmo-1b"))
table = {"table": torch.randn(cfg.vocab_size, cfg.d_model, generator=gen(8))}
tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen(9))
seen, undo = seen_by(L, "_lookup_of_shard")
e, ge = compare(lambda p, t: L.embed(cfg, p, t), table, {"table": ("p_vocab", "p_embed")},
                rules_for(cfg, "train"), (tokens,), (("batch", "seq"),))
undo()
report({"what": "embed", "err": e, "gerr": ge, "seen": seen[-1]})

# the unembedding with a vocab of 250, which the 4 model ranks do not divide:
# the logits whole on every rank, the weight's gradient a block of rows a rank
cfg = dataclasses.replace(smoke(get_config("olmo-1b")), vocab_size=250)
key = "table" if cfg.tie_embeddings else "unembed"
w = {key: torch.randn(L.embed_layout(cfg)[key][0], generator=gen(10))}
x = torch.randn(B, S, cfg.d_model, generator=gen(11))
seen, undo = seen_by(L, "_rows_grad")
e, ge = compare(lambda p, x: L.unembed(cfg, p, x), w, {key: L.embed_specs(cfg)[key]},
                rules_for(cfg, "train"), (x,), (("batch", "seq", "embed"),))
undo()
report({"what": "unembed", "err": e, "gerr": ge, "seen": seen[-1]})

# the backward on a thread of its own, as the autograd engine runs a CUDA
# tensor's (the axis rules are this thread's): a checkpoint's recompute must
# lay the layers out as the forward did
import threading
for arch in ("whisper-tiny", "mamba2-130m"):
    cfg = six_heads(smoke(get_config(arch)), arch)
    m = get_model(cfg)
    params = m.init(cfg, generator=gen(0), device="cpu", dtype=torch.float32)
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen(1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.encdec is not None:
        batch["frames"] = torch.randn(B, cfg.encdec.encoder_seq, cfg.d_model, generator=gen(2))
    ref = [t.detach().clone().requires_grad_() for t in leaves(params)]
    tdef = tree_flatten(params)[1]
    want = torch.autograd.grad(m.loss_fn(cfg, tree_unflatten(tdef, ref), batch, remat="full",
                                         impl="ref"), ref)
    rules = rules_for(cfg, "train")
    with axis_rules(rules, mesh), implicit_replication():
        dp = put(params, m.param_specs(cfg), rules)
        db = {k: sharding_for(mesh, ("batch", "seq") if k != "frames" else ("batch", "frames",
                                                                          "embed"), rules,
                              shape=tuple(v.shape)).distribute(v) for k, v in batch.items()}
        loss = m.loss_fn(cfg, dp, db, remat="full", impl="ref")
    box = {}

    def backward():
        try:
            with implicit_replication():
                box["g"] = torch.autograd.grad(whole(loss), leaves(dp))
        except Exception as e:  # noqa: BLE001 - reported to the test
            box["error"] = repr(e)[:500]

    th = threading.Thread(target=backward)
    th.start()
    th.join()
    report({"what": "recompute", "arch": arch, "error": box.get("error"),
            "gerr": err(box["g"], want) if "g" in box else None})

# each model's loss and gradients, and a prefill's cache
for arch in ARCHS:
    cfg = six_heads(smoke(get_config(arch)), arch)
    m = get_model(cfg)
    params = m.init(cfg, generator=gen(0), device="cpu", dtype=torch.float32)
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen(1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.encdec is not None:
        batch["frames"] = torch.randn(B, cfg.encdec.encoder_seq, cfg.d_model, generator=gen(2))
    names = {k: ("batch", "seq") if k != "frames" else ("batch", "frames", "embed") for k in batch}

    def loss(params, *xs):
        return m.loss_fn(cfg, params, dict(zip(batch, xs)), impl="ref")

    e, ge = compare(loss, params, m.param_specs(cfg), rules_for(cfg, "train"),
                    tuple(batch.values()), tuple(names[k] for k in batch))
    out = {"what": "loss", "arch": arch, "err": e, "gerr": ge}
    if cfg.family != "ssm":
        kw = {"return_kv": True, "last_only": True, "impl": "ref"}
        pre = {k: v for k, v in batch.items() if k != "labels"}
        _, _, want = m.forward(cfg, params, pre, **kw)
        rules = rules_for(cfg, "prefill")
        with axis_rules(rules, mesh), implicit_replication(), torch.no_grad():
            dp = put(params, m.param_specs(cfg), rules)
            dpre = {k: sharding_for(mesh, names[k], rules, shape=tuple(v.shape)).distribute(v)
                    for k, v in pre.items()}
            _, _, got = m.forward(cfg, dp, dpre, **kw)
        out["cache_shapes"] = [list(t.shape) for t in leaves(got)]
        out["cache_err"] = err(leaves(got), leaves(want))
    report(out)
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(_CHILD, 4, tmp_path_factory.mktemp("head_groups"), timeout=600)


TOL = 1e-5


@pytest.mark.parametrize("i,arch,kv", [(0, "whisper-tiny", 3), (1, "starcoder2-7b", 1)])
def test_attention_in_head_groups_matches_one_device(ranks, i, arch, kv):
    for rank in ranks:
        r = rank[i]
        assert r["what"] == "attention" and r["arch"] == arch
        # each rank: its 4 rows, its group's 3 query heads and the kv heads they read
        assert r["seen"] == [[4, 8, 3, 16], [4, 8, kv, 16], [4, 8, kv, 16]]
        assert r["err"] < TOL and r["gerr"] < TOL, r


@pytest.mark.parametrize("i,arch", [(2, "mamba2-130m"), (3, "hymba-1.5b")])
def test_ssm_mixer_in_head_groups_matches_one_device(ranks, i, arch):
    for rank in ranks:
        r = rank[i]
        assert r["what"] == "ssm" and r["arch"] == arch
        # the scan on the rank's group's 3 of 6 heads, one copy of B and C
        assert r["seen"][0] == [4, 8, 3, 16] and r["seen"][3] == [4, 8, 1, 16]
        assert r["state"] == [4, 6, 16, 16]  # the prefill's state: the heads whole
        assert r["err"] < TOL and r["gerr"] < TOL and r["state_err"] < TOL, r


def test_embedding_is_vocab_parallel_and_matches_one_device(ranks):
    for rank in ranks:
        r = rank[4]
        assert r["what"] == "embed"
        assert r["seen"][1] == [64, 64]  # each rank looks up in its own 64 rows
        assert r["err"] < TOL and r["gerr"] < TOL, r


def test_unembedding_weight_gradient_is_split_over_the_model_ranks(ranks):
    """A vocab the model ranks do not divide: each rank computes the whole
    logits (as the reference), but the gradient of only its 16 of the
    weight's 64 rows, from its 4 x 8 rows of x (the reference's GSPMD splits
    it the same way); values and gradients equal one device's."""
    for rank in ranks:
        r = rank[5]
        assert r["what"] == "unembed"
        assert r["seen"] == [[4, 8, 64], [4, 8, 250], [16]]
        assert r["err"] < TOL and r["gerr"] < TOL, r


@pytest.mark.parametrize("i,arch", [(6, "whisper-tiny"), (7, "mamba2-130m")])
def test_recompute_lays_out_heads_as_the_forward_did(ranks, i, arch):
    """The backward on another thread (the autograd engine's thread for a
    CUDA tensor, where this thread's axis rules are not set) under remat
    full: each checkpointed layer recomputes in the forward's head groups,
    and the gradients equal one device's."""
    for rank in ranks:
        r = rank[i]
        assert r["what"] == "recompute" and r["arch"] == arch
        assert r["error"] is None and r["gerr"] < TOL, r


@pytest.mark.parametrize("i,arch", [(8 + j, a) for j, a in enumerate(ARCHS)])
def test_loss_and_prefill_cache_in_head_groups_match_one_device(ranks, i, arch):
    for rank in ranks:
        r = rank[i]
        assert r["what"] == "loss" and r["arch"] == arch
        assert r["err"] < TOL and r["gerr"] < TOL, r
        if "cache_err" in r:  # the cache's heads whole, as one device's
            assert r["cache_err"] < TOL, r


def test_decode_embedding_moves_no_more_than_its_all_reduce(tmp_path):
    """The smoke qwen2-vl-72b decode step on a 2 x 2 mesh: the table's vocab
    is sharded over the model ranks, so the lookup is vocab-parallel: its
    collectives (the step's before its first product) move no more wire
    bytes than one all-reduce of the (B, 1, D) rows, and no gather moves
    the table (a gathered table is most of the production cell's wire
    bytes a device: 2.35 of 2.41 GB)."""
    from repro_torch.analysis.op_analysis import _wire_bytes

    ops = tmp_path / "ops.jsonl.gz"
    cfg = smoke(get_config("qwen2-vl-72b"))
    _lower("qwen2-vl-72b", "decode_32k", (2, 2), cfg=cfg, ops_file=ops)
    table = dryrun._read_table(ops)
    first = next(i for i, r in enumerate(table) if r["op"] in ("aten.mm.default",
                                                              "aten.bmm.default"))
    lookup = [r for r in table[:first] if r.get("coll")]
    rows = get_shape("decode_32k").global_batch // 2 * cfg.d_model * 2  # bf16 bytes
    assert lookup and sum(_wire_bytes(r) for r in lookup) <= 2 * (2 - 1) / 2 * rows
    assert not [r for r in table if r.get("coll") == "all-gather"
                and r["out"][0]["s"] in ([cfg.vocab_size, cfg.d_model],
                                         [cfg.vocab_size // 2, cfg.d_model])]
