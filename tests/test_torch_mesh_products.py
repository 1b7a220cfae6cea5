"""The products ``DTensor`` no longer places, held to the plain path's
values on a real mesh: four gloo ranks on the CPU make a (2, 2) ("data",
"model") mesh (``tests/_torch_ranks.py``).

* decode under the plan's decode rules: the smoke configs' kv heads do not
  divide the plan's model axis, so the cache's slots are sharded over
  "model" (flash decoding, ``layers._slot_attend``) and each rank writes a
  token only into its own slots (``layers.cache_update``); the logits and
  the cache of several steps, with tokens written in both ranks' halves
  of the cache, equal one device's;
* attention whose query heads are sharded over "model" while its single
  kv head is replicated (``layers._kv_for_query_heads``): each rank's plain
  attention sees its own query heads and the one kv head they read, and
  the values and the gradients equal the plain path's;
* ``layers.linear`` with a column-, a row-parallel and an FSDP weight: the
  rank's columns, its part of the sum, and the weight's gradient summed
  over the batch ranks, equal to the plain product's.
"""
import pytest

from _torch_ranks import run_ranks

_CHILD = """
import functools
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_config, smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.distribution.recipes import plan_for
from repro_torch.distribution.sharding import axis_rules, sharding_for, tree_sharding
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import get_model, layers as L
from repro_torch.pytree import tree_flatten, tree_unflatten

mesh = make_host_mesh(2, 2, device_type="cpu")
B, S, POSITIONS = 4, 16, (0, 1, 2, 7, 8, 9, 15)


def put(tree, specs, rules):
    sh = tree_flatten(tree_sharding(mesh, specs, rules, tree))[0]
    flat, tdef = tree_flatten(tree)
    return tree_unflatten(tdef, [s.distribute(x) for x, s in zip(flat, sh)])


for arch in ("olmo-1b", "qwen2-vl-72b"):
    cfg = smoke(get_config(arch))
    m = get_model(cfg)
    rules = plan_for(cfg, ShapeConfig("d", seq_len=S, global_batch=B, kind="decode")).rules
    params = m.init(cfg, generator=torch.Generator().manual_seed(0), device="cpu",
                    dtype=torch.float32)
    toks = torch.randint(0, cfg.vocab_size, (B, len(POSITIONS)),
                         generator=torch.Generator().manual_seed(1))
    cache = m.init_cache(cfg, B, S, device="cpu", dtype=torch.float32)
    want = []
    for i, pos in enumerate(POSITIONS):
        logits, cache = m.decode_step(cfg, params, cache, toks[:, i:i + 1], pos)
        want.append(logits)
    with axis_rules(rules, mesh), implicit_replication():  # as the serving step runs
        dparams = put(params, m.param_specs(cfg), rules)
        dcache = put(m.init_cache(cfg, B, S, device="cpu", dtype=torch.float32),
                     m.cache_specs(cfg), rules)
        tok_sh = sharding_for(mesh, ("batch", "seq"), rules, shape=(B, 1))
        got = []
        for i, pos in enumerate(POSITIONS):
            logits, dcache = m.decode_step(cfg, dparams, dcache,
                                           tok_sh.distribute(toks[:, i:i + 1].contiguous()), pos)
            got.append(logits.full_tensor())
    report({"arch": arch, "placements": [str(p) for p in dcache["k"].placements],
            "local": list(dcache["k"].to_local().shape),
            "err": max(float((a - b).abs().max()) for a, b in zip(got, want)),
            "cache_err": max(float((dcache[n].full_tensor() - cache[n]).abs().max())
                             for n in ("k", "v"))})

# attention: 4 query heads over the 2 model ranks, 1 kv head replicated
g = torch.Generator().manual_seed(2)
q = torch.randn(4, 8, 4, 16, generator=g)
k, v = (torch.randn(4, 8, 1, 16, generator=g) for _ in range(2))
w = torch.randn(4, 8, 4, 16, generator=g)
seen, orig = [], L._plain_attention
def spy(*xs, **kw):
    seen.append([list(x.shape) for x in xs])
    return orig(*xs, **kw)
L._plain_attention = spy
refs = [t.clone().requires_grad_() for t in (q, k, v)]
want = L.attention(*refs, causal=True, impl="ref")
(want * w).sum().backward()
pls = ([Shard(0), Shard(2)], [Shard(0), Replicate()], [Shard(0), Replicate()])
ds = [distribute_tensor(t.clone().requires_grad_(), mesh, pl) for t, pl in zip((q, k, v), pls)]
got = L.attention(*ds, causal=True, impl="ref")
(got.full_tensor() * w).sum().backward()
report({"seen": seen[-1], "placements": [str(p) for p in got.placements],
        "err": float((got.full_tensor() - want).abs().max()),
        "gerr": max(float((d.grad.full_tensor() - r.grad).abs().max())
                    for d, r in zip(ds, refs))})
L._plain_attention = orig

# linear: x (B, S, D) rows over data; weights column-parallel (over model on
# their columns, FSDP over data on their rows) and row-parallel
x = torch.randn(4, 6, 8, generator=g)
w_col, w_row = torch.randn(8, 6, generator=g), torch.randn(6, 8, generator=g)
refs = [t.clone().requires_grad_() for t in (x, w_col, w_row)]
want = L.linear(L.linear(refs[0], refs[1]), refs[2])
want.sum().backward()
pls = ([Shard(0), Replicate()], [Shard(0), Shard(1)], [Replicate(), Shard(0)])
ds = [distribute_tensor(t.clone().requires_grad_(), mesh, pl) for t, pl in zip((x, w_col, w_row), pls)]
h = L.linear(ds[0], ds[1])
got = L.linear(h, ds[2])
got.full_tensor().sum().backward()
report({"col": [str(p) for p in h.placements], "col_local": list(h.to_local().shape),
        "row": [str(p) for p in got.placements],
        "err": float((got.full_tensor() - want).abs().max()),
        "gerr": max(float((d.grad.full_tensor() - r.grad).abs().max())
                    for d, r in zip(ds, refs))})
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(_CHILD, 4, tmp_path_factory.mktemp("mesh_products"), timeout=300)


@pytest.mark.parametrize("i,arch", [(0, "olmo-1b"), (1, "qwen2-vl-72b")])
def test_torch_decode_over_sharded_slots_matches_one_device(ranks, i, arch):
    for rank in ranks:
        r = rank[i]
        assert r["arch"] == arch
        # (L, B, S, K, hd): rows over data, slots over model, heads whole
        assert r["placements"] == ["S(1)", "S(2)"]
        assert r["local"][1:3] == [2, 8]
        assert r["err"] < 1e-5 and r["cache_err"] < 1e-5, r


def test_torch_attention_takes_each_ranks_kv_head(ranks):
    for rank in ranks:
        r = rank[2]
        # the rank's 2 rows, its 2 query heads and the 1 kv head they read
        assert r["seen"] == [[2, 8, 2, 16], [2, 8, 1, 16], [2, 8, 1, 16]]
        assert r["placements"] == ["S(0)", "S(2)"]
        assert r["err"] < 1e-5 and r["gerr"] < 1e-5, r


def test_torch_linear_places_columns_sums_and_fsdp_gradients(ranks):
    for rank in ranks:
        r = rank[3]
        assert r["col"] == ["S(0)", "S(2)"] and r["col_local"] == [2, 6, 3]
        assert r["row"] == ["S(0)", "P(sum)"]
        assert r["err"] < 1e-5 and r["gerr"] < 1e-5, r
