"""The mesh paths that move no more than the reference's GSPMD, held to
one device's values on four gloo ranks (``tests/_torch_ranks.py``).

* the SSM mixer (mamba2-130m and hymba-1.5b smoke, train and prefill
  rules) on a 2 x 2 mesh: x projected, convolved and scanned on the ranks
  of its heads, B and C alone gathered, once a layer; out, gradients and a
  prefill's state and conv window equal one device's;
* the SSM decode step on a 2 x 2 mesh: one all-to-all sends each rank its
  x columns and its share of B and C, B and C alone gathered; out and new
  cache equal one device's;
* the same in head groups (six SSM heads over the (1, 4) mesh's 4 ranks):
  x gathered over its group's 2 ranks, not all 4; the decode moves x, B
  and C once;
* whisper-tiny's decode step over a cache whose slots the plan shards
  (its 4 kv heads do not divide the production model axis): the cross
  K/V read on each rank's own slots, never gathered; logits and cache
  equal one device's;
* the loss and gradients of olmo-1b, whisper-tiny, mamba2-130m and
  hymba-1.5b on a 2 x 2 mesh equal one device's, and the projections of
  one input (q, k and v; gate and up; z, xBC and dt; the cross K/V of
  every decoder layer) reduce their input gradients once: olmo-1b's step
  runs four (B, S, D) all-reduces a layer, not seven (``REDUCTIONS``).

The collectives are read from the op table of each rank's run
(``analysis.op_analysis.Recorder`` on real tensors).  Values agree within
1e-5 of the larger of 1 and the largest magnitude of one device's tensor
(the gradients reach 46 here; f32 sums in another order differ by 2.5e-7
of that).
"""
import pytest

from _torch_ranks import run_ranks

_CHILD = """
import dataclasses
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.analysis.op_analysis import Recorder
from repro_torch.configs import get_config, smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.distribution.recipes import plan_for
from repro_torch.distribution.sharding import axis_rules, sharding_for, tree_sharding
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import get_model, ssm as SSM
from repro_torch.pytree import tree_flatten, tree_unflatten

meshes = {"2x2": make_host_mesh(2, 2, device_type="cpu"),
          "1x4": make_host_mesh(1, 4, device_type="cpu")}
B, S = 4, 8
gen = lambda s: torch.Generator().manual_seed(s)  # noqa: E731


def six_heads(cfg):
    return dataclasses.replace(cfg, d_model=48)  # 6 SSM heads of 16


def rules_for(cfg, kind, seq=S):
    return plan_for(cfg, ShapeConfig(kind, seq_len=seq, global_batch=B, kind=kind)).rules


def put(mesh, tree, specs, rules, grad=True):
    sh = tree_flatten(tree_sharding(mesh, specs, rules, tree))[0]
    flat, tdef = tree_flatten(tree)
    return tree_unflatten(tdef, [s.distribute(x.detach().clone()).requires_grad_(
        grad and x.is_floating_point()) for x, s in zip(flat, sh)])


def leaves(tree):
    return tree_flatten(tree)[0]


def whole(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def err(a, b):
    # the largest difference, over the largest magnitude where that is above 1
    return max(float((whole(x) - y).detach().abs().max()) / max(1.0, float(y.abs().max()))
               for x, y in zip(a, b))


def colls(table):
    return [{"k": r["coll"], "n": r["n"], "s": r["out"][0]["s"]} for r in table if r.get("coll")]


def compare(mesh, fn, tree, specs, rules, extra, extra_names):
    # fn(tree, *extra) -> output: values and gradients of (output * w).sum()
    # on one device and on the mesh, and the collectives the mesh's run made
    ref = [t.detach().clone().requires_grad_(t.is_floating_point()) for t in leaves(tree)]
    tdef = tree_flatten(tree)[1]
    ex = [t.detach().clone().requires_grad_(t.is_floating_point()) for t in extra]
    want = fn(tree_unflatten(tdef, ref), *ex)
    w = torch.randn(want.shape, generator=gen(7))
    diff = [t for t in ref + ex if t.requires_grad]
    want_g = torch.autograd.grad((want * w).sum(), diff, allow_unused=True)
    with axis_rules(rules, mesh), implicit_replication():
        dtree = put(mesh, tree, specs, rules)
        dex = [sharding_for(mesh, n, rules, shape=tuple(t.shape)).distribute(t.detach().clone())
               .requires_grad_(t.is_floating_point()) for t, n in zip(extra, extra_names)]
        with Recorder() as fwd:
            got = fn(dtree, *dex)
        out = whole(got)
        ddiff = [t for t in leaves(dtree) + dex if t.requires_grad]
        with Recorder() as bwd:
            got_g = torch.autograd.grad((out * w).sum(), ddiff, allow_unused=True)
    return (err([got], [want]), err([g for g in got_g if g is not None],
                                    [g for g in want_g if g is not None]),
            colls(fwd.table + bwd.table))


# the SSM mixer and a prefill's cache, and the decode step
for mesh_name, arch in (("2x2", "mamba2-130m"), ("2x2", "hymba-1.5b"), ("1x4", "mamba2-130m")):
    mesh = meshes[mesh_name]
    cfg = smoke(get_config(arch))
    cfg = six_heads(cfg) if mesh_name == "1x4" else cfg
    p = SSM.init_ssm(cfg, generator=gen(5), device="cpu")
    x = torch.randn(B, S, cfg.d_model, generator=gen(6))
    e, ge, cs = compare(mesh, lambda p, x: SSM.ssm_block(cfg, p, x, impl="ref"), p,
                        SSM.ssm_specs(cfg), rules_for(cfg, "train"), (x,),
                        (("batch", "seq", "embed"),))
    _, want = SSM.ssm_prefill(cfg, p, x, impl="ref")
    rules = rules_for(cfg, "prefill")
    with axis_rules(rules, mesh), implicit_replication(), torch.no_grad():
        _, got = SSM.ssm_prefill(cfg, put(mesh, p, SSM.ssm_specs(cfg), rules, grad=False),
                                 sharding_for(mesh, ("batch", "seq", "embed"), rules,
                                              shape=tuple(x.shape)).distribute(x), impl="ref")
    # one decode step from the prefill's cache
    xt = torch.randn(B, 1, cfg.d_model, generator=gen(8))
    want_y, want_c = SSM.ssm_decode_step(cfg, p, xt, want)
    rules = rules_for(cfg, "decode", seq=64)
    cspec = {"state": ("batch", "ssm_heads", "ssm_state", None), "conv": ("batch", None,
                                                                           "ssm_inner")}
    with axis_rules(rules, mesh), implicit_replication(), torch.no_grad():
        dp = put(mesh, p, SSM.ssm_specs(cfg), rules, grad=False)
        dc = put(mesh, {k: whole(v) for k, v in got.items()}, cspec, rules, grad=False)
        dxt = sharding_for(mesh, ("batch", "seq", "embed"), rules, shape=tuple(xt.shape)) \\
            .distribute(xt)
        with Recorder() as rec:
            got_y, got_c = SSM.ssm_decode_step(cfg, dp, dxt, dc)
    report({"what": "ssm", "mesh": mesh_name, "arch": arch, "err": e, "gerr": ge, "colls": cs,
            "state_err": err([got["state"]], [want["state"]]),
            "conv_err": err([got["conv"]], [want["conv"]]),
            "decode_err": err([got_y, got_c["state"], got_c["conv"]],
                              [want_y, want_c["state"], want_c["conv"]]),
            "decode_colls": colls(rec.table)})

# whisper-tiny's decode step over a cache whose slots are sharded
mesh = meshes["2x2"]
cfg = smoke(get_config("whisper-tiny"))
m = get_model(cfg)
params = m.init(cfg, generator=gen(0), device="cpu", dtype=torch.float32)
L_ = 16
cache = m.init_cache(cfg, B, L_, device="cpu", dtype=torch.float32)
for k, v in cache.items():
    v.copy_(torch.randn(v.shape, generator=gen(len(k))))
tok = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen(3))
want_l, want_c = m.decode_step(cfg, params, {k: v.clone() for k, v in cache.items()}, tok, 5)
rules = rules_for(cfg, "decode", seq=L_)
with axis_rules(rules, mesh), implicit_replication(), torch.no_grad():
    dp = put(mesh, params, m.param_specs(cfg), rules, grad=False)
    dc = put(mesh, cache, m.cache_specs(cfg), rules, grad=False)
    dtok = sharding_for(mesh, ("batch", "seq"), rules, shape=tuple(tok.shape)).distribute(tok)
    with Recorder() as rec:
        got_l, got_c = m.decode_step(cfg, dp, dc, dtok, 5)
report({"what": "cross", "err": err([got_l], [want_l]),
        "cache_err": err(leaves(got_c), leaves(want_c)),
        "slots": list(dc["cross_k"].to_local().shape), "colls": colls(rec.table)})

# each model's loss and gradients on a 2 x 2 mesh
for arch in ("olmo-1b", "whisper-tiny", "mamba2-130m", "hymba-1.5b"):
    cfg = smoke(get_config(arch))
    m = get_model(cfg)
    params = m.init(cfg, generator=gen(0), device="cpu", dtype=torch.float32)
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen(1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.encdec is not None:
        batch["frames"] = torch.randn(B, cfg.encdec.encoder_seq, cfg.d_model, generator=gen(2))
    names = {k: ("batch", "seq") if k != "frames" else ("batch", "frames", "embed") for k in batch}

    def loss(params, *xs):
        return m.loss_fn(cfg, params, dict(zip(batch, xs)), impl="ref")

    e, ge, cs = compare(mesh, loss, params, m.param_specs(cfg), rules_for(cfg, "train"),
                        tuple(batch.values()), tuple(names[k] for k in batch))
    report({"what": "loss", "arch": arch, "err": e, "gerr": ge, "colls": cs})
"""

TOL = 1e-5
B, S = 4, 8


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(_CHILD, 4, tmp_path_factory.mktemp("mesh_wire"), timeout=600)


def _report(ranks, what, **match):
    for rank in ranks:
        yield next(r for r in rank if r["what"] == what
                   and all(r.get(k) == v for k, v in match.items()))


def _numel(shape):
    n = 1
    for d in shape:
        n *= d
    return n


def _activation_gathers(colls, ndim):
    return [c for c in colls if c["k"] == "all-gather" and len(c["s"]) == ndim]


@pytest.mark.parametrize("arch", ["mamba2-130m", "hymba-1.5b"])
def test_ssm_mixer_gathers_b_and_c_alone_and_matches_one_device(ranks, arch):
    """2 x 2: the mixer's activations gathered are B and C, (B, S, 2 N) a
    layer (the weights' columns regrouped instead): no gather of xBC's
    (B, S, d_inner + 2 N) rows, which the plain column shards would need
    three times, in f32."""
    from repro_torch.configs import get_config, smoke

    s = smoke(get_config(arch)).ssm
    for r in _report(ranks, "ssm", mesh="2x2", arch=arch):
        assert r["err"] < TOL and r["gerr"] < TOL, r
        assert r["state_err"] < TOL and r["conv_err"] < TOL, r
        acts = _activation_gathers(r["colls"], 3)
        assert acts and max(_numel(c["s"]) for c in acts) <= B // 2 * S * 2 * s.d_state, acts


@pytest.mark.parametrize("mesh,arch", [("2x2", "mamba2-130m"), ("2x2", "hymba-1.5b"),
                                       ("1x4", "mamba2-130m")])
def test_ssm_decode_moves_xbc_once_and_matches_one_device(ranks, mesh, arch):
    """The decode step's x, B and C move once: an all-to-all of each
    rank's columns to the ranks of their heads, then B and C gathered
    (2 x 2), or x gathered where the heads are whole on every rank (1, 4):
    at most one (B, 1, d_inner + 2 N) of activations gathered, not
    three."""
    from repro_torch.configs import get_config, smoke

    cfg = smoke(get_config(arch))
    cols = cfg.ssm.d_inner(48 if mesh == "1x4" else cfg.d_model) + 2 * cfg.ssm.d_state
    rows = B // 2 if mesh == "2x2" else B
    for r in _report(ranks, "ssm", mesh=mesh, arch=arch):
        assert r["decode_err"] < TOL, r
        cs = r["decode_colls"]
        assert [c for c in cs if c["k"] == "all-to-all"], cs
        moved = sum(_numel(c["s"]) for c in _activation_gathers(cs, 3))
        assert moved <= rows * cols, cs


def test_ssm_mixer_in_head_groups_gathers_x_over_its_group(ranks):
    """(1, 4), six SSM heads, 2 groups of 2 ranks: x enters the group
    layout by a gather over the group's 2 ranks, B and C over all 4; no
    activation of d_inner columns is gathered over all 4 ranks."""
    for r in _report(ranks, "ssm", mesh="1x4", arch="mamba2-130m"):
        assert r["err"] < TOL and r["gerr"] < TOL and r["state_err"] < TOL, r
        acts = _activation_gathers(r["colls"], 3)
        assert [c for c in acts if c["n"] == 2], acts
        assert all(_numel(c["s"]) <= B * S * 2 * 16 for c in acts if c["n"] == 4), acts


def test_whisper_decode_reads_the_cross_cache_on_its_own_slots(ranks):
    """The cross K/V's slots sharded over the model ranks: each rank
    attends to its own half (flash decoding), so no gather moves a cross
    cache layer, and the logits and cache equal one device's."""
    from repro_torch.configs import get_config, smoke

    cfg = smoke(get_config("whisper-tiny"))
    local = B // 2 * cfg.encdec.encoder_seq // 2 * cfg.num_kv_heads * cfg.hd
    for r in _report(ranks, "cross"):
        assert r["err"] < TOL and r["cache_err"] < TOL, r
        assert r["slots"][2] == cfg.encdec.encoder_seq // 2
        assert not [c for c in r["colls"] if c["k"] == "all-gather"
                    and _numel(c["s"]) >= local], r["colls"]


# the (B, S, D) all-reduces of a train step on 2 x 2, a layer: the forward's
# row-parallel outputs and the backward's input gradients of the projections
# that read one tensor, one each (olmo-1b: attention and MLP out, q/k/v and
# gate/up in; mamba2-130m: the mixer's out, and z/xBC/dt in; hymba-1.5b:
# attention, SSM and MLP out, q/k/v, the mixer's and the MLP's in; whisper's
# decoder layers also cross-attention's out and q in); beyond the layers the
# embedding's all-reduce and the unembedding's input gradient, and
# whisper's cross K/V of the encoder states, one for every decoder layer
REDUCTIONS = {"olmo-1b": lambda cfg: 4 * cfg.num_layers + 2,
              "mamba2-130m": lambda cfg: 2 * cfg.num_layers + 2,
              "hymba-1.5b": lambda cfg: 6 * cfg.num_layers + 2,
              "whisper-tiny": lambda cfg: 4 * cfg.encdec.encoder_layers + 6 * cfg.num_layers + 3}


@pytest.mark.parametrize("arch", sorted(REDUCTIONS))
def test_train_step_reduces_each_shared_input_once_and_matches_one_device(ranks, arch):
    """The loss and every gradient equal one device's, and the input
    gradients of the projections of one tensor are added while partial
    and reduced once, in the gradient's dtype (reduced each projection's
    apart they would be olmo-1b 16 (B, S, D) all-reduces, whisper-tiny 34,
    mamba2-130m 10, hymba-1.5b 24)."""
    from repro_torch.configs import get_config, smoke

    cfg = smoke(get_config(arch))
    for r in _report(ranks, "loss", arch=arch):
        assert r["err"] < TOL and r["gerr"] < TOL, r
        rows = [c for c in r["colls"] if c["k"] == "all-reduce" and len(c["s"]) == 3
                and c["s"][0] == B // 2 and c["s"][2] == cfg.d_model]
        assert len(rows) <= REDUCTIONS[arch](cfg), rows
