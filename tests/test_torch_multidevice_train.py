"""Sharded training on a device mesh (``repro_torch.launch.mesh``,
``distribution.sharding``, ``launch.train``'s ``mesh=``) against the JAX
package's single-device run, as ``tests/test_multidevice_train.py`` holds
the JAX package's own sharded run.

Four gloo ranks on the CPU make a (2, 2) ("data", "model") mesh.  The
reference child's run (smoke OLMo-1B, 4 x 32 tokens, f32, no remat, one
microbatch, lr 1e-2, 4 steps) from the JAX package's weights and batch:
params and AdamW moments placed by ``tree_sharding`` of ``param_specs``,
the batch by ``batch_logical_specs``, the step on ``DTensor``s; its losses
match the reference's jitted single-device step (and the port's) to rtol
2e-4 and fall.  ``train(mesh=...)`` (the plan's own rules, remat, bf16
compute and microbatches, the pipeline placing the batch) of OLMo-1B and
Mamba2-130M, resumed from a step-0 checkpoint of the JAX package's
weights, matches the reference's ``train()`` to rtol 2e-4 (bf16 products
rounded in other orders: 3e-5 measured); Mamba2's SSD scan goes through
``kernel_with_plain_grad`` under the mesh as on the card, with a stand-in
kernel.  Stand-in kernels under
``kernel_with_plain_grad`` run on the local shards of batch and heads
(attention; the SSD scan with one group), and on gathered tensors for a
sequence-sharded input or heads of several groups, with the plain path's
values and gradients.
"""
import pickle
from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

from _torch_ranks import run_ranks
from repro.checkpoint.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.configs import get_config as jax_get_config, smoke as jax_smoke
from repro.configs.base import ShapeConfig as JaxShape
from repro.distribution.recipes import plan_for as jax_plan_for
from repro.launch.train import train as jax_train
from repro.models.model import get_model as jax_get_model, make_batch as jax_make_batch
from repro.training.optimizer import OptConfig as JaxOptConfig, init_opt_state as jax_init_opt
from repro.training.train_step import make_train_step as jax_make_train_step
from repro_torch.configs import get_config, smoke
from repro_torch.core.executor import reset_runtime
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.launch.train import train
from repro_torch.models.convert import params_from_numpy
from repro_torch.training.optimizer import init_opt_state
from repro_torch.training.train_step import make_train_step

pytestmark = pytest.mark.slow

TRAIN_ARCHS = ("olmo-1b", "mamba2-130m")
TRAIN_KW = dict(steps=3, batch=4, seq=32, log_every=0)

_SETUP = """
from dataclasses import replace
from repro_torch.configs import get_config, smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.distribution.recipes import plan_for
from repro_torch.training.optimizer import OptConfig

cfg = smoke(get_config("olmo-1b"))
shape = ShapeConfig("t", seq_len=32, global_batch=4, kind="train")
plan = replace(plan_for(cfg, shape), num_microbatches=1, remat="none", q_block=None,
               compute_dtype="float32")
opt_cfg = OptConfig(lr=1e-2, warmup_steps=0, total_steps=10)
"""

_CHILD = _SETUP + """
import functools, os, pickle
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from repro_torch.distribution.sharding import axis_rules, sharding_for, tree_sharding
from repro_torch.kernels._autograd import kernel_with_plain_grad
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.train import train
from repro_torch.models import batch_logical_specs, get_model, layers as L
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.ssm import _ssd_shard_dims, ssd_chunked
from repro_torch.pytree import tree_flatten, tree_unflatten
from repro_torch.training.optimizer import init_opt_state
from repro_torch.training.train_step import make_train_step

with open(os.path.join(REF_DIR, "ref.pkl"), "rb") as f:
    ref = pickle.load(f)
mesh = make_host_mesh(2, 2, device_type="cpu")
rules = dict(plan.rules)
m = get_model(cfg)
params = params_from_numpy(cfg, ref["params"], device="cpu")  # the JAX package's weights
opt = init_opt_state(params)
batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
with axis_rules(rules, mesh):
    psh = tree_flatten(tree_sharding(mesh, m.param_specs(cfg), rules, params))[0]
    def put(tree):
        flat, tdef = tree_flatten(tree)
        return tree_unflatten(tdef, [s.distribute(x) for x, s in zip(flat, psh)])
    params = put(params)
    opt = {"m": put(opt["m"]), "v": put(opt["v"]),
           "step": sharding_for(mesh, (), rules).distribute(opt["step"])}
    blog = batch_logical_specs(cfg, shape)
    b = {k: sharding_for(mesh, blog[k], rules, shape=tuple(v.shape)).distribute(v)
         for k, v in batch.items()}
    step = make_train_step(cfg, shape, opt_cfg, plan)
    losses = []
    for _ in range(4):
        params, opt, metrics = step(params, opt, b)
        assert isinstance(metrics["loss"], DTensor)
        loss = metrics["loss"].full_tensor()
        assert loss.ndim == 0
        losses.append(float(loss))
    wq = params["layers"]["attn"]["wq"]
report({"sharded": losses, "wq_placements": [str(p) for p in wq.placements],
        "wq_local": list(wq.to_local().shape), "tokens_local": list(b["tokens"].to_local().shape)})

# train(mesh=), resumed from a step-0 checkpoint of the JAX package's weights;
# the SSD scan meets DTensors as on the card (kernel_with_plain_grad with
# _ssd_shard_dims), a stand-in kernel recording the local shapes it sees
import repro_torch.models.ssm as S
ssd_seen = []
def routed_local(fn, inputs, shard_dims, _orig=S.on_local_shards):
    if getattr(fn, "func", None) is not S.ssd_chunked or not isinstance(inputs[0], DTensor):
        return _orig(fn, inputs, shard_dims)
    def kern(*ls):
        ssd_seen.append([list(t.shape) for t in ls])
        with torch.no_grad():
            return fn(*ls)
    return kernel_with_plain_grad(kern, fn, *inputs, shard_dims=shard_dims)
S.on_local_shards = routed_local
trained = {}
for arch in ARCHS:
    out = train(arch, **KW, mesh=mesh, ckpt_dir=os.path.join(REF_DIR, "ckpt-" + arch),
                resume=True)
    trained[arch] = {"losses": out["losses"], "ssd_local": ssd_seen[:1],
                     "param_placements": [str(p) for p in
                                          out["params"]["embed"]["table"].placements]}
report(trained)

def check(kern_calls, kern, plain, full, placements, shard_dims):
    refs = [t.clone().requires_grad_(t.is_floating_point()) for t in full]
    want = plain(*refs)
    want = want if isinstance(want, tuple) else (want,)
    sum(w.sum() for w in want).backward()
    ds = [distribute_tensor(t.clone().requires_grad_(t.is_floating_point()), mesh, pl)
          for t, pl in zip(full, placements)]
    got = kernel_with_plain_grad(kern, plain, *ds, shard_dims=shard_dims)
    got = got if isinstance(got, tuple) else (got,)
    sum(g.sum() for g in got).backward()
    return {"placements": [[str(p) for p in g.placements] for g in got],
            "seen": kern_calls[-1],
            "err": max(float((g.full_tensor() - w).abs().max()) for g, w in zip(got, want)),
            "gerr": max(float((d.grad.full_tensor() - r.grad).abs().max())
                        for d, r in zip(ds, refs))}

# a stand-in attention kernel on local shards
g = torch.Generator().manual_seed(0)
q, k, v = (torch.randn(4, 8, h, 16, generator=g) for h in (4, 2, 2))
seen = []
def kern(*xs):
    seen.append([list(x.shape) for x in xs])
    with torch.no_grad():
        return L.attention(*xs, causal=True, impl="ref")
plain = functools.partial(L.attention, causal=True, impl="ref")
for pl in ([Shard(0), Shard(2)], [Shard(1), Replicate()]):
    report(check(seen, kern, plain, (q, k, v), [pl] * 3, L.ATTENTION_SHARD_DIMS))

# a stand-in SSD scan kernel: (xs, dt, A, Bg, Cg) -> (y, state)
ssd_plain = functools.partial(ssd_chunked, chunk=4)
def ssd_kern(*xs):
    seen.append([list(x.shape) for x in xs])
    with torch.no_grad():
        return ssd_plain(*xs)
for G in (1, 2):
    Bsz, S, H, P, N = 4, 12, 4, 8, 6
    xs = torch.randn(Bsz, S, H, P, generator=g)
    dt = torch.rand(Bsz, S, H, generator=g) * 0.5 + 0.05
    A = -torch.rand(H, generator=g) - 0.5
    Bg, Cg = (torch.randn(Bsz, S, G, N, generator=g) for _ in range(2))
    # batch rows over data; heads over model (B and C replicated there)
    pls = [[Shard(0), Shard(2)], [Shard(0), Shard(2)], [Replicate(), Shard(0)],
           [Shard(0), Replicate()], [Shard(0), Replicate()]]
    report(check(seen, ssd_kern, ssd_plain, (xs, dt, A, Bg, Cg), pls, _ssd_shard_dims(G)))
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX package's side, in ``ref_dir``: the reference child's weights
    and batch (``ref.pkl``, numpy) and its jitted single-device losses; for
    each of ``TRAIN_ARCHS`` a step-0 checkpoint of the weights and AdamW
    state its ``train()`` starts from, and that ``train()``'s losses."""
    d = tmp_path_factory.mktemp("mesh_ref")
    jc = jax_smoke(jax_get_config("olmo-1b"))
    jshape = JaxShape("t", seq_len=32, global_batch=4, kind="train")
    jplan = replace(jax_plan_for(jc, jshape), num_microbatches=1, remat="none", q_block=None,
                    compute_dtype="float32")
    m = jax_get_model(jc)
    params = m.init(jc, jax.random.key(0))
    batch = jax_make_batch(jc, jshape, seed=7)
    host = {"params": jax.tree.map(np.asarray, params),
            "batch": {k: np.array(v) for k, v in batch.items()}}
    with open(d / "ref.pkl", "wb") as f:
        pickle.dump(host, f)
    jstep = jax.jit(jax_make_train_step(jc, jshape, JaxOptConfig(lr=1e-2, warmup_steps=0,
                                                                  total_steps=10), jplan))
    opt, single = jax_init_opt(params), []
    for _ in range(4):
        params, opt, metrics = jstep(params, opt, batch)
        single.append(float(metrics["loss"]))
    trained = {}
    for arch in TRAIN_ARCHS:
        ac = jax_smoke(jax_get_config(arch))
        p0 = jax_get_model(ac).init(ac, jax.random.key(0))  # what train(seed=0) draws
        JaxCheckpointManager(str(d / f"ckpt-{arch}")).save_async(
            0, (p0, jax_init_opt(p0)), extra={"step": 0, "cursor": 0}).get()
        trained[arch] = jax_train(arch, **TRAIN_KW)["losses"]
    return {"dir": str(d), "host": host, "single": single, "trained": trained}


@pytest.fixture(scope="module")
def ranks(ref, tmp_path_factory):
    head = f"REF_DIR = {ref['dir']!r}\nARCHS = {TRAIN_ARCHS!r}\nKW = {TRAIN_KW!r}\n"
    return run_ranks(head + _CHILD, 4, tmp_path_factory.mktemp("mesh_train"), timeout=420)


def _single(ref):
    """The port's single-device step on the JAX package's weights and batch."""
    ns: dict = {}
    exec(_SETUP, ns)
    cfg, shape, plan, opt_cfg = ns["cfg"], ns["shape"], ns["plan"], ns["opt_cfg"]
    params = params_from_numpy(cfg, ref["host"]["params"], device="cpu")
    opt = init_opt_state(params)
    batch = {k: torch.from_numpy(v) for k, v in ref["host"]["batch"].items()}
    step = make_train_step(cfg, shape, opt_cfg, plan)
    losses = []
    for _ in range(4):
        params, opt, metrics = step(params, opt, batch)
        losses.append(float(metrics["loss"]))
    return losses


def test_torch_sharded_training_matches_single_device(ref, ranks):
    want = np.asarray(ref["single"])  # the reference's jitted single-device step
    assert want[-1] < want[0]  # it actually trains
    np.testing.assert_allclose(_single(ref), want, rtol=2e-4)
    for rank in ranks:  # every rank reads the same replicated loss
        np.testing.assert_allclose(rank[0]["sharded"], want, rtol=2e-4)
    r0 = ranks[0][0]
    # wq (L, d, H*hd): FSDP over data on d, TP over model on the heads
    assert r0["wq_placements"] == ["S(1)", "S(2)"]
    cfg = smoke(get_config("olmo-1b"))
    assert r0["wq_local"] == [cfg.num_layers, cfg.d_model // 2, cfg.num_heads * cfg.hd // 2]
    assert r0["tokens_local"] == [2, 32]  # the batch over data


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_torch_train_driver_mesh_matches_unsharded(ref, ranks, arch):
    want = ref["trained"][arch]  # the reference's train() from the same weights
    for rank in ranks:
        np.testing.assert_allclose(rank[1][arch]["losses"], want, rtol=2e-4)
    # the table (vocab, d): TP over model on the vocab, FSDP over data on d
    assert ranks[0][1][arch]["param_placements"] == ["S(1)", "S(0)"]
    if arch == "mamba2-130m":
        # the SSD scan's inputs reach the kernel wrapper with the batch over
        # data (2 rows a rank) and the heads over model: dt and A arrive
        # sharded by heads, and x, replicated along model, is sliced to the
        # rank's heads, so every rank's kernel sees H / 2 heads
        cfg = smoke(get_config(arch))
        H = cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim
        [(xs, dt, A, Bg, Cg)] = ranks[0][1][arch]["ssd_local"]
        assert xs[:3] == [2, 32, H // 2] and dt == [2, 32, H // 2] and A == [H // 2]
        assert Bg[:3] == Cg[:3] == [2, 32, cfg.ssm.n_groups]


def test_torch_kernel_runs_on_local_shards_under_a_mesh(ranks):
    sharded, gathered = ranks[0][2], ranks[0][3]
    # batch over data, heads over model: each rank's kernel sees 2 rows and
    # half the query and kv heads; the output keeps the placements
    assert sharded["seen"] == [[2, 8, 2, 16], [2, 8, 1, 16], [2, 8, 1, 16]]
    assert sharded["placements"] == [["S(0)", "S(2)"]]
    # a sequence-sharded input is gathered first: the whole tensors
    assert gathered["seen"] == [[4, 8, 4, 16], [4, 8, 2, 16], [4, 8, 2, 16]]
    assert gathered["placements"] == [["R", "R"]]
    for r in (sharded, gathered):
        assert r["err"] < 1e-6 and r["gerr"] < 1e-6


def test_torch_ssd_scan_runs_on_local_shards_under_a_mesh(ranks):
    """``_ssd_shard_dims``: batch rows always; heads when the one group's B
    and C serve every head (G == 1), else the heads are gathered.  The
    gradients of the inputs replicated along a sharded mesh dim (A along
    the batch, B and C along the heads) are summed over it."""
    one, two = ranks[0][4], ranks[0][5]
    # (xs, dt, A, Bg, Cg) as each rank's kernel sees them; (y, state) placements
    assert one["seen"] == [[2, 12, 2, 8], [2, 12, 2], [2], [2, 12, 1, 6], [2, 12, 1, 6]]
    assert one["placements"] == [["S(0)", "S(2)"], ["S(0)", "S(1)"]]
    assert two["seen"] == [[2, 12, 4, 8], [2, 12, 4], [4], [2, 12, 2, 6], [2, 12, 2, 6]]
    assert two["placements"] == [["S(0)", "R"], ["S(0)", "R"]]
    for r in (one, two):
        assert r["err"] < 1e-5 and r["gerr"] < 1e-4, r


def test_torch_elastic_route_refuses_a_mesh():
    with pytest.raises(ValueError, match="not over a device mesh"):
        train("olmo-1b", steps=1, workers=2, mesh=object(), device="cpu")


def test_torch_host_mesh_needs_its_ranks():
    with pytest.raises(ValueError, match=r"\(2, 2\) mesh needs 4 ranks"):
        make_host_mesh(2, 2, device_type="cpu")
    with pytest.raises(ValueError, match=r"\(16, 16\) mesh needs 256 ranks"):
        make_production_mesh()
    with pytest.raises(ValueError, match=r"\(2, 16, 16\) mesh needs 512 ranks"):
        make_production_mesh(multi_pod=True)
    assert not torch.distributed.is_initialized()


def test_torch_one_rank_mesh_starts_and_drops_its_group():
    """With no group up, a (1, 1) mesh starts a one-rank gloo group of its
    own (NCCL on the card); ``train(mesh=...)`` over it gives the unsharded
    losses; ``reset_runtime()`` destroys the group."""
    want = train("olmo-1b", steps=2, batch=2, seq=16, log_every=0, device="cpu")["losses"]
    mesh = make_host_mesh(1, 1, device_type="cpu")
    try:
        assert torch.distributed.get_world_size() == 1
        assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (1, 1)
        got = train("olmo-1b", steps=2, batch=2, seq=16, log_every=0, mesh=mesh)["losses"]
    finally:
        reset_runtime()
    assert not torch.distributed.is_initialized()
    np.testing.assert_allclose(got, want, rtol=1e-6)
