"""The port's single-device training (``repro_torch.training``,
``repro_torch.launch.train``, each family's ``loss_fn``) held against the
JAX package on the CPU.

First the port of ``tests/test_training.py`` (AdamW on a quadratic, the
schedule, clipping, loss falling, microbatching, the driver).  Then the
port against the reference on the same seeded inputs:

* ``schedule`` and ``adamw_update`` on random trees, three steps in a row:
  rtol 1e-6 (the same f32 operations in the same order);
* ``loss_fn`` value and gradients against ``jax.value_and_grad`` of the
  reference's ``loss_fn`` in f32 for the smoke configs of six families,
  the JAX params carried across by ``params_from_numpy``, with each of the
  port's remat policies (none, full, dots): loss rtol 1e-5, gradients rtol
  1e-4 atol 1e-6 (the same f32 math summed in other orders);
* the whole slice: three steps of the port's ``make_train_step`` against
  the reference's jitted step from the same params and batch, f32 compute,
  1 and 2 microbatches: losses rtol 1e-5, params rtol 2e-4 atol 2e-6 (the
  tolerances of ``tests/test_training.py``'s microbatching test) but where
  AdamW's denominator is eps-dominated (see the test).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfg
from repro.configs.base import ShapeConfig as JaxShape
from repro.distribution.recipes import plan_for as jax_plan_for
from repro.models import layers as jax_layers
from repro.models.model import get_model as jax_get_model
from repro.models.model import make_batch as jax_make_batch
from repro.training import optimizer as jax_opt
from repro.training.train_step import make_train_step as jax_make_train_step
from repro_torch import configs as tcfg
from repro_torch.configs import get_config, smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.distribution.recipes import plan_for
from repro_torch.models import get_model, layers, make_batch
from repro_torch.models.convert import params_from_numpy
from repro_torch.pytree import tree_flatten, tree_flatten_with_path
from repro_torch.training.optimizer import OptConfig, adamw_update, init_opt_state, schedule
from repro_torch.training.train_step import make_init, make_train_step

SHAPE = ShapeConfig("t", seq_len=32, global_batch=4, kind="train")
JSHAPE = JaxShape("t", seq_len=32, global_batch=4, kind="train")
LOSS_ARCHS = ["olmo-1b", "qwen2-moe-a2.7b", "qwen2-vl-72b", "mamba2-130m", "whisper-tiny",
              "hymba-1.5b"]
REMATS = ["none", "full", "dots"]
LOSS_TOL = dict(rtol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
OPT_TOL = dict(rtol=1e-6, atol=0)
STEP_LOSS_TOL = dict(rtol=1e-5)
STEP_PARAM_TOL = dict(rtol=2e-4, atol=2e-6)


def _t(x):
    return torch.from_numpy(np.array(x))


def _plan(cfg, micro):
    # f32 compute: these tests check numerical equivalence properties,
    # independent of the bf16 mixed-precision policy
    p = plan_for(cfg, SHAPE)
    return dataclasses.replace(p, num_microbatches=micro, remat="none", q_block=None,
                               compute_dtype="float32")


def _init(cfg, seed):
    return make_init(cfg, OptConfig(), device="cpu")(seed)


# ---------------------------------------------------------------------------
# tests/test_training.py, ported
# ---------------------------------------------------------------------------

def test_torch_adamw_minimizes_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    state = init_opt_state(params)
    cfg = OptConfig(lr=0.1, weight_decay=0.0, warmup_steps=0, total_steps=200, clip_norm=None)
    for _ in range(200):
        w = params["w"].detach().requires_grad_(True)
        (g,) = torch.autograd.grad(torch.sum(w ** 2), [w])
        params, state, _ = adamw_update(cfg, params, {"w": g}, state)
    np.testing.assert_allclose(params["w"].numpy(), 0.0, atol=0.05)


def test_torch_schedule_warmup_and_cosine():
    cfg = OptConfig(lr=1.0, warmup_steps=10, total_steps=110, min_lr_frac=0.1)
    i32 = functools.partial(torch.tensor, dtype=torch.int32)
    assert float(schedule(cfg, i32(0))) == 0.0
    assert abs(float(schedule(cfg, i32(10))) - 1.0) < 1e-6
    assert float(schedule(cfg, i32(5))) == pytest.approx(0.5, rel=1e-5)
    assert float(schedule(cfg, i32(110))) == pytest.approx(0.1, rel=1e-4)


def test_torch_grad_clip_bounds_update():
    params = {"w": torch.zeros(3)}
    state = init_opt_state(params)
    cfg = OptConfig(lr=1e-3, clip_norm=1.0, warmup_steps=0, total_steps=10)
    grads = {"w": torch.full((3,), 1e6)}
    _, _, metrics = adamw_update(cfg, params, grads, state)
    assert float(metrics["gnorm"]) > 1e5  # raw norm reported


def test_torch_train_step_loss_decreases_over_steps():
    cfg = smoke(get_config("olmo-1b"))
    opt_cfg = OptConfig(lr=1e-2, warmup_steps=0, total_steps=50)
    step = make_train_step(cfg, SHAPE, opt_cfg, _plan(cfg, 1))
    params, opt_state = _init(cfg, 0)
    batch = make_batch(cfg, SHAPE, device="cpu")  # overfit one batch
    losses = []
    for _ in range(8):
        params, opt_state, metrics = step(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0], losses


def test_torch_microbatching_matches_full_batch_grads():
    """n_micro=2 must produce the same update as n_micro=1 (mean of micro
    losses == full-batch loss for equal-sized microbatches)."""
    cfg = smoke(get_config("olmo-1b"))
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    batch = make_batch(cfg, SHAPE, seed=3, device="cpu")
    params, _ = _init(cfg, 1)

    outs = {}
    for n in (1, 2):
        step = make_train_step(cfg, SHAPE, opt_cfg, _plan(cfg, n))
        p2, _, metrics = step(params, init_opt_state(params), batch)
        outs[n] = ([t.numpy() for t in tree_flatten(p2)[0]], float(metrics["loss"]))
    np.testing.assert_allclose(outs[1][1], outs[2][1], rtol=1e-5)
    for a, b in zip(outs[1][0], outs[2][0]):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-6)


def test_torch_end_to_end_train_driver(tmp_path):
    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.launch.train import train

    out = train("stablelm-1.6b", use_smoke=True, steps=6, batch=4, seq=32, lr=5e-3,
                ckpt_dir=str(tmp_path / "ck"), ckpt_every=3, log_every=0, device="cpu")
    assert len(out["losses"]) == 6 and len(out["step_seconds"]) == 6
    assert np.isfinite(out["final_loss"])
    # two async checkpoints must exist (steps 3 and 6)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    assert mgr.steps() == [3, 6]


# ---------------------------------------------------------------------------
# the port against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [OptConfig(), OptConfig(lr=1.0, warmup_steps=10, total_steps=110),
                                 OptConfig(warmup_steps=0, total_steps=7, min_lr_frac=0.0)],
                         ids=["default", "warm10", "nowarm"])
def test_torch_schedule_matches_reference(cfg):
    jc = jax_opt.OptConfig(**dataclasses.asdict(cfg))
    steps = np.arange(0, cfg.total_steps + 20, max(1, cfg.total_steps // 97), dtype=np.int32)
    got = np.array([float(schedule(cfg, torch.tensor(s))) for s in steps], np.float32)
    want = np.array([float(jax_opt.schedule(jc, jnp.int32(s))) for s in steps], np.float32)
    np.testing.assert_allclose(got, want, **OPT_TOL)


@pytest.mark.parametrize("clip", [None, 1.0, 1e3], ids=["noclip", "clip1", "clip1e3"])
def test_torch_adamw_update_matches_reference(clip):
    """Three updates in a row on a random tree (a stacked 3-D leaf, a
    matrix, a vector and a nested dict), each step's params, moments, step,
    gnorm and lr against the reference's."""
    rng = np.random.default_rng(11)
    shapes = {"a": (2, 5, 7), "b": {"c": (9, 4), "d": (13,)}}
    draw = lambda s: rng.normal(0, 1, s).astype(np.float32)  # noqa: E731
    params = jax.tree.map(draw, shapes, is_leaf=lambda x: isinstance(x, tuple))
    cfg = OptConfig(lr=3e-2, warmup_steps=2, total_steps=6, clip_norm=clip)
    jc = jax_opt.OptConfig(**dataclasses.asdict(cfg))
    tp = jax.tree.map(_t, params)
    ts = init_opt_state(tp)
    jp = jax.tree.map(jnp.asarray, params)
    js = jax_opt.init_opt_state(jp)
    for i in range(3):
        grads = jax.tree.map(lambda s: draw(s) * 10.0 ** (i - 1), shapes,
                             is_leaf=lambda x: isinstance(x, tuple))
        tp, ts, tm = adamw_update(cfg, tp, jax.tree.map(_t, grads), ts)
        jp, js, jm = jax_opt.adamw_update(jc, jp, jax.tree.map(jnp.asarray, grads), js)
        for got, want in zip(tree_flatten((tp, ts["m"], ts["v"]))[0],
                             jax.tree.leaves((jp, js["m"], js["v"]))):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **OPT_TOL)
        assert int(ts["step"]) == int(js["step"]) == i + 1 and ts["step"].dtype == torch.int32
        for k in ("gnorm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), **OPT_TOL)


def test_torch_adamw_donate_updates_in_place():
    """``donate=True`` writes the same numbers into the given tensors."""
    rng = np.random.default_rng(5)
    params = {"w": torch.from_numpy(rng.normal(size=(6, 3)).astype(np.float32))}
    grads = {"w": torch.from_numpy(rng.normal(size=(6, 3)).astype(np.float32))}
    cfg = OptConfig(lr=1e-2, warmup_steps=0, total_steps=5)
    want_p, want_s, _ = adamw_update(cfg, params, grads, init_opt_state(params))
    state = init_opt_state(params)
    w, m = params["w"], state["m"]["w"]
    got_p, got_s, _ = adamw_update(cfg, params, {"w": grads["w"].clone()}, state, donate=True)
    assert got_p["w"] is w and got_s["m"]["w"] is m and got_s is state
    torch.testing.assert_close(got_p["w"], want_p["w"], rtol=0, atol=0)
    torch.testing.assert_close(got_s["v"]["w"], want_s["v"]["w"], rtol=0, atol=0)
    assert int(got_s["step"]) == 1


@pytest.mark.parametrize("masked", [False, True])
def test_torch_xent_loss_matches_reference(masked):
    rng = np.random.default_rng(2)
    logits = rng.normal(0, 3, (2, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) > 0.4).astype(np.float32) if masked else None
    got = layers.xent_loss(_t(logits), _t(labels), None if mask is None else _t(mask))
    want = jax_layers.xent_loss(jnp.asarray(logits), jnp.asarray(labels),
                                None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(float(got), float(want), **LOSS_TOL)


def _jax_batch(arch):
    jc = jcfg.smoke(jcfg.get_config(arch))
    b = jax_make_batch(jc, JaxShape("t", seq_len=32, global_batch=2, kind="train"), seed=1)
    return {k: np.asarray(v.astype(jnp.float32) if v.dtype == jnp.bfloat16 else v)
            for k, v in b.items()}


def _path_key(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(arch):
    jc = jcfg.smoke(jcfg.get_config(arch))
    m = jax_get_model(jc)
    params = m.init(jc, jax.random.key(0))
    batch = {k: jnp.asarray(v) for k, v in _jax_batch(arch).items()}
    loss, grads = jax.jit(jax.value_and_grad(lambda p: m.loss_fn(jc, p, batch)))(params)
    flat = {_path_key(p): np.asarray(g) for p, g in jax.tree_util.tree_flatten_with_path(grads)[0]}
    return jax.tree.map(np.asarray, params), float(loss), flat


@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_torch_loss_fn_and_grads_match_reference(arch, remat):
    jparams, jloss, jgrads = _jax_loss_and_grads(arch)
    cfg = tcfg.smoke(tcfg.get_config(arch))
    params = params_from_numpy(cfg, jparams, device="cpu")
    pairs, _ = tree_flatten_with_path(params)
    for _, p in pairs:
        p.requires_grad_(True)
    batch = {k: torch.from_numpy(v.copy()) for k, v in _jax_batch(arch).items()}
    loss = get_model(cfg).loss_fn(cfg, params, batch, remat=remat)
    grads = torch.autograd.grad(loss, [p for _, p in pairs], allow_unused=True)
    np.testing.assert_allclose(float(loss.detach()), jloss, **LOSS_TOL)
    assert sorted("/".join(map(str, path)) for path, _ in pairs) == sorted(jgrads)
    for (path, p), g in zip(pairs, grads):
        got = np.zeros(tuple(p.shape), np.float32) if g is None else g.numpy()
        np.testing.assert_allclose(got, jgrads["/".join(map(str, path))], **GRAD_TOL,
                                   err_msg=f"{arch} remat={remat} grad of {path}")


def test_torch_remat_recomputes_per_policy():
    """What each policy recomputes in the backward (smoke olmo-1b, 2
    layers), counted at the dispatcher: ``none`` recomputes nothing;
    ``full`` reruns each layer's forward, its products (``mm``) among
    them; ``dots`` reruns it but takes the saved products, so its backward
    runs the products of ``none``'s."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops, self.mm = 0, 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops += 1
            self.mm += func is torch.ops.aten.mm.default
            return func(*args, **(kwargs or {}))

    cfg = smoke(get_config("olmo-1b"))
    params, _ = _init(cfg, 0)
    for p in tree_flatten(params)[0]:
        p.requires_grad_(True)
    batch = make_batch(cfg, SHAPE, device="cpu")
    counts, grads = {}, {}
    for remat in REMATS:
        loss = get_model(cfg).loss_fn(cfg, params, batch, remat=remat)
        with Count() as c:
            loss.backward()
        counts[remat] = (c.ops, c.mm)
        grads[remat] = [p.grad.clone() for p in tree_flatten(params)[0]]
        for p in tree_flatten(params)[0]:
            p.grad = None
    assert counts["full"][1] > counts["dots"][1] == counts["none"][1], counts
    assert counts["full"][0] > counts["dots"][0] > counts["none"][0], counts
    for remat in ("full", "dots"):
        for a, b in zip(grads[remat], grads["none"]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_torch_remat_rejects_unknown_policy():
    cfg = smoke(get_config("olmo-1b"))
    params, _ = _init(cfg, 0)
    with pytest.raises(ValueError, match="remat"):
        get_model(cfg).loss_fn(cfg, params, make_batch(cfg, SHAPE, device="cpu"), remat="some")


@pytest.mark.parametrize("n_micro", [1, 2])
def test_torch_train_step_matches_reference(n_micro):
    """Three steps of the port's ``make_train_step`` against the reference's
    jitted step, from the same params and batch, f32 compute: losses each
    step, params after the third.

    AdamW divides the first moment by sqrt(v_hat) + eps.  Where sqrt(v_hat)
    is within 10 eps (a gradient element that is zero up to rounding, ~1e-10
    here), the update is the gradient's rounding noise over eps, so it
    differs between any two summation orders, the reference's own among
    them.  Such elements are found from the reference's moments; every other
    element is held to the tolerance, and at most 1 in 1000 may be such."""
    jc = jcfg.smoke(jcfg.get_config("olmo-1b"))
    cfg = tcfg.smoke(tcfg.get_config("olmo-1b"))
    jplan = dataclasses.replace(jax_plan_for(jc, JSHAPE), num_microbatches=n_micro,
                                remat="none", q_block=None, compute_dtype="float32")
    opt = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    jstep = jax.jit(jax_make_train_step(jc, JSHAPE, jax_opt.OptConfig(**dataclasses.asdict(opt)),
                                        jplan))
    tstep = make_train_step(cfg, SHAPE, opt, _plan(cfg, n_micro))
    jparams = jax_get_model(jc).init(jc, jax.random.key(2))
    jbatch = jax_make_batch(jc, JSHAPE, seed=4)
    tparams = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    jstate, tstate = jax_opt.init_opt_state(jparams), init_opt_state(tparams)
    ill = None
    for i in range(3):
        jparams, jstate, jm = jstep(jparams, jstate, jbatch)
        tparams, tstate, tm = tstep(tparams, tstate, tbatch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **STEP_LOSS_TOL,
                                   err_msg=f"step {i}")
        vhat = [np.sqrt(np.asarray(v) / (1 - opt.b2 ** (i + 1)))
                for v in jax.tree.leaves(jstate["v"])]
        now = [x < 10 * opt.eps for x in vhat]
        ill = now if ill is None else [a | b for a, b in zip(ill, now)]
    n_ill = 0
    for got, want, eps_bound in zip(tree_flatten(tparams)[0], jax.tree.leaves(jparams), ill):
        got, want = got.numpy(), np.asarray(want)
        bad = ~np.isclose(got, want, **STEP_PARAM_TOL)
        np.testing.assert_allclose(got[~eps_bound], want[~eps_bound], **STEP_PARAM_TOL)
        n_ill += int((bad & eps_bound).sum())
    n = sum(x.size for x in ill)
    assert n_ill <= n // 1000, (n_ill, n)


def test_torch_train_step_bf16_compute_keeps_f32_masters():
    """The plan's bf16 compute: ndim >= 2 leaves cast for the forward, the
    f32 masters updated; the loss is the f32 step's within bf16 rounding
    (2e-2 relative) and every updated leaf stays f32."""
    cfg = smoke(get_config("olmo-1b"))
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    batch = make_batch(cfg, SHAPE, seed=3, device="cpu")
    params, _ = _init(cfg, 1)
    plan32 = _plan(cfg, 1)
    losses = {}
    for name, plan in (("f32", plan32), ("bf16", dataclasses.replace(plan32,
                                                                     compute_dtype="bfloat16"))):
        p2, _, metrics = make_train_step(cfg, SHAPE, opt_cfg, plan)(
            params, init_opt_state(params), batch)
        losses[name] = float(metrics["loss"])
        assert all(t.dtype == torch.float32 for t in tree_flatten(p2)[0])
    np.testing.assert_allclose(losses["bf16"], losses["f32"], rtol=2e-2)


def test_torch_train_refuses_elastic_and_mesh_routes():
    """What the driver still refuses: the elastic route over a device mesh
    (it shards the batch over workers; ``train(mesh=...)`` is
    ``tests/test_torch_multidevice_train.py``'s).  A parcel port takes the
    elastic route over its localities (one ParcelWorker a locality;
    ``tests/test_torch_elastic_train.py`` holds that route)."""
    from repro_torch.core import LoopbackParcelport
    from repro_torch.launch.train import train

    for route in (dict(workers=2), dict(elastic=True), dict(port=object())):
        with pytest.raises(ValueError, match="not over a device mesh"):
            train("olmo-1b", steps=1, device="cpu", mesh=object(), **route)
    port = LoopbackParcelport(2, platform="cpu")
    try:
        out = train("olmo-1b", use_smoke=True, steps=2, batch=4, seq=8, device="cpu", port=port)
        assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
        assert out["recoveries"] == []
    finally:
        port.shutdown()


def test_torch_failstop_resume_is_deterministic(tmp_path):
    """Kill-and-resume reproduces the uninterrupted run: train 8 straight
    vs train 4 + restore + 4 -> identical final loss (rtol 1e-5, the
    reference's ``tests/test_checkpoint.py`` bound), on mamba2 with the
    plan's dots remat."""
    from repro_torch.launch.train import train

    kw = dict(use_smoke=True, batch=2, seq=16, lr=1e-3, log_every=0, seed=5, device="cpu")
    full = train("mamba2-130m", steps=8, ckpt_dir=str(tmp_path / "a"), ckpt_every=100, **kw)
    train("mamba2-130m", steps=4, ckpt_dir=str(tmp_path / "b"), ckpt_every=4, schedule_total=8,
          **kw)
    resumed = train("mamba2-130m", steps=8, ckpt_dir=str(tmp_path / "b"), resume=True,
                    ckpt_every=100, **kw)
    assert len(resumed["losses"]) == 4
    np.testing.assert_allclose(resumed["final_loss"], full["final_loss"], rtol=1e-5)


@pytest.mark.parametrize("arch", ["olmo-1b", "mamba2-130m"])
def test_torch_params_freed_without_the_garbage_collector(arch):
    """A forward and a decode step leave no reference cycle holding the
    params: with the collector off, dropping the params frees them (the
    stacked layer leaves, split by ``layers.unstack``, included).  The
    serve phases free one model's weights before loading the next on the
    card."""
    import gc
    import weakref

    cfg = smoke(get_config(arch))
    m = get_model(cfg)
    gc.collect()
    gc.disable()
    try:
        params, _ = _init(cfg, 0)
        refs = [weakref.ref(t) for t in tree_flatten(params)[0]]
        batch = make_batch(cfg, SHAPE, device="cpu")
        m.forward(cfg, params, {"tokens": batch["tokens"]})
        cache = m.init_cache(cfg, 4, 8, device="cpu", dtype=torch.float32)
        m.decode_step(cfg, params, cache, batch["tokens"][:, :1], 0)
        del params, cache
        assert all(r() is None for r in refs)
    finally:
        gc.enable()
