"""The port's elastic data-parallel training (``repro_torch.training.elastic``,
the elastic route of ``repro_torch.launch.train``) on the CPU.

First the ports of the reference's chaos suite that need no transport
(``tests/test_elastic_train.py``): the mid-step-kill property with 3
hypothesis examples, re-join and scale-out, the driver's ``--chaos``
route, the AGAS-resident state, every worker dead, checkpoint resume.
Smoke olmo-1b, batch 6, seq 8, ``device="cpu"``.  Then the port against
the JAX package from the same state (the reference's init carried across
by ``params_from_numpy``), f32 compute pinned in both by patching each
``elastic`` module's ``plan_for`` (and giving each fresh caches):

* the whole slice, 3 workers, 4 steps, a kill inside step 1: per-step
  losses rtol 1e-5; final params rtol 2e-4 atol 2e-6 (``tests/
  test_training.py``'s microbatching bound) but where AdamW's sqrt(v_hat)
  is within 10 eps (the update is then rounding noise over eps; at most 1
  element in 1000); equal ``events``;
* ``_combine`` bit-equal to the reference's numpy combine, plain and int8
  lanes;
* ``shard_action`` on one payload: loss rtol 1e-5, grads rtol 1e-4 atol
  1e-6 (the same f32 math summed in other orders).

The parcel route (``ElasticTrainer(port=...)``, one ``ParcelWorker`` a
locality, each shard one ``invoke`` parcel): the reference's loopback
tests (a kill mid-step, recovery, revive, nothing leaked; dropped parcels
retried, then a reshard), the port's loopback route against the
reference's ``ElasticTrainer(port=LoopbackParcelport(3))`` through a kill
at the tolerances above, and a 2-process CPU cluster with one worker
SIGKILLed mid-step, whose tail is bit-identical to the local route's.

The port's own: the int8 lane's kill tail bit-identical to a clean run and
its gradient within the int8 bound; the ``graph`` and ``jit`` routes equal;
what is still refused around parcel workers; ``reset_runtime`` dropping
the captured shard graphs.
"""
import dataclasses
import glob
import multiprocessing

import jax
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # hypothesis not installed: deterministic fallback shim
    from _hypothesis_compat import given, settings, strategies as st

import repro.training.elastic as jel
from repro.training import optimizer as jax_opt
from repro_torch.configs import get_config, smoke
from repro_torch.core import LocalClusterParcelport, LoopbackParcelport, agas, reset_runtime
from repro_torch.models.convert import params_from_numpy
from repro_torch.pytree import tree_flatten
from repro_torch.training import elastic as tel
from repro_torch.fault.inject import FaultInjector
from repro_torch.training.elastic import ElasticTrainer, LocalWorker, ParcelWorker

ARCH, BATCH, SEQ, TOTAL = "olmo-1b", 6, 8, 5
LOSS_TOL = dict(rtol=1e-5)
PARAM_TOL = dict(rtol=2e-4, atol=2e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _trainer(workers=3, seed=0, **kw):
    kw.setdefault("total_steps", TOTAL)  # one LR horizon
    return ElasticTrainer(ARCH, use_smoke=True, batch=BATCH, seq=SEQ, seed=seed,
                          workers=workers, device="cpu", **kw)


def _count_dispatches(trainer):
    """Wrap every worker's run_shard to count shards dispatched per step
    boundary — the observable for 'resumes N-way sharding'."""
    counts = {}
    for w in trainer.workers:
        orig = w.run_shard

        def wrapped(task, _w=w, _orig=orig):
            counts[_w.wid] = counts.get(_w.wid, 0) + 1
            return _orig(task)

        w.run_shard = wrapped
    return counts


# ---------------------------------------------------------------------------
# the reference's chaos suite, ported (the tests that need no transport)
# ---------------------------------------------------------------------------


@settings(max_examples=3, deadline=None)
@given(seed=st.integers(0, 3), kill_step=st.integers(1, 3), victim=st.integers(0, 2))
def test_torch_midstep_kill_bit_identical_to_clean_survivor_run(seed, kill_step, victim):
    t = _trainer(workers=3, seed=seed)
    try:
        t.run(kill_step)  # 3-way up to the kill step
        snap = t.snapshot()  # state AT the kill step (reference seed)
        t.workers[victim].kill_at_step(t.cursor)  # dies inside its shard
        tail = t.run(TOTAL - kill_step)["losses"]
        deaths = [e for e in t.events if e[0] == "death"]
        assert [(e[1], e[2]) for e in deaths] == [(kill_step, victim)]
        assert len(t.active_workers()) == 2
    finally:
        t.close()

    ref = _trainer(workers=2, seed=seed, state=(snap["params"], snap["opt_state"]),
                   start_step=snap["step"])
    try:
        ref_tail = ref.run(TOTAL - kill_step)["losses"]
        assert not ref.events  # the reference run saw no faults
    finally:
        ref.close()
    # bit-identical, not approximately equal: same floats, every step
    assert tail == ref_tail
    assert np.float64(tail[0]) == np.float64(ref_tail[0])


def test_torch_revived_worker_rejoins_n_way_sharding_at_step_boundary():
    t = _trainer(workers=3)
    counts = _count_dispatches(t)
    try:
        t.workers[1].kill()  # boundary death: excluded, no mid-step event
        t.step()
        assert counts == {0: 1, 2: 1}  # 2-way over survivors
        t.workers[1].revive()
        t.step()  # next boundary re-reads the active set
        assert counts == {0: 2, 1: 1, 2: 2}  # back to 3-way
        assert len(t.active_workers()) == 3
        assert not [e for e in t.events if e[0] == "death"]  # no step was lost
    finally:
        t.close()


def test_torch_add_worker_scales_out_next_step():
    t = _trainer(workers=2)
    try:
        t.step()
        w = t.add_worker(LocalWorker(7))  # takes the driver's platform (the CPU)
        counts = _count_dispatches(t)
        t.step()
        assert counts == {0: 1, 1: 1, 7: 1}  # admitted at the boundary
        assert ("join", 1, 7) in t.events
        assert w in t.active_workers()
    finally:
        t.close()


def test_torch_train_driver_chaos_run_completes_with_recovery(capsys):
    from repro_torch.launch.train import train

    out = train(ARCH, use_smoke=True, steps=4, batch=BATCH, seq=SEQ,
                workers=3, chaos=2, log_every=0, device="cpu")
    assert len(out["losses"]) == 4  # the kill cost zero steps
    assert all(np.isfinite(l) for l in out["losses"])
    assert len(out["recoveries"]) == 1  # seeded kill fired and was absorbed


def test_torch_master_state_is_agas_resident_until_close():
    t = _trainer(workers=2)
    gid = t.agas_gid
    assert gid in agas.registry.gids_on(agas.HOST_KEY, kind="elastic-state")
    assert agas.registry.resolve(gid) is t
    t.close()
    assert gid not in agas.registry.gids_on(agas.HOST_KEY, kind="elastic-state")


def test_torch_every_worker_dead_raises_with_resume_hint():
    t = _trainer(workers=2)
    try:
        for w in t.workers:
            w.kill()
        with pytest.raises(RuntimeError, match="resume=True"):
            t.step()
    finally:
        t.close()


def test_torch_checkpoint_resume_matches_uninterrupted_run(tmp_path):
    a = _trainer(workers=2, ckpt_dir=str(tmp_path), ckpt_every=1)
    try:
        a.run(2)
    finally:
        a.close()  # driver "dies" here; durable state is the checkpoint

    b = _trainer(workers=2, ckpt_dir=str(tmp_path), resume=True)
    try:
        assert b.cursor == 2
        resumed = b.run(3)["losses"]
    finally:
        b.close()

    c = _trainer(workers=2)  # never interrupted
    try:
        full = c.run(TOTAL)["losses"]
    finally:
        c.close()
    assert resumed == full[2:]  # npz round-trip loses no bits


# ---------------------------------------------------------------------------
# the port against the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture
def f32_families(monkeypatch):
    """f32 compute in both packages' elastic trainers (each module's
    ``plan_for`` patched) with fresh module caches, so no family or graph
    built under the bf16 plan is reused."""
    for mod in (jel, tel):
        orig = mod.plan_for
        monkeypatch.setattr(mod, "plan_for", lambda cfg, shape, _o=orig: dataclasses.replace(
            _o(cfg, shape), compute_dtype="float32"))
        for name in ("_FAMILIES", "_GEXECS", "_PROGRAMS"):
            monkeypatch.setattr(mod, name, {})


def _reference_state(seed=0):
    """The reference's seeded init and AdamW state, as numpy trees."""
    fam = jel._get_family(ARCH, True, SEQ, BATCH)
    params = fam["init"](jax.random.key(seed))
    state = jax_opt.init_opt_state(params)
    return jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state)


def _port_state(np_params, np_state):
    cfg = smoke(get_config(ARCH))
    conv = lambda tree: params_from_numpy(cfg, tree, device="cpu")  # noqa: E731
    return conv(np_params), {"m": conv(np_state["m"]), "v": conv(np_state["v"]),
                             "step": torch.from_numpy(np.array(np_state["step"]))}


def test_torch_elastic_matches_reference_through_a_midstep_kill(f32_families):
    np_params, np_state = _reference_state()
    steps, kill_at, victim = 4, 1, 1
    ref = jel.ElasticTrainer(ARCH, use_smoke=True, batch=BATCH, seq=SEQ, workers=3,
                             total_steps=steps, state=(np_params, np_state))
    got = ElasticTrainer(ARCH, use_smoke=True, batch=BATCH, seq=SEQ, workers=3,
                         total_steps=steps, state=_port_state(np_params, np_state), device="cpu")
    ill = None
    try:
        for t in (ref, got):
            t.run(kill_at)
            t.workers[victim].kill_at_step(t.cursor)
        for i in range(kill_at, steps):
            ref.step()
            got.step()
            b2, eps = ref._opt_cfg.b2, ref._opt_cfg.eps
            vhat = [np.sqrt(np.asarray(v) / (1 - b2 ** (i + 1)))
                    for v in jax.tree.leaves(ref.opt_state["v"])]
            now = [x < 10 * eps for x in vhat]
            ill = now if ill is None else [a | b for a, b in zip(ill, now)]
        np.testing.assert_allclose(got.history, ref.history, **LOSS_TOL)
        assert got.events == ref.events
        assert [e[0] for e in got.events] == ["death"]
        n_ill = 0
        for a, b, eps_bound in zip(tree_flatten(got.params)[0], jax.tree.leaves(ref.params), ill):
            a, b = a.numpy(), np.asarray(b)
            np.testing.assert_allclose(a[~eps_bound], b[~eps_bound], **PARAM_TOL)
            n_ill += int((~np.isclose(a, b, **PARAM_TOL) & eps_bound).sum())
        n = sum(x.size for x in ill)
        assert n_ill <= n // 1000, (n_ill, n)
    finally:
        ref.close()
        got.close()


def _results(rng, rows, lane):
    """Random shard replies in the reference's numpy wire format and the
    same as tensors."""
    shapes = [(3, 4), (7,), (2, 3, 5)]
    np_res, t_res = [], []
    for _ in rows:
        loss = np.float32(rng.standard_normal() + 10)
        if lane == "int8":
            q = [rng.integers(-127, 128, s, dtype=np.int8) for s in shapes]
            s = [np.float32(abs(rng.standard_normal()) / 127) for _ in shapes]
            np_res.append({"loss": loss, "q": q, "scales": s})
            t_res.append({"loss": torch.tensor(loss), "q": [torch.from_numpy(x) for x in q],
                          "scales": [torch.tensor(x) for x in s]})
        else:
            g = [rng.standard_normal(s).astype(np.float32) for s in shapes]
            np_res.append({"loss": loss, "grads": g})
            t_res.append({"loss": torch.tensor(loss), "grads": [torch.from_numpy(x) for x in g]})
    return np_res, t_res


@pytest.mark.parametrize("lane", ["plain", "int8"])
@pytest.mark.parametrize("rows", [[2, 1, 1], [2, 2, 2]])
def test_torch_combine_bit_equal_to_reference(rows, lane):
    rng = np.random.default_rng(sum(rows) + len(lane))
    np_res, t_res = _results(rng, rows, lane)
    B = sum(rows)
    want, want_loss = jel.ElasticTrainer._combine(np_res, rows, B)
    got, got_loss = ElasticTrainer._combine(t_res, rows, B)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert g.numpy().tobytes() == np.asarray(w, np.float32).tobytes()
    assert np.float32(got_loss.item()).tobytes() == np.float32(want_loss).tobytes()


def test_torch_shard_action_matches_reference(f32_families):
    np_params, _ = _reference_state(seed=3)
    fam = jel._get_family(ARCH, True, SEQ, BATCH)
    batch = jel.SyntheticTokens(fam["cfg"].vocab_size, SEQ, BATCH, seed=3).batch(0)
    payload = {"arch": ARCH, "smoke": True, "seq": SEQ, "global_batch": BATCH, "step": 0,
               "params": jax.tree.leaves(np_params), "tokens": batch["tokens"][:2],
               "labels": batch["labels"][:2], "compress": False, "ckey": 11}
    want = jel.shard_action(payload)
    got = tel.shard_action({**payload, "device": "cpu"})
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), **LOSS_TOL)
    assert len(got["grads"]) == len(want["grads"])
    for g, w in zip(got["grads"], want["grads"]):
        np.testing.assert_allclose(g.numpy(), w, **GRAD_TOL)


# ---------------------------------------------------------------------------
# the port's own
# ---------------------------------------------------------------------------


def test_torch_int8_lane_kill_tail_bit_identical_and_within_bound():
    """The int8 lane: a kill inside step 1 gives a tail bit-identical to a
    clean 2-worker run from the snapshot (the rounding is seeded by the
    task's ckey).  And the gradient the update consumes lies within the
    int8 bound of the uncompressed one: per leaf, |g_int8 - g| <= sum over
    shards of w_s x scale_s (stochastic rounding moves an element by less
    than one step), up to f32 rounding of the sums."""
    t = _trainer(workers=3, grad_compression=True)
    try:
        t.run(1)
        snap = t.snapshot()
        t.workers[0].kill_at_step(t.cursor)
        tail = t.run(3)["losses"]
        assert [e[:3] for e in t.events] == [("death", 1, 0)]
    finally:
        t.close()
    ref = _trainer(workers=2, grad_compression=True, state=(snap["params"], snap["opt_state"]),
                   start_step=snap["step"])
    try:
        assert ref.run(3)["losses"] == tail
        batch = ref.source.batch(ref.cursor)
        flat = tree_flatten(ref.params)[0]
        shards = ref._split(batch, 3)
        dev = ref.workers[0]._device()
        rows = [int(s["tokens"].shape[0]) for s in shards]
        out = {}
        for lane in (False, True):
            ref.grad_compression = lane
            res = [tel._run_shard_local(ref._task(s, i, 3, flat), dev, "graph")
                   for i, s in enumerate(shards)]
            out[lane] = (ElasticTrainer._combine(res, rows, BATCH)[0], res)
    finally:
        ref.close()
    (plain, _), (packed, res) = out[False], out[True]
    for i, (g, q) in enumerate(zip(plain, packed)):
        bound = sum(r / BATCH * float(x["scales"][i]) for r, x in zip(rows, res))
        assert float((q - g).abs().max()) <= bound * (1 + 1e-5) + 1e-12, (i, bound)


def test_torch_graph_and_jit_routes_give_equal_losses(monkeypatch):
    losses = {}
    for route in ("graph", "jit"):
        monkeypatch.setenv("REPRO_ELASTIC_ROUTE", route)
        t = _trainer(workers=3)
        try:
            assert {w.route for w in t.workers} == {route}
            losses[route] = t.run(3)["losses"]
        finally:
            t.close()
    assert losses["graph"] == losses["jit"]


def test_torch_parcel_workers_refused_naming_item_10():
    """Parcel workers train (the parcel-route tests); what is still
    refused around them: a port of CUDA localities without a card (a
    locality never takes the CPU instead), a shard to a killed locality
    (it fails fast), and a device mesh on the elastic route."""
    from repro_torch.launch.train import train

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="found no cuda device"):
            LoopbackParcelport(2)
    port = LoopbackParcelport(1, platform="cpu")
    try:
        w = ParcelWorker(0, port, port.localities()[0].process_index)
        assert w.alive()
        w.kill()
        assert not w.alive() and not port.alive(w.lid)
        with pytest.raises(RuntimeError, match="failed fast"):
            w.run_shard({"step": 0}).get()
    finally:
        port.shutdown()
    with pytest.raises(ValueError, match="not over a device mesh"):
        train(ARCH, steps=1, device="cpu", elastic=True, mesh=object())


# ---------------------------------------------------------------------------
# the parcel route (tests/test_elastic_train.py:131,161, then the reference
# and a 2-process cluster)
# ---------------------------------------------------------------------------


def test_torch_parcel_route_kill_recovers_and_leaks_nothing():
    before = set(glob.glob("/dev/shm/psm_*"))
    port = LoopbackParcelport(n_localities=3, platform="cpu")
    try:
        t = _trainer(workers=3, seed=1, port=port)
        try:
            assert [w.kind for w in t.workers] == ["parcel"] * 3
            t.run(1)
            snap = t.snapshot()
            t.workers[2].kill_at_step(t.cursor)  # parcel fails fast mid-step
            tail = t.run(2)["losses"]
            assert [e[0] for e in t.events].count("death") == 1
            assert len(t.active_workers()) == 2
            t.workers[2].revive()  # recovered locality re-admitted
            t.run(1)
            assert len(t.active_workers()) == 3
        finally:
            t.close()
        # remote (loopback) gradients match the local route bit-for-bit
        ref = _trainer(workers=2, seed=1, state=(snap["params"], snap["opt_state"]),
                       start_step=snap["step"])
        try:
            assert tail == ref.run(2)["losses"]
        finally:
            ref.close()
    finally:
        port.shutdown()
    leaked = set(glob.glob("/dev/shm/psm_*")) - before
    assert not leaked, f"shm segments leaked past shutdown: {sorted(leaked)}"


def test_torch_dropped_parcels_retry_then_reshard_after_link_death():
    port = LoopbackParcelport(n_localities=2, platform="cpu")
    try:
        inj = FaultInjector(seed=0)
        t = _trainer(workers=2, port=port, max_retries=2)
        try:
            lid0 = t.workers[0].lid
            # one transient drop: re-sent to the SAME worker, not a death
            inj.drop_parcels(port, actions=["invoke"], localities=[lid0], count=1)
            t.step()
            assert [e[0] for e in t.events] == ["retry"]
            assert len(t.active_workers()) == 2
            # persistent drops: retries exhaust, link declared dead, reshard
            inj.drop_parcels(port, actions=["invoke"], localities=[lid0], p=1.0)
            t.step()
            kinds = [e[0] for e in t.events]
            assert kinds.count("retry") == 1 + t.max_retries
            assert kinds.count("death") == 1
            assert [w.wid for w in t.active_workers()] == [1]
        finally:
            inj.clear_parcel_faults(port)
            t.close()
    finally:
        port.shutdown()


def test_torch_parcel_route_matches_reference_through_a_midstep_kill(f32_families):
    """The port's loopback parcel route against the reference's
    ``ElasticTrainer(port=LoopbackParcelport(3))`` from the same state: a
    kill inside step 1 of 4; losses, params and events as in
    ``test_torch_elastic_matches_reference_through_a_midstep_kill``."""
    from repro.core.parcel import LoopbackParcelport as JaxLoopback

    np_params, np_state = _reference_state()
    steps, kill_at, victim = 4, 1, 1
    jport, tport = JaxLoopback(3), LoopbackParcelport(3, platform="cpu")
    ref = got = None
    try:
        ref = jel.ElasticTrainer(ARCH, use_smoke=True, batch=BATCH, seq=SEQ, port=jport,
                                 total_steps=steps, state=(np_params, np_state))
        got = ElasticTrainer(ARCH, use_smoke=True, batch=BATCH, seq=SEQ, port=tport,
                             total_steps=steps, state=_port_state(np_params, np_state),
                             device="cpu")
        ill = None
        for t in (ref, got):
            t.run(kill_at)
            t.workers[victim].kill_at_step(t.cursor)
        for i in range(kill_at, steps):
            ref.step()
            got.step()
            b2, eps = ref._opt_cfg.b2, ref._opt_cfg.eps
            vhat = [np.sqrt(np.asarray(v) / (1 - b2 ** (i + 1)))
                    for v in jax.tree.leaves(ref.opt_state["v"])]
            now = [x < 10 * eps for x in vhat]
            ill = now if ill is None else [a | b for a, b in zip(ill, now)]
        np.testing.assert_allclose(got.history, ref.history, **LOSS_TOL)
        assert [e[:3] for e in got.events] == [e[:3] for e in ref.events]
        assert [e[0] for e in got.events] == ["death"]
        n_ill = 0
        for a, b, eps_bound in zip(tree_flatten(got.params)[0], jax.tree.leaves(ref.params), ill):
            a, b = a.numpy(), np.asarray(b)
            np.testing.assert_allclose(a[~eps_bound], b[~eps_bound], **PARAM_TOL)
            n_ill += int((~np.isclose(a, b, **PARAM_TOL) & eps_bound).sum())
        n = sum(x.size for x in ill)
        assert n_ill <= n // 1000, (n_ill, n)
    finally:
        for t in (ref, got):
            if t is not None:
                t.close()
        jport.shutdown()
        tport.shutdown()


def test_torch_cluster_parcel_route_sigkill_tail_bit_identical():
    """Two worker processes on the CPU; worker 1 SIGKILLed inside step 2:
    the step reshards onto the survivor, and the tail equals a clean
    1-worker local run from the snapshot, bit for bit (the worker replays
    the same shard graph a LocalWorker does).  No worker process and no
    shm segment outlives the port."""
    before = set(glob.glob("/dev/shm/psm_*"))
    port = LocalClusterParcelport(n_workers=2, heartbeat_timeout=60.0, platform="cpu")
    try:
        t = _trainer(port=port, seed=2)
        try:
            t.run(2)
            snap = t.snapshot()
            pid = port.process(t.workers[1].lid).pid
            t.workers[1].kill_at_step(t.cursor)
            tail = t.run(2)["losses"]
            assert [e[:3] for e in t.events] == [("death", 2, 1)]
            assert not port.process(t.workers[1].lid).is_alive()
            assert [w.wid for w in t.active_workers()] == [0]
        finally:
            t.close()
    finally:
        port.shutdown()
    assert pid not in [p.pid for p in multiprocessing.active_children()]
    assert not set(glob.glob("/dev/shm/psm_*")) - before
    ref = _trainer(workers=1, seed=2, state=(snap["params"], snap["opt_state"]),
                   start_step=snap["step"])
    try:
        assert ref.run(2)["losses"] == tail
    finally:
        ref.close()


def test_torch_reset_runtime_drops_shard_graphs():
    t = _trainer(workers=2)
    try:
        t.step()
    finally:
        t.close()
    assert tel._GEXECS and tel._PROGRAMS
    gids = [node.buf.gid for _g, params, tok, lab, _l in tel._GEXECS.values()
            for node in (*params, tok, lab)]
    assert all(agas.registry.resolve(g) is not None for g in gids)
    reset_runtime()
    assert not tel._GEXECS and not tel._PROGRAMS
    for g in gids:
        with pytest.raises(KeyError):
            agas.registry.resolve(g)
    t = _trainer(workers=2)  # a fresh runtime captures again
    try:
        assert np.isfinite(t.step())
        assert len(tel._GEXECS) == 1
    finally:
        t.close()
