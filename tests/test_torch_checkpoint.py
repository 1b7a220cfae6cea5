"""The port's async checkpointing (``repro_torch.checkpoint``) on the CPU:
the port of ``tests/test_checkpoint.py`` (round trip, asynchrony,
retention, missing checkpoints, a writer killed mid-save, re-saving a
restored step, fail-stop resume), and the two cross-loads: a checkpoint
the JAX package writes is restored by the port bit for bit, and the other
way round (same ``arrays.npz`` keys, same manifest).
"""
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfg
from repro.checkpoint.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.models.model import get_model as jax_get_model
from repro.training.optimizer import init_opt_state as jax_init_opt_state
from repro_torch import configs as tcfg
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.models.convert import params_from_numpy
from repro_torch.pytree import tree_flatten, tree_map
from repro_torch.training.optimizer import init_opt_state

ROOT = Path(__file__).resolve().parents[1]


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn((8, 4), generator=g), "b": torch.zeros(4)},
        "opt": {"m": torch.ones((8, 4)), "step": torch.tensor(7, dtype=torch.int32)},
    }


def test_torch_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    st = _state()
    mgr.save_async(10, st, extra={"cursor": 42}).get()
    like = tree_map(torch.zeros_like, st)
    restored, extra = mgr.restore(like)
    assert extra["cursor"] == 42
    for a, b in zip(tree_flatten(st)[0], tree_flatten(restored)[0]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_torch_save_is_asynchronous(tmp_path):
    """save_async returns before the write lands; the future resolves it."""
    mgr = CheckpointManager(str(tmp_path))
    big = {"x": torch.ones((512, 512))}
    t0 = time.perf_counter()
    fut = mgr.save_async(1, big)
    t_submit = time.perf_counter() - t0
    info = fut.get()
    assert info["step"] == 1
    # submission must be much faster than the full write
    assert t_submit < max(info["seconds"], 0.05) + 0.05


def test_torch_retention_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    st = _state()
    for s in (1, 2, 3, 4):
        mgr.save_async(s, st).get()
    assert mgr.steps() == [3, 4]


def test_torch_latest_and_missing(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore({"a": torch.zeros(1)})


def test_torch_kill_mid_save_never_tears_latest_step(tmp_path):
    """A writer killed in the middle of ``save_async`` leaves only the
    previously-published checkpoint visible: the half-written step stays a
    ``.tmp`` staging dir (never listed, restore never reads it) and the
    next manager sweeps it."""
    child = textwrap.dedent(
        """
        import os
        import numpy as np
        from repro_torch.checkpoint.checkpoint import CheckpointManager

        d = os.environ["CKPT_DIR"]
        mgr = CheckpointManager(d)
        state = {"w": np.arange(64, dtype=np.float32)}
        mgr.save_async(1, state).get()          # durable baseline

        real_savez = np.savez
        def torn_savez(path, **arrays):          # half the bytes, then die
            real_savez(path, **arrays)
            with open(path, "r+b") as f:
                f.truncate(os.path.getsize(path) // 2)
            os._exit(42)                         # no atexit, no cleanup
        np.savez = torn_savez
        mgr.save_async(2, state).get()
        """
    )
    env = {**os.environ, "CKPT_DIR": str(tmp_path), "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", child], env=env, cwd=str(ROOT),
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 42, proc.stderr

    leftovers = sorted(p.name for p in tmp_path.iterdir())
    assert "step_00000002.tmp" in leftovers  # the kill really was mid-write

    mgr = CheckpointManager(str(tmp_path))  # crash-restart: sweeps the orphan
    assert mgr.steps() == [1]
    assert mgr.latest_step() == 1  # never the torn step
    restored, _ = mgr.restore({"w": np.zeros(64, np.float32)})
    np.testing.assert_array_equal(restored["w"], np.arange(64, dtype=np.float32))
    assert not list(tmp_path.glob("*.tmp"))  # orphan swept on construction


def test_torch_resave_of_restored_step_replaces_published_dir(tmp_path):
    """Re-saving a step that already exists (resume at k, checkpoint at k
    again) atomically replaces the published dir instead of failing."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(3, {"x": torch.zeros(4)}).get()
    mgr.save_async(3, {"x": torch.ones(4)}).get()
    assert mgr.steps() == [3]
    restored, _ = mgr.restore({"x": torch.zeros(4)})
    np.testing.assert_array_equal(restored["x"].numpy(), np.ones(4))


def test_torch_failstop_resume_is_deterministic(tmp_path):
    """Kill-and-resume reproduces the uninterrupted run exactly:
    train 8 straight vs train 4 + restore + 4 -> identical final loss."""
    from repro_torch.launch.train import train

    kw = dict(use_smoke=True, batch=2, seq=16, lr=1e-3, log_every=0, seed=5, device="cpu")
    full = train("olmo-1b", steps=8, ckpt_dir=str(tmp_path / "a"), ckpt_every=100, **kw)
    train("olmo-1b", steps=4, ckpt_dir=str(tmp_path / "b"), ckpt_every=4,
          schedule_total=8, **kw)  # LR horizon must match the uninterrupted run
    # "crash": start a fresh state and resume from the checkpoint
    resumed = train("olmo-1b", steps=8, ckpt_dir=str(tmp_path / "b"), resume=True,
                    ckpt_every=100, **kw)
    np.testing.assert_allclose(resumed["final_loss"], full["final_loss"], rtol=1e-5)


# ---------------------------------------------------------------------------
# cross-loads between the packages
# ---------------------------------------------------------------------------

def _jax_train_state():
    """Smoke olmo-1b params and a non-trivial AdamW state, as the JAX
    launcher checkpoints them: (params, opt_state)."""
    jc = jcfg.smoke(jcfg.get_config("olmo-1b"))
    params = jax_get_model(jc).init(jc, jax.random.key(3))
    state = jax_init_opt_state(params)
    state = {"m": jax.tree.map(lambda p: p * 0.5, params),
             "v": jax.tree.map(lambda p: p * p, params), "step": jnp.int32(11)}
    return params, state


def _port_like(cfg):
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, _jax_train_state()[0]), device="cpu")
    return tree_map(torch.zeros_like, (params, init_opt_state(params)))


def test_torch_restores_a_checkpoint_the_jax_package_wrote(tmp_path):
    jstate = _jax_train_state()
    JaxCheckpointManager(str(tmp_path)).save_async(
        5, jstate, extra={"step": 5, "cursor": 9}).get()
    cfg = tcfg.smoke(tcfg.get_config("olmo-1b"))
    restored, extra = CheckpointManager(str(tmp_path)).restore(_port_like(cfg))
    assert extra == {"step": 5, "cursor": 9}
    got, want = tree_flatten(restored)[0], jax.tree.leaves(jstate)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.numpy(), b)


def test_jax_package_restores_a_checkpoint_the_torch_port_wrote(tmp_path):
    jstate = _jax_train_state()
    cfg = tcfg.smoke(tcfg.get_config("olmo-1b"))
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jstate[0]), device="cpu")
    m = params_from_numpy(cfg, jax.tree.map(np.asarray, jstate[1]["m"]), device="cpu")
    v = params_from_numpy(cfg, jax.tree.map(np.asarray, jstate[1]["v"]), device="cpu")
    tstate = (params, {"m": m, "v": v, "step": torch.tensor(11, dtype=torch.int32)})
    CheckpointManager(str(tmp_path)).save_async(6, tstate, extra={"step": 6}).get()
    jmgr = JaxCheckpointManager(str(tmp_path))
    assert jmgr.steps() == [6]
    restored, extra = jmgr.restore(jax.tree.map(jnp.zeros_like, jstate))
    assert extra == {"step": 6}
    for a, b in zip(jax.tree.leaves(restored), tree_flatten(tstate)[0]):
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype
        np.testing.assert_array_equal(a, b.numpy())
