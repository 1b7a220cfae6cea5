"""Asynchronous checkpointing (``src/repro/checkpoint/checkpoint.py`` on
PyTorch), in the reference's format, so either package restores what the
other wrote.

The paper's Fig. 5 pattern at framework scale: training never blocks on
file I/O; the device->host snapshot is taken on the caller's thread and
the serialization runs as a future on the runtime's writer queue,
overlapped with the next training step.

Format: a step directory ``step_XXXXXXXX`` holding one ``arrays.npz``
(leaves keyed by their ``/``-joined tree paths: dict keys sorted, list and
tuple indices) and a JSON ``manifest.json`` (step, tree structure, keys,
shapes, dtypes, the caller's ``extra``).  A save is written to
``step_XXXXXXXX.tmp`` and published by rename, so a writer killed
mid-save never leaves a torn step visible; a new manager sweeps such
staging directories.  Restore loads on the host and places each leaf like
the matching leaf of ``like`` (its dtype and device).

Under a device mesh a ``DTensor`` leaf is saved as its full value (every
rank takes part in gathering it; in a process group of several ranks only
rank 0 writes, and the others wait for it before a restore), and
``restore(shardings=...)`` distributes each leaf onto the target mesh's
placements, which may be another mesh than the one saved from.
"""
from __future__ import annotations

import json
import re
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.executor import get_runtime
from repro_torch.core.futures import Future
from repro_torch.pytree import tree_flatten_with_path, tree_unflatten

__all__ = ["CheckpointManager"]

_SEP = "/"

# Only fully-published checkpoints look like this; a writer killed
# mid-save leaves ``step_XXXXXXXX.tmp`` behind, which must never be
# listed (it may hold a torn npz) and is swept on the next manager.
_STEP_DIR = re.compile(r"^step_(\d{8})$")


def _key(path) -> str:
    return _SEP.join(str(p) for p in path)


def _writes() -> bool:
    """Whether this process writes checkpoints: every process but the
    ranks other than 0 of a process group."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def _host(leaf) -> np.ndarray:
    """A leaf as a host numpy array (a device tensor is copied back; a
    ``DTensor`` gathered whole)."""
    from torch.distributed.tensor import DTensor

    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError("CheckpointManager: bfloat16 leaves have no numpy dtype here; "
                            "checkpoint the f32 master params")
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _like(arr: np.ndarray, ref, sharding=None):
    """``arr`` in the dtype and on the device of ``ref``: on ``sharding``'s
    mesh and placements where one is given, else on a ``DTensor`` ref's."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if sharding is not None or isinstance(ref, DTensor):
        t = torch.from_numpy(np.array(arr))
        t = t.to(dtype=ref.dtype if isinstance(ref, torch.Tensor) else torch.as_tensor(
            np.asarray(ref)).dtype)
        if sharding is None:
            return distribute_tensor(t.to(ref.device), ref.device_mesh, ref.placements,
                                     src_data_rank=None)
        t = t.to(sharding.mesh.device_type)
        return sharding.distribute(t, src_data_rank=None)
    if isinstance(ref, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(device=ref.device, dtype=ref.dtype)
    return np.asarray(arr).astype(np.asarray(ref).dtype)


class CheckpointManager:
    """Double-buffered async checkpointing with retention."""

    def __init__(self, directory: str, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._writer = get_runtime().queue(f"ckpt-writer:{directory}")
        self._pending: "Optional[Future]" = None
        self._lock = threading.Lock()
        self._sweep_torn()

    def _sweep_torn(self) -> None:
        """Remove staging dirs a killed writer left behind.  Single-writer
        discipline (one manager per directory) makes this safe: any
        ``.tmp`` visible to a fresh manager is an orphan, never in-flight."""
        for d in self.dir.glob("step_*.tmp"):
            if d.is_dir():
                shutil.rmtree(d, ignore_errors=True)

    # -- save ---------------------------------------------------------------

    def save_async(self, step: int, state: Any, extra: "dict | None" = None) -> Future:
        """Snapshot ``state`` and write it in the background.

        Returns a future completing when the checkpoint is durable.  If the
        previous save hasn't drained yet we wait for it first (double
        buffering: bounded memory).
        """
        with self._lock:
            if self._pending is not None and not self._pending.done():
                self._pending.wait()

        # 1) device -> host snapshot (blocks only for the copy, not the I/O)
        pairs, treedef = tree_flatten_with_path(state)
        host = {_key(path): _host(leaf) for path, leaf in pairs}

        # 2) serialize on the writer queue (off the training thread)
        def _write():
            if not _writes():
                return {"step": step, "seconds": 0.0, "path": str(self.dir / f"step_{step:08d}")}
            t0 = time.time()
            step_dir = self.dir / f"step_{step:08d}"
            tmp = step_dir.with_suffix(".tmp")
            if tmp.exists():  # a crashed writer's leftovers must not leak
                shutil.rmtree(tmp)  # into the directory we publish
            tmp.mkdir(parents=True)
            np.savez(tmp / "arrays.npz", **host)
            manifest = {
                "step": step,
                "treedef": str(treedef),
                "keys": sorted(host.keys()),
                "shapes": {k: list(v.shape) for k, v in host.items()},
                "dtypes": {k: str(v.dtype) for k, v in host.items()},
                "extra": extra or {},
                "written_at": time.time(),
            }
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            if step_dir.exists():  # re-save of a restored step
                shutil.rmtree(step_dir)
            tmp.rename(step_dir)  # atomic publish: torn state never visible
            self._gc()
            return {"step": step, "seconds": time.time() - t0, "path": str(step_dir)}

        fut = self._writer.submit(_write)
        with self._lock:
            self._pending = fut
        return fut

    def wait(self) -> None:
        with self._lock:
            p = self._pending
        if p is not None:
            p.wait()

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[: -self.keep] if self.keep else []:
            d = self.dir / f"step_{s:08d}"
            for f in d.iterdir():
                f.unlink()
            d.rmdir()

    # -- restore --------------------------------------------------------------

    def steps(self) -> "list[int]":
        """Fully-published checkpoint steps only: the name filter skips
        ``.tmp`` staging dirs (a writer killed mid-save must never surface
        as ``latest_step``: atomicity is publish-by-rename)."""
        out = []
        for d in self.dir.glob("step_*"):
            m = _STEP_DIR.match(d.name)
            if m and d.is_dir():
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> "Optional[int]":
        s = self.steps()
        return s[-1] if s else None

    def restore(self, like: Any, step: "Optional[int]" = None, shardings: Any = None):
        """Load a checkpoint into the structure of ``like``: each leaf takes
        the dtype and device of ``like``'s (a numpy leaf stays numpy; a
        ``DTensor`` leaf keeps its mesh and placements).  ``shardings``, a
        pytree of ``distribution.sharding.NamedSharding``s matching
        ``like``, restores each leaf onto its mesh and placements instead.
        Returns (state, extra).
        """
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        step_dir = self.dir / f"step_{step:08d}"
        manifest = json.loads((step_dir / "manifest.json").read_text())
        with np.load(step_dir / "arrays.npz") as z:
            host = {k: z[k] for k in z.files}

        pairs, treedef = tree_flatten_with_path(like)
        shards = [None] * len(pairs) if shardings is None else tree_flatten_with_path(shardings)[0]
        if len(shards) != len(pairs):
            raise ValueError(f"restore: {len(shards)} shardings for {len(pairs)} leaves")
        new_leaves = []
        for (path, ref), sh in zip(pairs, shards):
            k = _key(path)
            if k not in host:
                raise KeyError(f"checkpoint {step_dir} missing leaf {k}")
            new_leaves.append(_like(host[k], ref, None if sh is None else sh[1]))
        return tree_unflatten(treedef, new_leaves), manifest.get("extra", {})
