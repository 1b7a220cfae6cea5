"""Mesh construction (``src/repro/launch/mesh.py`` on
``torch.distributed.device_mesh``).

Functions, so importing this module touches no process group.  Single
pod: 16x16 = 256 ranks, axes (data, model).  Multi-pod: 2x16x16 = 512
ranks, axes (pod, data, model); the ``pod`` axis composes with ``data``
for batch/FSDP sharding.

A ``DeviceMesh`` spans the ranks of a process group, one rank a device,
which the caller starts (``torch.distributed.init_process_group`` with an
address, a world size and a rank: nothing on a machine announces a
cluster).  With no group up, a one-rank mesh starts its own group on a
``FileStore`` in a temporary directory: NCCL on the card, gloo on the
CPU.  ``reset_runtime()`` destroys a group started here.  NCCL takes one
rank a GPU, so a mesh on one card has one rank.

``fake_world(ranks)`` stands a whole cluster up in this process: the
``fake`` backend over a ``FakeStore``, this process rank 0 of ``ranks``,
its collectives answered without communication.  The dry run
(``launch.dryrun``) lays a production mesh over it and traces a step on
fake tensors.
"""
from __future__ import annotations

import os
import shutil
import tempfile
import threading
from contextlib import contextmanager

import torch
import torch.distributed as dist

from repro_torch.core.executor import on_runtime_reset

__all__ = ["fake_world", "make_host_mesh", "make_production_mesh"]

_lock = threading.Lock()
_own_group: "str | None" = None  # the FileStore directory of a group started here


def _ensure_group(shape: tuple, device_type: str) -> None:
    """A process group of ``prod(shape)`` ranks, started here for one rank."""
    global _own_group
    want = 1
    for n in shape:
        want *= n
    with _lock:
        if dist.is_available() and dist.is_initialized():
            have = dist.get_world_size()
            if have != want:
                raise ValueError(f"a {shape} mesh needs {want} ranks; the process group has "
                                 f"{have}")
            return
        if want != 1:
            raise ValueError(f"a {shape} mesh needs {want} ranks; no process group is up (this "
                             "process is 1 rank): start a group of that size first")
        if device_type == "cuda":
            torch.cuda.set_device(torch.cuda.current_device())
        tmp = tempfile.mkdtemp(prefix="repro_mesh_")
        store = dist.FileStore(os.path.join(tmp, "store"), 1)
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo", store=store,
                                rank=0, world_size=1)
        _own_group = tmp


def _mesh(shape: tuple, names: tuple, device_type: str):
    from torch.distributed.device_mesh import init_device_mesh

    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type={device_type!r}: use 'cuda' or 'cpu'")
    _ensure_group(shape, device_type)
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The (16, 16) or (2, 16, 16) mesh over a process group of that many
    ranks (``fake_world`` makes one in a single process)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_host_mesh(data: int = 1, model: int = 1, *, device_type: str = "cuda"):
    """A (data, model) mesh over this host's ranks: the card's unless the
    caller asks for ``device_type="cpu"``; the production axis names."""
    return _mesh((int(data), int(model)), ("data", "model"), device_type)


@contextmanager
def fake_world(ranks: int, *, device_type: str = "cuda"):
    """A process group of ``ranks`` ranks of the ``fake`` backend for
    ``device_type``, this process rank 0, destroyed on exit.  Its
    collectives return at once, their outputs shaped but their values
    undefined: it serves tracing (fake tensors), not numbers.  Refuses
    with ``ValueError`` if a group is already up (one default group a
    process)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type={device_type!r}: use 'cuda' or 'cpu'")
    with _lock:
        if dist.is_initialized():
            raise ValueError(f"fake_world({ranks}): a process group of "
                             f"{dist.get_world_size()} ranks is already up")
        dist.init_process_group(f"{device_type}:fake", store=FakeStore(), rank=0,
                                world_size=int(ranks))
    try:
        yield
    finally:
        with _lock:
            if dist.is_initialized():
                dist.destroy_process_group()


@on_runtime_reset
def _on_runtime_reset() -> None:
    global _own_group
    with _lock:
        if _own_group is None:
            return
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(_own_group, ignore_errors=True)
        _own_group = None
