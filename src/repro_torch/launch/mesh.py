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
"""
from __future__ import annotations

import os
import shutil
import tempfile
import threading

import torch
import torch.distributed as dist

from repro_torch.core.executor import on_runtime_reset

__all__ = ["make_host_mesh", "make_production_mesh"]

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


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, "cuda")


def make_host_mesh(data: int = 1, model: int = 1, *, device_type: str = "cuda"):
    """A (data, model) mesh over this host's ranks: the card's unless the
    caller asks for ``device_type="cpu"``; the production axis names."""
    return _mesh((int(data), int(model)), ("data", "model"), device_type)


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
