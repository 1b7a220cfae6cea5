"""Kernel packages, each with a hand-written CUDA kernel (``csrc/*.cu``),
its ctypes wrapper (``kernel.py``), a plain PyTorch version (``ref.py``)
and the ``impl=`` dispatch with its ``KERNELS`` registry (``ops.py``).
``all_kernels()`` aggregates every package's registry lazily, in the
reference package's order, so importing ``repro_torch.kernels`` stays
cheap and builds nothing.

Each wrapper counts its launches in its module's ``launches``
(``launch_counts``) and tells ``note_launch``, which tallies them inside a
``tally_launches(stream)`` block when they launch on that CUDA stream,
from whatever thread: a CUDA-graph capture learns there which kernels
every replay of the graph runs, those of a backward among them
(autograd's device thread issues a backward's kernels, a remat
recompute's too, on the stream of their forward)."""
from __future__ import annotations

import contextlib
import importlib
import threading

_PACKAGES = ("flash_attention", "mandelbrot", "paged_attention", "partition_map", "ssd_scan",
             "stencil")


def all_kernels() -> "dict[str, callable]":
    """name -> callable over every kernel package's KERNELS registry
    (qualified as ``<package>.<kernel>`` on collision, bare otherwise)."""
    out: "dict[str, callable]" = {}
    for pkg in _PACKAGES:
        mod = importlib.import_module(f"repro_torch.kernels.{pkg}.ops")
        for name, fn in getattr(mod, "KERNELS", {}).items():
            key = name if name not in out else f"{pkg}.{name}"
            out[key] = fn
    return out


def launch_counts() -> "dict[str, int]":
    """Launches made by each kernel wrapper since the last reset."""
    return {pkg: importlib.import_module(f"repro_torch.kernels.{pkg}.kernel").launches
            for pkg in _PACKAGES}


def reset_launch_counts() -> None:
    """Zero every wrapper's ``launches``, its ``kernel_launches`` where one
    call launches several kernels, and its ``noncausal_launches`` where it
    counts those apart."""
    for pkg in _PACKAGES:
        mod = importlib.import_module(f"repro_torch.kernels.{pkg}.kernel")
        mod.launches = 0
        for extra in ("kernel_launches", "noncausal_launches"):
            if hasattr(mod, extra):
                setattr(mod, extra, 0)


# CUDA stream (its handle) -> the tally of the block that names it
_stream_tallies: "dict[int, dict[str, int]]" = {}
_stream_lock = threading.Lock()


@contextlib.contextmanager
def tally_launches(stream):
    """``{package: launches}`` made by the kernel wrappers on ``stream``
    (a ``torch.cuda.Stream``) inside the block, by any thread."""
    key = stream.cuda_stream
    counts: "dict[str, int]" = {}
    with _stream_lock:
        _stream_tallies[key] = counts
    try:
        yield counts
    finally:
        with _stream_lock:
            _stream_tallies.pop(key, None)


def note_launch(package: str) -> None:
    """Called by a wrapper where it launches its kernel (on the current
    CUDA stream)."""
    if not _stream_tallies:
        return
    import torch

    with _stream_lock:
        counts = _stream_tallies.get(torch.cuda.current_stream().cuda_stream)
        if counts is not None:
            counts[package] = counts.get(package, 0) + 1


__all__ = ["all_kernels", "launch_counts", "note_launch", "reset_launch_counts",
           "tally_launches"]
