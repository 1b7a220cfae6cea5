"""Kernel packages, each with a hand-written CUDA kernel (``csrc/*.cu``),
its ctypes wrapper (``kernel.py``), a plain PyTorch version (``ref.py``)
and the ``impl=`` dispatch with its ``KERNELS`` registry (``ops.py``).
``all_kernels()`` aggregates every package's registry lazily, in the
reference package's order, so importing ``repro_torch.kernels`` stays
cheap and builds nothing.

Each wrapper counts its launches in its module's ``launches``
(``launch_counts``) and tells ``note_launch``, which tallies them for the
calling thread inside a ``tally_launches()`` block: a CUDA-graph capture
learns there which kernels every replay of the graph runs."""
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


_tally = threading.local()


@contextlib.contextmanager
def tally_launches():
    """``{package: launches}`` made by the kernel wrappers on THIS thread
    inside the block (other threads' launches are not counted)."""
    prev = getattr(_tally, "counts", None)
    counts: "dict[str, int]" = {}
    _tally.counts = counts
    try:
        yield counts
    finally:
        _tally.counts = prev


def note_launch(package: str) -> None:
    """Called by a wrapper where it launches its kernel."""
    counts = getattr(_tally, "counts", None)
    if counts is not None:
        counts[package] = counts.get(package, 0) + 1


__all__ = ["all_kernels", "launch_counts", "note_launch", "reset_launch_counts",
           "tally_launches"]
