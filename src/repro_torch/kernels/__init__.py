"""Kernel packages, each with a hand-written CUDA kernel (``csrc/*.cu``),
its ctypes wrapper (``kernel.py``), a plain PyTorch version (``ref.py``)
and the ``impl=`` dispatch with its ``KERNELS`` registry (``ops.py``).
``all_kernels()`` aggregates every package's registry lazily, in the
reference package's order, so importing ``repro_torch.kernels`` stays
cheap and builds nothing."""
from __future__ import annotations

import importlib

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
    """Zero every wrapper's ``launches``, and its ``kernel_launches``
    where one call launches several kernels."""
    for pkg in _PACKAGES:
        mod = importlib.import_module(f"repro_torch.kernels.{pkg}.kernel")
        mod.launches = 0
        if hasattr(mod, "kernel_launches"):
            mod.kernel_launches = 0


__all__ = ["all_kernels", "launch_counts", "reset_launch_counts"]
