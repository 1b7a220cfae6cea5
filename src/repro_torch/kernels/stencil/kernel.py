"""CUDA kernel wrapper: PRK 3-point stencil (paper Fig. 3 workload).

Replaces ``src/repro/kernels/stencil/kernel.py:stencil``.  The kernel is
``csrc/stencil.cu`` (see its header for the bound and the design); this
wrapper checks the input, allocates the output and launches on the current
CUDA stream.  ``launches`` counts the launches made.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import note_launch
from repro_torch.kernels._launch import run_elementwise_1d

launches = 0


def stencil(x: "torch.Tensor", *, block=None, grid=None) -> "torch.Tensor":
    """``0.5*x[i-1] + x[i] + 0.5*x[i+1]`` (zero halos) of a contiguous 1-D
    f32/bf16 CUDA tensor; ``block``/``grid`` are the CUDA launch geometry
    (threads per block, blocks), by default 256 threads per block and one
    thread per element."""
    global launches
    y = run_elementwise_1d("stencil", x, block, grid)
    launches += 1
    note_launch("stencil")
    return y
