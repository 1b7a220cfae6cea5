"""CUDA kernel wrapper: the partition benchmark map (paper Figs. 4 and 6).

Replaces ``src/repro/kernels/partition_map/kernel.py:partition_map``.  The
kernel is ``csrc/partition_map.cu`` (see its header for the bound and the
design); this wrapper checks the input, allocates the output and launches
on the current CUDA stream.  ``launches`` counts the launches made.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import note_launch
from repro_torch.kernels._launch import run_elementwise_1d

launches = 0


def partition_map(x: "torch.Tensor", *, block=None, grid=None) -> "torch.Tensor":
    """``sqrt(sin(x)^2 + cos(x)^2)`` of a contiguous 1-D f32/bf16 CUDA
    tensor; ``block``/``grid`` are the CUDA launch geometry (threads per
    block, blocks), by default 256 threads per block and one thread per
    element."""
    global launches
    y = run_elementwise_1d("partition_map", x, block, grid)
    launches += 1
    note_launch("partition_map")
    return y
