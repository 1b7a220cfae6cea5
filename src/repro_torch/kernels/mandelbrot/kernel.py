"""CUDA kernel wrapper: Mandelbrot escape iterations (paper Fig. 5 workload).

Replaces ``src/repro/kernels/mandelbrot/kernel.py:mandelbrot``.  The kernel
is ``csrc/mandelbrot.cu`` (see its header for the bound, the design and
the rounding rule); this wrapper checks the geometry, allocates the output
and launches on the current CUDA stream.  ``launches`` counts the launches
made.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import dim
from repro_torch.kernels.mandelbrot.ref import X_RANGE, Y_RANGE, pixel_step

launches = 0

_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
         ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def mandelbrot(height: int, width: int, max_iter: int = 64, *, device,
               block=None, grid=None) -> "torch.Tensor":
    """int32 (height, width) escape counts over [-2, 1] x [-1.5, 1.5] on the
    CUDA ``device``.  ``block`` is (threads along a row, rows), by default
    (32, 8); ``grid`` defaults to one thread per pixel."""
    global launches
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"mandelbrot: the CUDA kernel needs a CUDA device, got {dev}")
    if height < 1 or width < 1 or max_iter < 0:
        raise ValueError(f"mandelbrot: bad size {height}x{width} or max_iter={max_iter}")
    bx, by = dim(block, 0, 32), dim(block, 1, 8)
    if bx < 1 or by < 1 or bx * by > 1024:
        raise ValueError(f"mandelbrot: block ({bx}, {by}) must hold 1..1024 threads")
    gx, gy = dim(grid, 0, -(-width // bx)), dim(grid, 1, -(-height // by))
    if not (1 <= gx <= 2**31 - 1 and 1 <= gy <= 65535):
        raise ValueError(f"mandelbrot: grid ({gx}, {gy}) is out of range")
    lib = _build.load("mandelbrot")
    lib.mandelbrot_i32.argtypes, lib.mandelbrot_i32.restype = _ARGS, ctypes.c_int
    out = torch.empty((height, width), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mandelbrot_i32(
            out.data_ptr(), height, width, max_iter, X_RANGE[0], Y_RANGE[0],
            pixel_step(*X_RANGE, width), pixel_step(*Y_RANGE, height), gx, gy, bx, by, stream,
        )
    _build.check(lib, err, "mandelbrot")
    launches += 1
    return out
