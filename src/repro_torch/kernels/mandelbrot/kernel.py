"""CUDA kernel wrapper: Mandelbrot escape iterations (paper Fig. 5 workload).

Replaces ``src/repro/kernels/mandelbrot/kernel.py:mandelbrot``.  The kernel
is ``csrc/mandelbrot.cu`` (see its header for the bound, the design and
the rounding rule); this wrapper checks the geometry, allocates the output
and launches on the current CUDA stream.  ``launches`` counts the launches
made; ``last_geometry`` is the (grid x, grid y, block x, block y) the last
one passed to the C entry; ``warp_rounds`` and ``block_steps`` read the
kernel's warp placement and block lengths from the built library.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, note_launch
from repro_torch.kernels._launch import dim
from repro_torch.kernels.mandelbrot.ref import X_RANGE, Y_RANGE, pixel_step

launches = 0
last_geometry = None

# Under the default grid each thread takes up to this many columns and
# rows of pixels, spread over the whole image (the grid covers an eighth
# of the width and a quarter of the height; the kernel's grid-stride loop
# the rest), so that every block does about the same work.  On fig5's
# image (4096^2) 8 x 4 beat 4 x 8, 4 x 4 and one pixel a thread on an H100
# (tools/profile_torch_mandelbrot.py).  A smaller image takes fewer pixels
# a thread, so that the grid keeps MIN_BLOCKS_AN_SM blocks for each SM.
COLUMNS_A_THREAD, ROWS_A_THREAD = 8, 4
MIN_BLOCKS_AN_SM = 4

_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
         ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_ROUNDS_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _lib() -> "ctypes.CDLL":
    lib = _build.load("mandelbrot")
    lib.mandelbrot_i32.argtypes, lib.mandelbrot_i32.restype = _ARGS, ctypes.c_int
    lib.mandelbrot_warp_rounds.argtypes = _ROUNDS_ARGS
    lib.mandelbrot_warp_rounds.restype = ctypes.c_int
    return lib


def block_steps() -> "tuple[int, int]":
    """(K0, K) of the built kernel: the warm-up steps tested one at a time,
    and the steps of each branch-free block."""
    lib = _lib()
    return lib.mandelbrot_warm_up_steps(), lib.mandelbrot_block_steps()


def geometry(height: int, width: int, block=None, grid=None, *,
             sms: int) -> "tuple[int, int, int, int]":
    """(grid x, grid y, block x, block y) of a launch on a card of ``sms``
    SMs.  ``block`` is (threads along a row, rows), by default (32, 8).
    The default grid gives each thread ``COLUMNS_A_THREAD`` x
    ``ROWS_A_THREAD`` pixels, halving the larger of the two (columns on a
    tie) while the grid has fewer than ``MIN_BLOCKS_AN_SM`` x ``sms``
    blocks.  A grid the caller gives is taken as it is, and the kernel's
    grid-stride loop covers the image with it."""
    bx, by = dim(block, 0, 32), dim(block, 1, 8)
    if bx < 1 or by < 1 or bx * by > 1024:
        raise ValueError(f"mandelbrot: block ({bx}, {by}) must hold 1..1024 threads")
    cols, rows = COLUMNS_A_THREAD, ROWS_A_THREAD
    while True:
        gx, gy = -(-width // (bx * cols)), -(-height // (by * rows))
        if gx * gy >= MIN_BLOCKS_AN_SM * sms or cols * rows == 1:
            break
        cols, rows = (cols // 2, rows) if cols >= rows else (cols, rows // 2)
    gx, gy = dim(grid, 0, gx), dim(grid, 1, gy)
    if not (1 <= gx <= 2**31 - 1 and 1 <= gy <= 65535):
        raise ValueError(f"mandelbrot: grid ({gx}, {gy}) is out of range")
    return gx, gy, bx, by


def _sms(dev: "torch.device") -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def warp_rounds(height: int, width: int, *, device, block=None,
                grid=None) -> "torch.Tensor":
    """int64 (height, width): for each pixel, the id of the warp round that
    computes it in a launch of the kernel at ``geometry(height, width,
    block, grid)``, as the kernel's library places threads (its
    ``mandelbrot_warp_rounds``): the warp in the high 32 bits, the pass of
    its thread's grid-stride loop in the low.  Not a launch of the kernel:
    ``launches`` does not count it."""
    dev = torch.device(device)
    gx, gy, bx, by = geometry(height, width, block, grid, sms=_sms(dev))
    lib = _lib()
    out = torch.empty((height, width), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        err = lib.mandelbrot_warp_rounds(out.data_ptr(), height, width, gx, gy, bx, by,
                                         torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "mandelbrot warp rounds")
    return out


def mandelbrot(height: int, width: int, max_iter: int = 64, *, device,
               block=None, grid=None) -> "torch.Tensor":
    """int32 (height, width) escape counts over [-2, 1] x [-1.5, 1.5] on the
    CUDA ``device``, launched with ``geometry(height, width, block, grid)``
    for the device's SMs."""
    global launches, last_geometry
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"mandelbrot: the CUDA kernel needs a CUDA device, got {dev}")
    if height < 1 or width < 1 or max_iter < 0:
        raise ValueError(f"mandelbrot: bad size {height}x{width} or max_iter={max_iter}")
    gx, gy, bx, by = geometry(height, width, block, grid, sms=_sms(dev))
    lib = _lib()
    out = torch.empty((height, width), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mandelbrot_i32(
            out.data_ptr(), height, width, max_iter, X_RANGE[0], Y_RANGE[0],
            pixel_step(*X_RANGE, width), pixel_step(*Y_RANGE, height), gx, gy, bx, by, stream,
        )
    _build.check(lib, err, "mandelbrot")
    launches += 1
    note_launch("mandelbrot")
    last_geometry = (gx, gy, bx, by)
    return out
