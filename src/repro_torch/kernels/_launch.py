"""Argument checks and launch geometry shared by the kernel wrappers."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

__all__ = ["check_cuda_1d", "dim", "geometry_1d", "run_elementwise_1d"]

_ARGS_1D = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def dim(d, axis: int, default: "int | None") -> "int | None":
    """Component ``axis`` of a launch dimension (int, tuple or None)."""
    if d is None:
        return default
    if isinstance(d, int):
        return d if axis == 0 else 1
    return int(d[axis]) if axis < len(d) else 1


def check_cuda_1d(x, what: str) -> None:
    """Refuse what the 1-D kernels do not take: they read a contiguous,
    non-empty, 1-D f32 or bf16 tensor on a CUDA device."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{what}: expected a torch.Tensor, got {type(x).__name__}")
    if not x.is_cuda:
        raise ValueError(f"{what}: the CUDA kernel needs a CUDA tensor, got one on {x.device}")
    if x.dtype not in _SUFFIX:
        raise TypeError(f"{what}: dtype {x.dtype} is not float32 or bfloat16")
    if x.dim() != 1 or x.numel() == 0 or not x.is_contiguous():
        raise ValueError(f"{what}: expected a non-empty contiguous 1-D tensor, got "
                         f"shape {tuple(x.shape)}, contiguous={x.is_contiguous()}")


def geometry_1d(n: int, block, grid) -> "tuple[int, int]":
    """(blocks, threads) from a Dim3-like block/grid; the grid defaults to
    one thread per element (the kernels loop over any remainder)."""
    threads = dim(block, 0, 256)
    if not 1 <= threads <= 1024:
        raise ValueError(f"block.x={threads} threads: a CUDA block holds 1..1024")
    blocks = dim(grid, 0, -(-n // threads))
    if not 1 <= blocks <= 2**31 - 1:
        raise ValueError(f"grid.x={blocks} blocks is out of range")
    return blocks, threads


def run_elementwise_1d(name: str, x: "torch.Tensor", block, grid) -> "torch.Tensor":
    """Launch ``<name>_<f32|bf16>`` of ``csrc/<name>.cu`` on the current
    stream of ``x``'s device; returns the freshly allocated output."""
    check_cuda_1d(x, name)
    lib = _build.load(name)
    fn = getattr(lib, f"{name}_{_SUFFIX[x.dtype]}")
    fn.argtypes, fn.restype = _ARGS_1D, ctypes.c_int
    blocks, threads = geometry_1d(x.numel(), block, grid)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), y.data_ptr(), x.numel(), blocks, threads, stream)
    _build.check(lib, err, name)
    return y
