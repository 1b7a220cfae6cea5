"""Public op + KERNELS registry (Program.from_file target)."""
from __future__ import annotations

import torch

from repro_torch.kernels.mandelbrot import kernel as _kernel
from repro_torch.kernels.mandelbrot.ref import mandelbrot_ref


def _size(size_arr) -> "tuple[int, int, torch.device]":
    """(height, width, device) from an int32[2] size tensor or array."""
    if isinstance(size_arr, torch.Tensor):
        h, w = (int(v) for v in size_arr.tolist())
        return h, w, size_arr.device
    h, w = (int(v) for v in size_arr)
    return h, w, torch.device("cpu")


def mandelbrot(size_arr, *, block=None, grid=None, impl: str = "auto", max_iter: int = 64):
    """size_arr: int32[2] = (height, width), a tensor so it can live in a
    Buffer; the image is computed on that tensor's device.  ``impl``:
    auto|cuda|ref — ``auto`` launches the CUDA kernel on a CUDA device (or
    raises) and takes the plain version only on the CPU."""
    if impl not in ("auto", "cuda", "ref"):
        raise ValueError(f"impl={impl!r}: use auto, cuda or ref")
    h, w, dev = _size(size_arr)
    if impl == "ref" or (impl == "auto" and dev.type != "cuda"):
        return mandelbrot_ref(h, w, max_iter, device=dev)
    return _kernel.mandelbrot(h, w, max_iter, device=dev, block=block, grid=grid)


mandelbrot.cuda_library = "mandelbrot"


def _mandelbrot_ref(size_arr, **_):
    h, w, dev = _size(size_arr)
    return mandelbrot_ref(h, w, device=dev)


KERNELS = {"mandelbrot": mandelbrot, "mandelbrot_ref": _mandelbrot_ref}
