"""Plain PyTorch version of the Mandelbrot escape-iteration kernel (paper
Fig. 5).

The pixel coordinates follow the reference kernel exactly:
``x0 + col * f32((x1 - x0) / (W - 1))`` (and the same for rows), not a
linspace, whose points differ from these in the last bit.  Each eager op
rounds once, as the CUDA kernel's per-operation rounding does, so the two
agree bit for bit on the card.
"""
import numpy as np
import torch

X_RANGE = (-2.0, 1.0)
Y_RANGE = (-1.5, 1.5)


def pixel_step(lo: float, hi: float, n: int) -> "np.float32":
    """The f32 distance between neighbouring pixels: the quotient is taken
    in double, then rounded once to f32, as the reference kernel does."""
    return np.float32((hi - lo) / max(n - 1, 1))


def mandelbrot_ref(height: int, width: int, max_iter: int = 64, device=None) -> "torch.Tensor":
    dev = torch.device("cpu") if device is None else torch.device(device)
    dx = float(pixel_step(*X_RANGE, width))
    dy = float(pixel_step(*Y_RANGE, height))
    cols = torch.arange(width, dtype=torch.float32, device=dev)
    rows = torch.arange(height, dtype=torch.float32, device=dev)
    cr = (X_RANGE[0] + cols * dx).expand(height, width)
    ci = (Y_RANGE[0] + rows * dy)[:, None].expand(height, width)

    zr = torch.zeros((height, width), dtype=torch.float32, device=dev)
    zi = torch.zeros_like(zr)
    it = torch.zeros((height, width), dtype=torch.int32, device=dev)
    for _ in range(max_iter):
        zr2, zi2 = zr * zr, zi * zi
        live = zr2 + zi2 <= 4.0
        nzr = zr2 - zi2 + cr
        nzi = 2.0 * zr * zi + ci
        zr = torch.where(live, nzr, zr)
        zi = torch.where(live, nzi, zi)
        it += live
    return it
