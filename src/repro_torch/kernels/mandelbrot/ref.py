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


def _coords(height: int, width: int, dev) -> "tuple[torch.Tensor, torch.Tensor]":
    """(cr, ci) of every pixel, (height, width) f32 each."""
    dx = float(pixel_step(*X_RANGE, width))
    dy = float(pixel_step(*Y_RANGE, height))
    cols = torch.arange(width, dtype=torch.float32, device=dev)
    rows = torch.arange(height, dtype=torch.float32, device=dev)
    cr = (X_RANGE[0] + cols * dx).expand(height, width)
    ci = (Y_RANGE[0] + rows * dy)[:, None].expand(height, width)
    return cr, ci


def _step(zr, zi, cr, ci):
    """z^2 + c and the test sum |z|^2 of the old z, each op rounded once."""
    zr2, zi2 = zr * zr, zi * zi
    return zr2 - zi2 + cr, 2.0 * zr * zi + ci, zr2 + zi2


def mandelbrot_ref(height: int, width: int, max_iter: int = 64, device=None) -> "torch.Tensor":
    dev = torch.device("cpu") if device is None else torch.device(device)
    cr, ci = _coords(height, width, dev)
    zr = torch.zeros((height, width), dtype=torch.float32, device=dev)
    zi = torch.zeros_like(zr)
    it = torch.zeros((height, width), dtype=torch.int32, device=dev)
    for _ in range(max_iter):
        nzr, nzi, s = _step(zr, zi, cr, ci)
        live = s <= 4.0
        zr = torch.where(live, nzr, zr)
        zi = torch.where(live, nzi, zi)
        it += live
    return it


def mandelbrot_blocked_ref(height: int, width: int, max_iter: int, K0: int, K: int,
                           device=None) -> "torch.Tensor":
    """The CUDA kernel's decomposition of ``mandelbrot_ref``, in plain
    PyTorch: where ``max_iter >= K0``, a warm-up of ``K0`` steps tested one
    at a time, then branch-free blocks of ``K`` steps whose test sums are
    kept and folded into one escape test; a block that shows an escape
    (a NaN or an inf counts as one) goes back to its start, and its kept
    sums give the first failing step.  Single steps end a ``max_iter``
    that is not a whole number of blocks.  A pixel's z runs on past its
    escape inside a block, as in the kernel; only its count is kept."""
    dev = torch.device("cpu") if device is None else torch.device(device)
    cr, ci = _coords(height, width, dev)
    zr = torch.zeros((height, width), dtype=torch.float32, device=dev)
    zi = torch.zeros_like(zr)
    count = torch.full((height, width), max_iter, dtype=torch.int32, device=dev)
    done = torch.zeros((height, width), dtype=torch.bool, device=dev)

    def single(n: int) -> None:
        nonlocal zr, zi
        zr, zi, s = _step(zr, zi, cr, ci)
        out = ~done & ~(s <= 4.0)
        count[out] = n
        done.logical_or_(out)

    n = 0
    if max_iter >= K0:
        for n in range(K0):
            single(n)
        n = K0
        while n <= max_iter - K:
            sums = []
            for _ in range(K):
                zr, zi, s = _step(zr, zi, cr, ci)
                sums.append(s)
            failed = ~(torch.stack(sums) <= 4.0)           # (K, height, width)
            out = ~done & failed.any(0)
            count[out] = (n + failed.int().argmax(0).int())[out]  # the first failing step
            done.logical_or_(out)
            n += K
    for m in range(n, max_iter):
        single(m)
    return count
