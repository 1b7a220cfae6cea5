"""Gradient compression: per-tensor int8 quantization with stochastic
rounding (``src/repro/training/grad_compression.py`` on PyTorch).

Stochastic rounding keeps the quantized gradient unbiased (E[q] = g) at
4x fewer bytes than f32.  The reference draws its rounding bits from
``jax.random``; the port draws them from an explicit ``torch.Generator``
(on the gradient's device), so the same generator state gives the same
bits, and a tree draws its leaves one after another in ``tree_flatten``
order.
"""
from __future__ import annotations

import torch

from repro_torch.pytree import tree_flatten, tree_map, tree_unflatten

__all__ = ["compress", "compress_tree", "decompress", "decompress_tree"]


def compress(g: "torch.Tensor", generator: "torch.Generator"
             ) -> "tuple[torch.Tensor, torch.Tensor]":
    """g: float tensor -> (int8 q, f32 scale). Stochastic rounding: unbiased."""
    gf = g.to(torch.float32)
    scale = torch.clamp(torch.max(torch.abs(gf)), min=1e-30) / 127.0
    x = gf / scale
    lo = torch.floor(x)
    p_up = x - lo  # probability of rounding up
    up = torch.rand(x.shape, generator=generator, device=x.device) < p_up
    q = torch.clamp(lo + up.to(torch.float32), -127, 127).to(torch.int8)
    return q, scale


def decompress(q: "torch.Tensor", scale: "torch.Tensor") -> "torch.Tensor":
    return q.to(torch.float32) * scale


def compress_tree(grads, generator: "torch.Generator"):
    """Pytree version; returns (q_tree, scale_tree)."""
    leaves, tdef = tree_flatten(grads)
    pairs = [compress(leaf, generator) for leaf in leaves]
    return tree_unflatten(tdef, [q for q, _ in pairs]), tree_unflatten(tdef, [s for _, s in pairs])


def decompress_tree(q_tree, scale_tree):
    return tree_map(decompress, q_tree, scale_tree)
