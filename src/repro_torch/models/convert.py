"""Carry a JAX param tree across to the port.

The caller turns the JAX params into numpy arrays
(``jax.tree.map(np.asarray, params)``); ``params_from_numpy`` checks every
name and shape against the port's own layout and returns torch tensors, so
both packages compute with the same weights.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.model import get_model

__all__ = ["params_from_numpy"]


def params_from_numpy(cfg, tree, *, device="cuda", dtype=torch.float32):
    """Nested dicts and lists of numpy arrays (the JAX tree's names and shapes) ->
    the same tree of ``dtype`` tensors on ``device``, the card unless the
    caller asks for another.  bf16 arrays widen to f32 exactly on the way."""
    want = get_model(cfg).param_shapes(cfg)

    def conv(want_node, node, path):
        if isinstance(want_node, dict):
            if not isinstance(node, dict) or set(node) != set(want_node):
                got = sorted(node) if isinstance(node, dict) else type(node).__name__
                raise KeyError(f"params{path}: expected keys {sorted(want_node)}, got {got}")
            return {k: conv(want_node[k], node[k], f"{path}[{k!r}]") for k in want_node}
        if isinstance(want_node, list):
            if not isinstance(node, (list, tuple)) or len(node) != len(want_node):
                got = len(node) if isinstance(node, (list, tuple)) else type(node).__name__
                raise KeyError(f"params{path}: expected a list of {len(want_node)}, got {got}")
            return [conv(w, n, f"{path}[{i}]") for i, (w, n) in enumerate(zip(want_node, node))]
        arr = np.asarray(node)
        if tuple(arr.shape) != tuple(want_node):
            raise ValueError(f"params{path}: expected shape {tuple(want_node)}, got {arr.shape}")
        return torch.from_numpy(np.array(arr, dtype=np.float32)).to(device=device, dtype=dtype)

    return conv(want, tree, "")
