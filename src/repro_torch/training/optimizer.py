"""AdamW built from scratch (``src/repro/training/optimizer.py`` on
PyTorch): f32 moments, decoupled weight decay, global-norm clipping,
linear-warmup + cosine schedule.

The arithmetic is the reference's, operation for operation, on f32
tensors: the step counter is an int32 tensor and every scalar (the
learning rate, the bias corrections, the clip scale) is a 0-dim f32
tensor on the params' device, so a step reads nothing on the host.
``adamw_update`` returns new trees, as the reference does; with
``donate=True`` it writes them into the given params and state instead
(the reference's ``jit(..., donate_argnums=(0, 1))``), so a step holds one
copy of the params and moments.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.pytree import tree_flatten, tree_map, tree_unflatten

__all__ = ["OptConfig", "adamw_update", "global_norm", "init_opt_state", "opt_state_specs",
           "schedule"]

F32 = torch.float32


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def _f32(x: float, like: "torch.Tensor") -> "torch.Tensor":
    """A 0-dim f32 constant made on ``like``'s device (a fill, no copy)."""
    return torch.full((), x, dtype=F32, device=like.device)


def schedule(cfg: OptConfig, step: "torch.Tensor") -> "torch.Tensor":
    """Learning rate at ``step`` (an integer tensor), as a 0-dim f32 tensor."""
    step = step.to(F32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                    0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def init_opt_state(params):
    """Zero f32 moments shaped like ``params`` and an int32 step counter,
    on the params' devices."""
    leaves = tree_flatten(params)[0]
    device = leaves[0].device if leaves else "cpu"
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=F32, device=p.device), params)
    return {"m": zeros, "v": tree_map(torch.clone, zeros),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def opt_state_specs(param_specs_tree):
    """Optimizer state logical specs mirror the param specs."""
    return {"m": param_specs_tree, "v": param_specs_tree, "step": ()}


def global_norm(tree) -> "torch.Tensor":
    leaves = tree_flatten(tree)[0]
    return torch.sqrt(sum(torch.sum(torch.square(g.to(F32))) for g in leaves))


def adamw_update(cfg: OptConfig, params, grads, state, *, donate: bool = False):
    """Returns (new_params, new_state, metrics), metrics {"gnorm", "lr"}
    (0-dim f32 tensors).  ``donate``: update ``params``, ``grads`` (by the
    clip scale) and ``state`` in place and return them."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    flat_p, tdef = tree_flatten(params)
    flat_g = tree_flatten(grads)[0]
    flat_m = tree_flatten(state["m"])[0]
    flat_v = tree_flatten(state["v"])[0]
    if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v):
        raise ValueError(f"adamw_update: {len(flat_p)} params, {len(flat_g)} grads, "
                         f"{len(flat_m)} / {len(flat_v)} moments")
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
        flat_g = [g.mul_(scale) if donate else g * scale for g in flat_g]

    lr = schedule(cfg, step)
    stepf = step.to(F32)
    b1c = 1 - torch.pow(_f32(cfg.b1, stepf), stepf)
    b2c = 1 - torch.pow(_f32(cfg.b2, stepf), stepf)

    out = []
    with torch.no_grad():
        for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
            gf = g.to(F32)
            m2 = cfg.b1 * m + (1 - cfg.b1) * gf
            v2 = cfg.b2 * v + (1 - cfg.b2) * gf * gf
            mh = m2 / b1c
            vh = v2 / b2c
            pf = p.to(F32)
            delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * pf
            p2 = (pf - lr * delta).to(p.dtype)
            if donate:
                p.copy_(p2)
                m.copy_(m2)
                v.copy_(v2)
                p2, m2, v2 = p, m, v
            out.append((p2, m2, v2))
    if donate:
        state["step"].copy_(step)
        new_state = state
    else:
        new_state = {"m": tree_unflatten(tdef, [o[1] for o in out]),
                     "v": tree_unflatten(tdef, [o[2] for o in out]), "step": step}
    new_params = params if donate else tree_unflatten(tdef, [o[0] for o in out])
    return new_params, new_state, {"gnorm": gnorm, "lr": lr}
