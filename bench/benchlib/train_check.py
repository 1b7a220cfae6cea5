"""``correct`` of a training cell: the first steps of the program's own
train step, followed by the plain reference from the same weights and
batches.

Compared, each by its worst case: every step's loss (relative gap), the
first gradient as the optimizer got it, a leaf's norm (the program's worked
out from AdamW's first moment after one step, m1 = (1 - b1) g), and the
change of each leaf over the checked steps, its norm.  A norm's gap is
taken against the reference's norm of that leaf or the median leaf's,
whichever is larger (some gradients are all but zero).  A leaf is a
weight, a stacked one a layer at a time.  Leaves whose reference gradient
lies under a thousandth of the median leaf's move under AdamW by rounding
alone, and are left out of the change.
"""
from __future__ import annotations

import math
import statistics

import torch


def leaf_items(tree, name: str = "", stacked: bool = False):
    """(name, tensor) of every leaf; the leaves under a dict ``layers``
    (stacked on a leading layer axis) split into their layers."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            sub = tree[k]
            out += leaf_items(sub, f"{name}.{k}" if name else k,
                              stacked or (k == "layers" and isinstance(sub, dict)))
        return out
    if isinstance(tree, list):
        out = []
        for i, v in enumerate(tree):
            out += leaf_items(v, f"{name}.{i}", False)
        return out
    if stacked:
        return [(f"{name}[{i}]", tree[i]) for i in range(tree.shape[0])]
    return [(name, tree)]


def norms(tree) -> "dict[str, float]":
    with torch.no_grad():
        return {n: float(torch.linalg.vector_norm(t.float())) for n, t in leaf_items(tree)}


def change_norms(new, old) -> "dict[str, float]":
    with torch.no_grad():
        o = dict(leaf_items(old))
        return {n: float(torch.linalg.vector_norm(t.float() - o[n].float()))
                for n, t in leaf_items(new)}


def schedule(opt: dict, step: int) -> float:
    """Linear warm-up to ``lr`` then a cosine down to ``min_lr_frac``."""
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    t = min(max((step - opt["warmup_steps"]) / max(opt["total_steps"] - opt["warmup_steps"], 1),
                0.0), 1.0)
    cos = opt["min_lr_frac"] + (1 - opt["min_lr_frac"]) * 0.5 * (1 + math.cos(math.pi * t))
    return opt["lr"] * warm * cos


def reference_steps(ref, a, seed, batches, opt, device, precision: str = "f32",
                    rows_at_once: int = 1) -> dict:
    """The reference's training: ``len(batches)`` steps of mean
    cross-entropy (rows ``rows_at_once`` at a time, gradients summed), the
    global norm clipped to ``clip_norm``, AdamW with decoupled decay, from
    the weights ``seed`` makes.  Returns the losses, the first clipped
    gradient's leaf norms and each leaf's change over the steps."""
    params = ref.make_params(a, seed, device)
    base = list(_leaves(params))
    for t in base:
        t.requires_grad_(True)
    start = [t.detach().clone() for t in base]
    m = [torch.zeros_like(t) for t in base]
    v = [torch.zeros_like(t) for t in base]
    losses, first = [], None
    for k, batch in enumerate(batches, start=1):
        tokens, labels = batch["tokens"], batch["labels"]
        B = tokens.shape[0]
        total = 0.0
        for r in range(0, B, rows_at_once):
            loss = ref.loss(a, params, tokens[r:r + rows_at_once], labels[r:r + rows_at_once],
                            precision)
            (loss * (tokens[r:r + rows_at_once].shape[0] / B)).backward()
            total += float(loss.detach()) * tokens[r:r + rows_at_once].shape[0] / B
        losses.append(total)
        with torch.no_grad():
            grads = [t.grad for t in base]
            gnorm = math.sqrt(sum(float(torch.sum(g.float() ** 2)) for g in grads))
            scale = min(opt["clip_norm"] / (gnorm + 1e-9), 1.0) if opt.get("clip_norm") else 1.0
            for g in grads:
                g.mul_(scale)
            if first is None:
                first = norms(_rebuild(params, grads))
            lr = schedule(opt, k)
            b1c, b2c = 1 - opt["b1"] ** k, 1 - opt["b2"] ** k
            for p, g, mi, vi in zip(base, grads, m, v):
                mi.mul_(opt["b1"]).add_(g, alpha=1 - opt["b1"])
                vi.mul_(opt["b2"]).addcmul_(g, g, value=1 - opt["b2"])
                delta = (mi / b1c) / (torch.sqrt(vi / b2c) + opt["eps"]) + opt["weight_decay"] * p
                p.sub_(lr * delta)
                p.grad = None
    with torch.no_grad():
        change = change_norms(_rebuild(params, [t.detach() for t in base]),
                              _rebuild(params, start))
    return {"losses": losses, "grad_norms": first, "change_norms": change}


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _rebuild(tree, leaves):
    it = iter(leaves)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return next(it)

    return walk(tree)


def gaps(prog: dict, ref: dict) -> dict:
    """The three numbers compared, each by its worst case."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))
    rg = ref["grad_norms"]
    med_g = statistics.median(rg.values())
    grad = max(abs(prog["grad_norms"][n] - rg[n]) / max(rg[n], med_g) for n in rg)
    keep = [n for n in rg if rg[n] >= 1e-3 * med_g]
    rc = ref["change_norms"]
    med_c = statistics.median(rc[n] for n in keep)
    change = max(abs(prog["change_norms"][n] - rc[n]) / max(rc[n], med_c) for n in keep)
    return {"loss_rel_gap": loss, "grad_norm_gap": grad, "change_norm_gap": change,
            "left_out": len(rg) - len(keep)}
