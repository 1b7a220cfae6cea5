"""Mixture-of-Experts layer (phi3.5-moe, qwen2-moe): ``src/repro/models/
moe.py`` on PyTorch.

One capacity-based dispatch serves both configs: top-k routing ->
position-in-expert via a one-hot cumsum -> scatter into a (G, E*C, D)
buffer (capacity C, GShard-style dropping) -> batched expert products ->
gather + weighted combine, plus qwen2-moe's sigmoid-gated shared expert.
The reference tags shardings with ``constrain``; the port runs on one
device and has none.

Nothing here reads a value on the host or takes a shape from the data
(no boolean-mask indexing, ``nonzero`` or ``.item()``): the scatter adds
every slot, dropped requests into slot 0 with a zero contribution, so a
paged decode step through ``moe_block`` records into a CUDA graph.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L

F32 = torch.float32
CAPACITY_FACTOR = 1.25


def layout(cfg, lead=()):
    """The MoE block's (shape, fill) leaves, with leading dims ``lead``:
    ``router`` (d, E) at 0.02 (f32 whatever the params' dtype, as the
    reference draws it), the experts' ``wi_gate``/``wi_up`` (E, d, f) and
    ``wo`` (E, f, d), and with shared experts ``shared`` (its width
    ``num_shared_experts * f``, and a (d, 1) ``gate`` at 0.02)."""
    e = cfg.moe
    d, f, E = cfg.d_model, e.d_ff_expert, e.num_experts
    p = {"router": ((*lead, d, E), 0.02, F32),
         "wi_gate": ((*lead, E, d, f), None), "wi_up": ((*lead, E, d, f), None),
         "wo": ((*lead, E, f, d), None)}
    if e.num_shared_experts:
        fs = e.num_shared_experts * f
        p["shared"] = {"wi_gate": ((*lead, d, fs), None), "wi_up": ((*lead, d, fs), None),
                       "wo": ((*lead, fs, d), None), "gate": ((*lead, d, 1), 0.02)}
    return p


def specs(cfg):
    """The MoE block's logical sharding names."""
    s = {"router": ("p_embed", "p_experts"),
         "wi_gate": ("p_experts", "p_embed", "p_expert_mlp"),
         "wi_up": ("p_experts", "p_embed", "p_expert_mlp"),
         "wo": ("p_experts", "p_expert_mlp", "p_embed")}
    if cfg.moe.num_shared_experts:
        s["shared"] = {"wi_gate": ("p_embed", "p_mlp"), "wi_up": ("p_embed", "p_mlp"),
                       "wo": ("p_mlp", "p_embed"), "gate": ("p_embed", "p_none")}
    return s


def route(x2d, wr, top_k: int, renormalize: bool):
    """x2d: (T, D) -> (weights (T, k) f32, idx (T, k) int64, aux_loss).

    Router logits and softmax in f32.  The top k come from a stable
    descending sort, so equal probabilities rank the lower expert first,
    as ``jax.lax.top_k`` does (``torch.topk`` promises no order on ties)."""
    logits = torch.matmul(x2d.to(F32), wr.to(F32))
    probs = torch.softmax(logits, dim=-1)
    weights, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, idx = weights[:, :top_k], idx[:, :top_k]
    if renormalize:
        weights = weights / (torch.sum(weights, dim=-1, keepdim=True) + 1e-9)
    # Switch-style load-balancing aux loss: E * sum_e(frac_tokens_e * mean_prob_e)
    E = wr.shape[-1]
    me = torch.mean(probs, dim=0)
    ce = torch.mean(_one_hot(idx[:, 0], E, F32), dim=0)
    aux = E * torch.sum(me * ce)
    return weights, idx, aux


def _one_hot(idx, n: int, dtype):
    """``jax.nn.one_hot``: a comparison with ``arange(n)``, no check of the
    indices on the host."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def moe_block(cfg, p, x, *, groups=None):
    """x: (B, S, D) -> (y, aux_loss). Capacity-based top-k MoE.

    Under a mesh every split or merge of a dim goes through
    ``layers.split_heads``/``merge_heads``, which gather what ``DTensor``
    cannot view.

    Grouped dispatch (``cfg.moe.dispatch_groups`` = G): routing is global,
    but the scatter/gather stays within token groups, each with its own
    capacity buckets.  G=1 is the single global dispatch buffer.
    ``groups`` overrides ``dispatch_groups``: the paged serving paths pass
    ``groups=B`` so capacity buckets never span rows, and a request's
    drops depend only on its own tokens.
    """
    e = cfg.moe
    B, S, D = x.shape
    T = B * S
    k, E = e.top_k, e.num_experts
    G = max(1, min(e.dispatch_groups if groups is None else groups, T))
    while T % G:
        G -= 1
    Tg = T // G
    x2d = L.merge_heads(x, 0)  # (T, D)

    weights, idx, aux = route(x2d, p["router"], k, e.renormalize)

    # ---- dispatch plan: position of each (token, choice) inside its
    # (group, expert) capacity bucket
    ef = idx.reshape(G, Tg * k)  # expert id per slot-request
    # the one-hot expert-major, (G, E, Tg*k), so that its cumsum runs along
    # the innermost dim
    onehot = (ef[:, None, :] == torch.arange(E, device=ef.device)[:, None]).to(torch.int32)
    pos_all = torch.cumsum(onehot, dim=2, dtype=torch.int32) - onehot
    pos = torch.sum(pos_all * onehot, dim=1)  # (G, Tg*k)
    cap = max(int(CAPACITY_FACTOR * k * Tg / E), k)
    keep = pos < cap
    slot = torch.where(keep, ef * cap + pos, torch.zeros_like(pos))  # dropped -> slot 0, zeroed

    # ---- scatter tokens into the (G, E*C, D) dispatch buffer (per group):
    # every slot-request is added, the dropped ones as zeros
    xrep = L.merge_heads(L.split_heads(x2d, G, Tg, dim=0)[:, :, None].expand(G, Tg, k, D), 1)
    contrib = xrep.masked_fill(~keep[..., None], 0)
    flat = (slot + (torch.arange(G, device=x.device) * (E * cap))[:, None]).reshape(-1)
    buf = torch.zeros((G * E * cap, D), dtype=x.dtype, device=x.device)
    # out of place: under a mesh DTensor re-specs an in-place index_add_'s
    # destination as sharded without moving its data
    buf = buf.index_add(0, flat, L.merge_heads(contrib, 0))
    xe = L.split_heads(L.split_heads(buf, G, E * cap, dim=0), E, cap, dim=1)

    # ---- expert products (batched over group x expert)
    g = torch.einsum("gecd,edf->gecf", xe, p["wi_gate"])
    u = torch.einsum("gecd,edf->gecf", xe, p["wi_up"])
    h = F.silu(g) * u
    ye = torch.einsum("gecf,efd->gecd", h, p["wo"])

    # ---- gather back + weighted combine over the k choices
    ye = L.merge_heads(L.merge_heads(ye, 1), 0)  # (G * E * cap, D)
    y_tk = L.split_heads(ye.index_select(0, flat), G, Tg * k, dim=0)
    y_tk = y_tk.masked_fill(~keep[..., None], 0)
    w_tk = L.merge_heads(L.split_heads(weights, G, Tg, dim=0), 1)[..., None].to(x.dtype)
    y = L.merge_heads(torch.sum(L.split_heads(y_tk * w_tk, Tg, k, dim=1), dim=2), 0)

    # ---- always-on shared expert (qwen2-moe), sigmoid-gated
    if e.num_shared_experts:
        sp = p["shared"]
        sh = F.silu(torch.matmul(x2d, sp["wi_gate"])) * torch.matmul(x2d, sp["wi_up"])
        sy = torch.matmul(sh, sp["wo"])
        gate = torch.sigmoid(torch.matmul(x2d.to(F32), sp["gate"].to(F32)))
        y = y + sy * gate.to(x.dtype)

    return L.split_heads(y, B, S, dim=0), aux


__all__ = ["CAPACITY_FACTOR", "layout", "moe_block", "route", "specs"]
