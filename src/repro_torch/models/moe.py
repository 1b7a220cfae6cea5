"""Mixture-of-Experts layer (phi3.5-moe, qwen2-moe): ``src/repro/models/
moe.py`` on PyTorch.

One capacity-based dispatch serves both configs: top-k routing ->
position-in-expert via a one-hot cumsum -> scatter into a (G, E*C, D)
buffer (capacity C, GShard-style dropping) -> batched expert products ->
gather + weighted combine, plus qwen2-moe's sigmoid-gated shared expert.
The reference tags shardings with ``constrain``, and the port tags the
same ones.  Under a mesh the dispatch, the expert products and the
combine run on each rank's own shards (``on_local_shards``): its token
groups (``exp_groups``) and its experts (``experts``), or its slice of
every expert's d_ff (``expert_mlp``, TP-MoE).  So the dispatch buffer is
born sharded: a rank scatters only the slot-requests of its own experts
into a buffer of its own groups and experts.

Nothing here reads a value on the host or takes a shape from the data
(no boolean-mask indexing, ``nonzero`` or ``.item()``): the scatter adds
every slot, dropped requests into slot 0 with a zero contribution, so a
paged decode step through ``moe_block`` records into a CUDA graph.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.distribution.sharding import constrain, on_local_shards, place_like
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
    logits = L.linear(x2d.to(F32), wr.to(F32))
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


# the axes each step of the dispatch treats independently: token groups,
# experts, and (TP-MoE) the experts' d_ff, which the down product sums; a
# buffer every data rank holds whole (one group) meets weights sharded
# over d_model (FSDP) in products over each rank's slice of d_model,
# summed, rather than in products of gathered weights
_PLAN_DIMS = {"exp_groups": ((0,), (0, 0))}
_DISPATCH_DIMS = {"exp_groups": ((0, 0, 0, None), (0,)), "experts": ((None, None, None, 0), (1,))}
_GATE_UP_DIMS = {"exp_groups": ((0, None, None), (0, 0)), "experts": ((1, 0, 0), (1, 1)),
                 "expert_mlp": ((None, 2, 2), (3, 3)), "embed": ((3, 1, 1), ("sum", "sum"))}
_DOWN_DIMS = {"exp_groups": ((0, None), (0,)), "experts": ((1, 0), (1,)),
              "expert_mlp": ((3, 1), ("sum",)), "embed": ((None, 2), (3,))}
_COMBINE_DIMS = {"exp_groups": ((0, 0, 0, 0, None), (0,)),
                 "experts": ((1, None, None, None, 0), ("sum",))}
# one group: its tokens too are independent in the combine (each reads its
# own slots of the whole buffer), so a rank combines only its own rows
_COMBINE_ONE_GROUP_DIMS = {**_COMBINE_DIMS, "tokens": ((None, 1, 1, 1, None), (0,))}


def _dispatch_plan(idx, *, E: int, cap: int):
    """idx (G, Tg, k) expert ids -> (slot, keep), each (G, Tg*k): the
    position of each (token, choice) in its (group, expert) capacity
    bucket, as a slot of the group's (E*cap) buffer, and whether it fits
    (a dropped request gets slot 0)."""
    G = idx.shape[0]
    ef = idx.reshape(G, -1)  # expert id per slot-request
    # the one-hot expert-major, (G, E, Tg*k), so that its cumsum runs along
    # the innermost dim
    onehot = (ef[:, None, :] == torch.arange(E, device=ef.device)[:, None]).to(torch.int32)
    pos_all = torch.cumsum(onehot, dim=2, dtype=torch.int32) - onehot
    pos = torch.sum(pos_all * onehot, dim=1)  # (G, Tg*k)
    keep = pos < cap
    return torch.where(keep, ef * cap + pos, torch.zeros_like(pos)), keep


def _own_slots(slot, keep, experts, cap: int, G: int):
    """The slot-requests of the experts ``experts`` (a contiguous range)
    holds: (whether each is one of them, its row in a (G * e * cap) buffer
    of those experts)."""
    e = experts.shape[0]
    lo = experts[0] * cap
    own = keep & (slot >= lo) & (slot < lo + e * cap)
    local = torch.where(own, slot - lo, torch.zeros_like(slot))
    return own, (local + (torch.arange(G, device=slot.device) * (e * cap))[:, None]).reshape(-1)


def _dispatch(xg, slot, keep, experts, *, cap: int):
    """Scatter xg (G, Tg, D)'s tokens into the (G, e, cap, D) buffer of the
    experts ``experts``: every slot-request is added, the dropped and the
    other experts' ones as zeros."""
    G, Tg, D = xg.shape
    k = slot.shape[1] // Tg
    own, flat = _own_slots(slot, keep, experts, cap, G)
    xrep = xg[:, :, None].expand(G, Tg, k, D).reshape(G, Tg * k, D)
    contrib = xrep.masked_fill(~own[..., None], 0)
    buf = torch.zeros((G * experts.shape[0] * cap, D), dtype=xg.dtype, device=xg.device)
    # out of place: under a mesh DTensor re-specs an in-place index_add_'s
    # destination as sharded without moving its data
    return buf.index_add(0, flat, contrib.reshape(-1, D)).view(G, experts.shape[0], cap, D)


def _gate_up(xe, wi_gate, wi_up):
    return (torch.einsum("gecd,edf->gecf", xe, wi_gate),
            torch.einsum("gecd,edf->gecf", xe, wi_up))


def _down(h, wo):
    return torch.einsum("gecf,efd->gecd", h, wo)


def _combine(ye, slot, keep, weights, experts, *, cap: int):
    """Gather each slot-request's output back from ye (G, e, cap, D) and
    sum the k choices weighted -> (G * Tg, D): the part of the experts
    ``experts``."""
    G, e, _, D = ye.shape
    Tg, k = weights.shape[1], weights.shape[2]
    own, flat = _own_slots(slot, keep, experts, cap, G)
    y_tk = ye.reshape(G * e * cap, D).index_select(0, flat).view(G, Tg * k, D)
    y_tk = y_tk.masked_fill(~own[..., None], 0)
    w_tk = weights.reshape(G, Tg * k, 1).to(ye.dtype)
    return torch.sum((y_tk * w_tk).view(G, Tg, k, D), dim=2).view(G * Tg, D)


def moe_block(cfg, p, x, *, groups=None):
    """x: (B, S, D) -> (y, aux_loss). Capacity-based top-k MoE.

    Under a mesh every split or merge of a dim goes through
    ``layers.split_heads``/``merge_heads``, which gather what ``DTensor``
    cannot view.

    Grouped dispatch (``cfg.moe.dispatch_groups`` = G): routing is global,
    but the scatter/gather stays within token groups, each with its own
    capacity buckets, whose dim shards over the data axis.  G=1 is the
    single global dispatch buffer, which every data rank holds whole, as
    the reference's does.  ``groups`` overrides ``dispatch_groups``: the
    paged serving paths pass ``groups=B`` so capacity buckets never span
    rows, and a request's drops depend only on its own tokens.
    """
    e = cfg.moe
    B, S, D = x.shape
    T = B * S
    k, E = e.top_k, e.num_experts
    G = max(1, min(e.dispatch_groups if groups is None else groups, T))
    while T % G:
        G -= 1
    Tg = T // G
    cap = max(int(CAPACITY_FACTOR * k * Tg / E), k)
    x2d = L.merge_heads(x, 0)  # (T, D)

    weights, idx, aux = route(x2d, p["router"], k, e.renormalize)

    # ---- dispatch plan: position of each (token, choice) inside its
    # (group, expert) capacity bucket
    idx = constrain(L.split_heads(idx, G, Tg, dim=0), "exp_groups", None, None)
    slot, keep = on_local_shards(functools.partial(_dispatch_plan, E=E, cap=cap), (idx,),
                                 _PLAN_DIMS)

    # ---- scatter tokens into the (G, E, C, D) dispatch buffer (per group)
    xg = constrain(L.split_heads(x2d, G, Tg, dim=0), "exp_groups", None, "embed")
    experts = place_like(torch.arange(E, device=x.device), x2d, "experts")
    xe = on_local_shards(functools.partial(_dispatch, cap=cap), (xg, slot, keep, experts),
                         _DISPATCH_DIMS)
    xe = constrain(xe, "exp_groups", "experts", None, "embed")

    # ---- expert products (batched over group x expert)
    g, u = on_local_shards(_gate_up, (xe, p["wi_gate"], p["wi_up"]), _GATE_UP_DIMS)
    g = constrain(g, "exp_groups", "experts", None, "expert_mlp")
    u = constrain(u, "exp_groups", "experts", None, "expert_mlp")
    h = F.silu(g) * u
    # row-parallel under TP-MoE: partial sums over d_ff -> all-reduce
    ye = constrain(on_local_shards(_down, (h, p["wo"]), _DOWN_DIMS),
                   "exp_groups", "experts", None, "embed")

    # ---- gather back + weighted combine over the k choices, of the rank's
    # own tokens (EP: its experts' part, summed over the expert ranks)
    wg = L.split_heads(weights, G, Tg, dim=0)
    y = on_local_shards(functools.partial(_combine, cap=cap), (ye, slot, keep, wg, experts),
                        _COMBINE_DIMS if G > 1 else _COMBINE_ONE_GROUP_DIMS)
    y = constrain(y, "batch", "embed")  # (T, D)

    # ---- always-on shared expert (qwen2-moe), sigmoid-gated
    if e.num_shared_experts:
        sp = p["shared"]
        sh = F.silu(L.linear(x2d, sp["wi_gate"])) * L.linear(x2d, sp["wi_up"])
        sy = L.linear(sh, sp["wo"])
        gate = torch.sigmoid(L.linear(x2d.to(F32), sp["gate"].to(F32)))
        y = y + sy * gate.to(x.dtype)

    return constrain(L.split_heads(y, B, S, dim=0), "batch", "seq", "embed"), aux


__all__ = ["CAPACITY_FACTOR", "layout", "moe_block", "route", "specs"]
