"""Mamba-2 language model (attention-free) on PyTorch: embed -> layers of
(norm + SSD mixer) -> lm head (``src/repro/models/ssm_lm.py``).

Params keep the JAX tree's names and shapes, layer params stacked with a
leading L axis; ``forward``/``decode_step`` walk the layers in a Python
loop where the reference scans.  The paged serving contract
(``paged_spec``/``paged_prefill``/``paged_decode_step``) is the
reference's, and so is ``loss_fn`` (mean next-token cross-entropy in f32).
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.layers import tree_map


def param_shapes(cfg):
    """The params' names and shapes, as the JAX ``init`` makes them."""
    n = cfg.num_layers
    shape = lambda leaf: leaf[0]  # noqa: E731
    return {
        "embed": tree_map(shape, L.embed_layout(cfg)),
        "layers": {"ln": tree_map(shape, L.norm_layout(cfg, (n,))),
                   "ssm": {k: (n, *v) for k, v in S.ssm_param_shapes(cfg).items()}},
        "final_norm": tree_map(shape, L.norm_layout(cfg)),
    }


def param_specs(cfg):
    """Logical sharding names for every param; layer params gain a 'layers' dim."""
    return {"embed": L.embed_specs(cfg),
            "layers": L.stack_specs({"ln": L.norm_specs(cfg), "ssm": S.ssm_specs(cfg)}),
            "final_norm": L.norm_specs(cfg)}


def init(cfg, *, generator: "torch.Generator", device, dtype=torch.float32):
    """The reference's distributions (``ssm.init_ssm`` per layer, stacked;
    embeddings at 0.02; norm scales 1), drawn from ``generator`` (on
    ``device``) in a fixed order."""
    def leaves(layout):
        return tree_map(lambda leaf: L.init_leaf(leaf, generator=generator, device=device,
                                                 dtype=dtype), layout)

    layers = [S.init_ssm(cfg, generator=generator, device=device, dtype=dtype)
              for _ in range(cfg.num_layers)]
    return {
        "embed": leaves(L.embed_layout(cfg)),
        "layers": {"ln": leaves(L.norm_layout(cfg, (cfg.num_layers,))),
                   "ssm": {k: torch.stack([lp[k] for lp in layers]) for k in layers[0]}},
        "final_norm": leaves(L.norm_layout(cfg)),
    }


def forward(cfg, params, batch, *, remat: str = "none", q_block=None, return_kv: bool = False,
            last_only: bool = False, impl: str = "auto"):
    """Teacher-forcing forward. batch["tokens"]: (B, S) int.

    Returns (logits, aux_loss) or, with ``return_kv``, (logits, aux_loss,
    cache), where ``cache`` is the real decode cache the prompt leaves
    behind, {'state': (L, B, H, N, P) f32, 'conv': (L, B, d_conv - 1, C)},
    computed per layer as ``ssm_prefill`` computes it and laid out as
    ``decode_step`` consumes it.  This differs on purpose from the
    reference's ``forward``, which returns an all-zero ``init_cache`` there
    (its greedy oracle uses ``paged_prefill`` instead).  ``remat`` (none,
    full, dots) applies to each layer (``layers.remat_call``); ``q_block``
    is unused (no attention).  ``impl="ref"`` keeps every scan on
    ``ssd_chunked``; ``aux_loss`` is 0."""
    x = L.embed(cfg, params["embed"], batch["tokens"])
    states, convs = [], []

    def layer(x, lp):
        h = L.apply_norm(cfg, x, lp["ln"])
        if return_kv:
            y, cache = S.ssm_prefill(cfg, lp["ssm"], h, impl=impl)
            return x + y, cache
        return x + S.ssm_block(cfg, lp["ssm"], h, impl=impl), None

    for lp in L.unstack(params["layers"], cfg.num_layers):
        x, cache = L.remat_call(remat, layer, x, lp)
        if return_kv:
            states.append(cache["state"])
            convs.append(cache["conv"])
    x = L.apply_norm(cfg, x, params["final_norm"])
    if last_only:  # prefill: only the final position feeds sampling
        x = x[:, -1:]
    logits = L.unembed(cfg, params["embed"], x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if return_kv:
        return logits, aux, {"state": torch.stack(states), "conv": torch.stack(convs)}
    return logits, aux


def loss_fn(cfg, params, batch, **kw):
    """Mean next-token cross-entropy (f32); ``kw`` goes to ``forward``."""
    logits, _ = forward(cfg, params, batch, **kw)
    return L.xent_loss(logits, batch["labels"], batch.get("loss_mask"))


def init_cache(cfg, batch: int, max_seq: int, *, device, dtype=torch.bfloat16):
    """SSM decode cache: per-layer recurrent state (f32) + conv window
    (``dtype``), zeroed on ``device``; no KV, so ``max_seq`` sizes nothing."""
    one = S.init_ssm_cache(cfg, batch, device=device, dtype=dtype)
    return {k: t.expand(cfg.num_layers, *t.shape).clone() for k, t in one.items()}


def decode_step(cfg, params, cache, tokens, pos: int):
    """tokens: (B, 1) int; ``pos`` is unused (the recurrence carries no
    positions).  Returns (logits (B, 1, V), cache); the cache is updated
    in place."""
    x = L.embed(cfg, params["embed"], tokens)
    for i, lp in enumerate(L.unstack(params["layers"], cfg.num_layers)):
        h = L.apply_norm(cfg, x, lp["ln"])
        y, new = S.ssm_decode_step(cfg, lp["ssm"], h,
                                   {"state": cache["state"][i], "conv": cache["conv"][i]})
        cache["state"][i] = new["state"]
        cache["conv"][i] = new["conv"]
        x = x + y
    x = L.apply_norm(cfg, x, params["final_norm"])
    return L.unembed(cfg, params["embed"], x), cache


# ---------------------------------------------------------------------------
# paged serving contract
# ---------------------------------------------------------------------------

def paged_spec(cfg):
    """Attention-free: a minimal 1x1 KV geometry keeps the engine's page
    machinery uniform while the real memory, the recurrent state, rides as
    per-sequence resident state whose bytes the sequence's AGAS record
    carries."""
    from repro_torch.serving.paged import PageSpec

    return PageSpec(layers=1, page_size=0, kv_heads=1, head_dim=1, dtype=torch.float32)


def paged_prefill(cfg, params, tokens, extras=None, *, impl: str = "auto"):
    """tokens: (B, T) -> (k, v, state, last_logits).

    k/v are zero dummies (nothing attends over them); ``state`` is the
    batch-leading {'state': (B, L, H, N, P), 'conv': (B, L, d_conv - 1, C)}
    cache the prompt leaves (the prefill's real cache), which the decode
    step threads."""
    logits, _, cache = forward(cfg, params, {"tokens": tokens}, return_kv=True, last_only=True,
                               impl=impl)
    B, T = tokens.shape
    k = torch.zeros((B, 1, T, 1, 1), dtype=torch.float32, device=tokens.device)
    state = {n: cache[n].movedim(0, 1) for n in ("state", "conv")}
    return k, k, state, logits[:, -1]


def paged_decode_step(cfg, params, k_pages, v_pages, state, tokens, positions, tables, lengths,
                      *, impl: str = "auto"):
    """Pages pass through untouched; the recurrent state (stacked rows,
    batch-leading) advances one token, in place.  Position-free math, so
    ragged rows batch freely; ``impl`` is unused (decode is plain)."""
    cache = {n: state[n].movedim(0, 1) for n in ("state", "conv")}
    logits, cache = decode_step(cfg, params, cache, tokens.reshape(-1, 1), 0)
    state = {n: cache[n].movedim(0, 1) for n in ("state", "conv")}
    return k_pages, v_pages, state, logits[:, 0]
