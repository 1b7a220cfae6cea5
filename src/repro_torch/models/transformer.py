"""Decoder-only transformer LM: the dense, moe and vlm families
(``src/repro/models/transformer.py`` on PyTorch).

Params keep the JAX tree's names and shapes: layer params are stacked
with a leading L axis, and ``forward``/``decode_step``/``paged_decode_step``
walk the layers in a Python loop where the reference scans.  A layer of a
moe config holds ``moe`` (``models/moe.py``) in place of ``mlp``.  The
paged serving contract (``paged_spec``/``paged_prefill``/
``paged_decode_step``) is the reference's; its decode attends through the
paged-attention kernel on a CUDA tensor.

VLM (qwen2-vl): the vision frontend is a STUB, as in the reference:
precomputed patch embeddings (B, P, D) are written over positions [1, P+1)
of the token embedding, and M-RoPE takes the stub's (3, B, S) t/h/w
position ids.

A sliding window (``cfg.sliding_window``) applies, as in the
reference, only to a prefill longer than the window, through the plain
``layers.local_block_attention``; it does not pad, so such a prefill must
be a whole number of windows.  Decode attends over the whole cache, as the
reference's does.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models.layers import tree_map


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def _layout(cfg):
    """Nested dict of (shape, fill) leaves, as ``layers.init_leaf`` takes them."""
    n = cfg.num_layers
    layer = {"ln1": L.norm_layout(cfg, (n,)), "attn": L.attn_layout(cfg, (n,)),
             "ln2": L.norm_layout(cfg, (n,))}
    if cfg.moe is not None:
        layer["moe"] = M.layout(cfg, (n,))
    else:
        layer["mlp"] = L.mlp_layout(cfg, (n,))
    return {"embed": L.embed_layout(cfg), "layers": layer, "final_norm": L.norm_layout(cfg)}


def param_shapes(cfg):
    """The params' names and shapes, as the JAX ``init`` makes them."""
    return tree_map(lambda leaf: leaf[0], _layout(cfg))


def init(cfg, *, generator: "torch.Generator", device, dtype=torch.float32):
    """Truncated-normal ([-2, 2]) weights scaled by 1/sqrt(fan-in), like
    the reference's ``ninit``; embeddings at 0.02; norm scales 1, biases 0.
    Drawn from ``generator`` (on ``device``) leaf by leaf in a fixed order."""
    return tree_map(lambda leaf: L.init_leaf(leaf, generator=generator, device=device,
                                             dtype=dtype), _layout(cfg))


def _layer(params, i: int):
    return tree_map(lambda t: t[i], params["layers"])


# ---------------------------------------------------------------------------
# embedding (+ VLM patch merge)
# ---------------------------------------------------------------------------

def _embed_inputs(cfg, params, batch):
    x = L.embed(cfg, params["embed"], batch["tokens"])
    if cfg.vision_stub and "patch_embeds" in batch:
        pe = batch["patch_embeds"].to(x.dtype)  # (B, P, D) from the stub
        P, S = pe.shape[1], x.shape[1]
        start = max(0, min(1, S - P))  # positions [1, P+1), clamped as dynamic_update_slice
        x[:, start:start + P] = pe
    return x


def _positions(cfg, batch, S):
    tokens = batch["tokens"]
    B = tokens.shape[0]
    if cfg.rope_type == "mrope":
        pos = batch.get("positions")
        if pos is None:  # text-only fallback: all three streams equal
            pos = torch.arange(S, device=tokens.device)[None, None].expand(3, B, S)
        return pos
    return torch.arange(S, device=tokens.device)[None].expand(B, S)


def _rope(cfg, positions):
    if cfg.rope_type in ("rope", "mrope"):
        rot = int(cfg.hd * cfg.partial_rotary)
        return L.rope_angles(positions, rot, cfg.rope_theta, cfg.mrope_sections)
    return None, None


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------

def _attn_mlp_layer(cfg, lp, x, cos, sin, *, q_block, impl, moe_groups=None):
    h = L.apply_norm(cfg, x, lp["ln1"])
    q, k, v = L.qkv_proj(cfg, lp["attn"], h)
    if cos is not None:
        q = L.apply_rope(q, cos, sin)
        k = L.apply_rope(k, cos, sin)
    if cfg.sliding_window is not None and x.shape[1] > cfg.sliding_window:
        o = L.local_block_attention(q, k, v, window=cfg.sliding_window)
    else:
        o = L.attention(q, k, v, causal=True, q_block=q_block, softcap=cfg.attn_logit_softcap,
                        impl=impl)
    x = x + L.out_proj(cfg, lp["attn"], o)
    h = L.apply_norm(cfg, x, lp["ln2"])
    if cfg.moe is not None:
        y, aux = M.moe_block(cfg, lp["moe"], h, groups=moe_groups)
        return x + y, aux, (k, v)
    return x + L.mlp(cfg, lp["mlp"], h), None, (k, v)


def forward(cfg, params, batch, *, q_block: "Optional[int]" = 512, return_kv: bool = False,
            last_only: bool = False, impl: str = "auto", moe_groups: "Optional[int]" = None):
    """Teacher-forcing forward. batch["tokens"]: (B, S) int; a vlm batch
    may add "patch_embeds" (B, P, D) and "positions" (3, B, S).

    Returns (logits, aux_loss) or (logits, aux_loss, kv_cache) with
    ``return_kv`` (prefill: kv_cache is {'k','v'}: (L, B, S, K, hd)).
    ``aux_loss`` is the layers' router losses summed in f32 (0 without
    MoE).  ``impl`` goes to ``layers.attention``: ``ref`` keeps attention on
    the plain path.  ``moe_groups`` goes to ``moe_block`` as ``groups``."""
    x = _embed_inputs(cfg, params, batch)
    S = x.shape[1]
    cos, sin = _rope(cfg, _positions(cfg, batch, S))
    kv, auxs = None, []
    for i in range(cfg.num_layers):
        x, aux, (k, v) = _attn_mlp_layer(cfg, _layer(params, i), x, cos, sin, q_block=q_block,
                                         impl=impl, moe_groups=moe_groups)
        if aux is not None:
            auxs.append(aux)
        if return_kv:  # written layer by layer into the stacked cache: no second copy
            if kv is None:
                kv = {n: t.new_empty((cfg.num_layers, *t.shape)) for n, t in (("k", k), ("v", v))}
            kv["k"][i], kv["v"][i] = k, v
    x = L.apply_norm(cfg, x, params["final_norm"])
    if last_only:  # prefill: only the final position feeds sampling
        x = x[:, -1:]
    logits = L.unembed(cfg, params["embed"], x)
    aux = (torch.sum(torch.stack(auxs)) if auxs
           else torch.zeros((), dtype=torch.float32, device=x.device))
    if return_kv:
        return logits, aux, kv
    return logits, aux


# ---------------------------------------------------------------------------
# decode (one token, stacked KV cache)
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_seq: int, *, device, dtype=torch.bfloat16):
    """Zeroed (L, batch, max_seq, K, hd) keys and values on ``device``,
    which the caller names, as for ``init``: the cache lives beside the
    params."""
    shape = (cfg.num_layers, batch, max_seq, cfg.num_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_step(cfg, params, cache, tokens, pos: int):
    """tokens: (B, 1) int; pos: the write position (text decode: M-RoPE's
    three streams all at ``pos``).

    Returns (logits (B, 1, V), cache); the cache is updated in place."""
    x = L.embed(cfg, params["embed"], tokens)
    B = x.shape[0]
    shape = (3, B, 1) if cfg.rope_type == "mrope" else (B, 1)
    cos, sin = _rope(cfg, torch.full(shape, pos, dtype=torch.int64, device=x.device))
    for i in range(cfg.num_layers):
        lp = _layer(params, i)
        h = L.apply_norm(cfg, x, lp["ln1"])
        q, k, v = L.qkv_proj(cfg, lp["attn"], h)
        if cos is not None:
            q = L.apply_rope(q, cos, sin)
            k = L.apply_rope(k, cos, sin)
        ck, cv = L.cache_update(cache["k"][i], cache["v"][i], k, v, pos)
        o = L.decode_attend(cfg, q, ck, cv, pos)
        x = x + L.out_proj(cfg, lp["attn"], o)
        h = L.apply_norm(cfg, x, lp["ln2"])
        x = x + (M.moe_block(cfg, lp["moe"], h)[0] if cfg.moe is not None
                 else L.mlp(cfg, lp["mlp"], h))
    x = L.apply_norm(cfg, x, params["final_norm"])
    return L.unembed(cfg, params["embed"], x), cache


# ---------------------------------------------------------------------------
# paged serving contract
# ---------------------------------------------------------------------------

def paged_spec(cfg):
    """Multi-layer KV folded into ONE page geometry: layer is the leading
    slab dim, so a sequence's pages for every layer share one table.  The
    slabs are f32, as the reference fixes them."""
    from repro_torch.serving.paged import PageSpec

    return PageSpec(layers=cfg.num_layers, page_size=0, kv_heads=cfg.num_kv_heads,
                    head_dim=cfg.hd, dtype=torch.float32)


def paged_prefill(cfg, params, tokens, extras=None, *, impl: str = "auto"):
    """tokens: (B, T) int -> (k, v, state, last_logits).

    k/v: (B, L, T, K, hd) views of ``forward(..., return_kv=True)``'s KV,
    ready for ``PagedKVCache.append``; state: None (attention only);
    last_logits: (B, V) f32 for the sampling stage.  ``moe_groups=B``:
    capacity buckets stay per row, so each request's prefill logits do not
    depend on which rows batched with it."""
    batch = {"tokens": tokens}
    if extras:
        batch.update(extras)
    logits, _, kv = forward(cfg, params, batch, return_kv=True, last_only=True, impl=impl,
                            moe_groups=tokens.shape[0])
    return kv["k"].movedim(0, 1), kv["v"].movedim(0, 1), None, logits[:, -1]


def paged_decode_step(cfg, params, k_pages, v_pages, state, tokens, positions, tables, lengths,
                      *, impl: str = "auto"):
    """One ragged decode step straight against the page pool.

    k_pages/v_pages: (L, N, P, K, hd) slabs, updated IN PLACE; tokens: (B,)
    last tokens; positions == lengths: (B,) int32, each row's write slot
    and its tokens already resident; tables: (B, M) int32.  Returns
    (k_pages, v_pages, state, logits (B, V)).  Per-row math is
    ``decode_step``'s: the new token is scattered at ``positions`` and each
    row attends over ``lengths + 1`` slots, through the paged-attention
    kernel on a CUDA tensor (``impl="ref"``: the gather path).  MoE
    dispatches per row (``groups=B``): a row's expert drops do not depend
    on which sequences share the step."""
    x = L.embed(cfg, params["embed"], tokens.reshape(-1, 1))
    B = x.shape[0]
    p = positions[:, None]
    cos, sin = _rope(cfg, p[None].expand(3, B, 1) if cfg.rope_type == "mrope" else p)
    for i in range(cfg.num_layers):
        lp = _layer(params, i)
        h = L.apply_norm(cfg, x, lp["ln1"])
        q, k, v = L.qkv_proj(cfg, lp["attn"], h)
        if cos is not None:
            q = L.apply_rope(q, cos, sin)
            k = L.apply_rope(k, cos, sin)
        kp, vp = L.page_scatter(k_pages[i], v_pages[i], k, v, tables, positions)
        o = L.paged_decode_attend(q, kp, vp, tables, lengths, impl=impl)
        x = x + L.out_proj(cfg, lp["attn"], o)
        h = L.apply_norm(cfg, x, lp["ln2"])
        x = x + (M.moe_block(cfg, lp["moe"], h, groups=B)[0] if cfg.moe is not None
                 else L.mlp(cfg, lp["mlp"], h))
    x = L.apply_norm(cfg, x, params["final_norm"])
    return k_pages, v_pages, state, L.unembed(cfg, params["embed"], x)[:, 0]
