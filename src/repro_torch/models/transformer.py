"""Decoder-only transformer LM, dense family (``src/repro/models/
transformer.py`` on PyTorch).

Params keep the JAX tree's names and shapes: layer params are stacked
with a leading L axis, and ``forward``/``decode_step``/``paged_decode_step``
walk the layers in a Python loop where the reference scans.  The paged
serving contract (``paged_spec``/``paged_prefill``/``paged_decode_step``)
is the reference's; its decode attends through the paged-attention kernel
on a CUDA tensor.  MoE blocks, sliding windows,
logit softcaps, the vision stub and M-RoPE are refused: they come with the
rest of the model zoo (ROADMAP.md Queue 1 item 7).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import layers as L
from repro_torch.models.layers import tree_map

_ZOO = "ROADMAP.md Queue 1 item 7"


def _refuse_unported(cfg) -> None:
    for what, on in (("MoE blocks", cfg.moe is not None),
                     ("sliding-window attention", cfg.sliding_window is not None),
                     ("attention logit softcap", cfg.attn_logit_softcap is not None),
                     ("the vision stub", cfg.vision_stub),
                     ("M-RoPE", cfg.rope_type == "mrope")):
        if on:
            raise NotImplementedError(f"{cfg.name}: {what} not ported yet ({_ZOO})")


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def _layout(cfg):
    """Nested dict of (shape, fill) leaves, as ``layers.init_leaf`` takes them."""
    d, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    f, n = cfg.d_ff, cfg.num_layers
    attn = {"wq": ((n, d, H * hd), None), "wk": ((n, d, K * hd), None),
            "wv": ((n, d, K * hd), None), "wo": ((n, H * hd, d), None)}
    if cfg.attn_qkv_bias:
        attn.update({"bq": ((n, H * hd), "zeros"), "bk": ((n, K * hd), "zeros"),
                     "bv": ((n, K * hd), "zeros")})
    if cfg.attn_out_bias:
        attn["bo"] = ((n, d), "zeros")
    if cfg.mlp_type in ("swiglu", "geglu"):
        mlp = {"wi_gate": ((n, d, f), None), "wi_up": ((n, d, f), None), "wo": ((n, f, d), None)}
        if cfg.mlp_bias:
            mlp.update({"bi_gate": ((n, f), "zeros"), "bi_up": ((n, f), "zeros"),
                        "bo": ((n, d), "zeros")})
    else:
        mlp = {"wi": ((n, d, f), None), "wo": ((n, f, d), None)}
        if cfg.mlp_bias:
            mlp.update({"bi": ((n, f), "zeros"), "bo": ((n, d), "zeros")})
    return {
        "embed": L.embed_layout(cfg),
        "layers": {"ln1": L.norm_layout(cfg, (n,)), "attn": attn, "ln2": L.norm_layout(cfg, (n,)),
                   "mlp": mlp},
        "final_norm": L.norm_layout(cfg),
    }


def param_shapes(cfg):
    """The params' names and shapes, as the JAX ``init`` makes them."""
    return tree_map(lambda leaf: leaf[0], _layout(cfg))


def init(cfg, *, generator: "torch.Generator", device, dtype=torch.float32):
    """Truncated-normal ([-2, 2]) weights scaled by 1/sqrt(fan-in), like
    the reference's ``ninit``; embeddings at 0.02; norm scales 1, biases 0.
    Drawn from ``generator`` (on ``device``) leaf by leaf in a fixed order."""
    _refuse_unported(cfg)
    return tree_map(lambda leaf: L.init_leaf(leaf, generator=generator, device=device,
                                             dtype=dtype), _layout(cfg))


def _layer(params, i: int):
    return tree_map(lambda t: t[i], params["layers"])


def _rope(cfg, positions):
    if cfg.rope_type == "rope":
        rot = int(cfg.hd * cfg.partial_rotary)
        return L.rope_angles(positions, rot, cfg.rope_theta)
    return None, None


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------

def _attn_mlp_layer(cfg, lp, x, cos, sin, *, q_block, impl):
    h = L.apply_norm(cfg, x, lp["ln1"])
    q, k, v = L.qkv_proj(cfg, lp["attn"], h)
    if cos is not None:
        q = L.apply_rope(q, cos, sin)
        k = L.apply_rope(k, cos, sin)
    o = L.attention(q, k, v, causal=True, q_block=q_block, impl=impl)
    x = x + L.out_proj(cfg, lp["attn"], o)
    h = L.apply_norm(cfg, x, lp["ln2"])
    return x + L.mlp(cfg, lp["mlp"], h), (k, v)


def forward(cfg, params, batch, *, q_block: "Optional[int]" = 512, return_kv: bool = False,
            last_only: bool = False, impl: str = "auto"):
    """Teacher-forcing forward. batch["tokens"]: (B, S) int.

    Returns (logits, aux_loss) or (logits, aux_loss, kv_cache) with
    ``return_kv`` (prefill: kv_cache is {'k','v'}: (L, B, S, K, hd)).
    ``aux_loss`` is 0: the dense family has no router.  ``impl`` goes to
    ``layers.attention``: ``ref`` keeps attention on the plain path."""
    _refuse_unported(cfg)
    tokens = batch["tokens"]
    x = L.embed(cfg, params["embed"], tokens)
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    cos, sin = _rope(cfg, positions)
    ks, vs = [], []
    for i in range(cfg.num_layers):
        x, (k, v) = _attn_mlp_layer(cfg, _layer(params, i), x, cos, sin, q_block=q_block,
                                    impl=impl)
        if return_kv:
            ks.append(k)
            vs.append(v)
    x = L.apply_norm(cfg, x, params["final_norm"])
    if last_only:  # prefill: only the final position feeds sampling
        x = x[:, -1:]
    logits = L.unembed(cfg, params["embed"], x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if return_kv:
        return logits, aux, {"k": torch.stack(ks), "v": torch.stack(vs)}
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
    """tokens: (B, 1) int; pos: the write position.

    Returns (logits (B, 1, V), cache); the cache is updated in place."""
    _refuse_unported(cfg)
    x = L.embed(cfg, params["embed"], tokens)
    B = x.shape[0]
    cos, sin = _rope(cfg, torch.full((B, 1), pos, dtype=torch.int64, device=x.device))
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
        x = x + L.mlp(cfg, lp["mlp"], h)
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
    last_logits: (B, V) f32 for the sampling stage."""
    batch = {"tokens": tokens}
    if extras:
        batch.update(extras)
    logits, _, kv = forward(cfg, params, batch, return_kv=True, last_only=True, impl=impl)
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
    kernel on a CUDA tensor (``impl="ref"``: the gather path)."""
    _refuse_unported(cfg)
    x = L.embed(cfg, params["embed"], tokens.reshape(-1, 1))
    cos, sin = _rope(cfg, positions[:, None])
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
        x = x + L.mlp(cfg, lp["mlp"], h)
    x = L.apply_norm(cfg, x, params["final_norm"])
    return k_pages, v_pages, state, L.unembed(cfg, params["embed"], x)[:, 0]
