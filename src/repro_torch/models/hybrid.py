"""Hymba hybrid-head model [arXiv:2411.13676] on PyTorch
(``src/repro/models/hybrid.py``).

Each block runs attention heads and Mamba-2 (SSD) heads IN PARALLEL on the
same normalized input; the two outputs are RMS-normalized, scaled and
averaged, as in the reference.  Sliding-window attention everywhere except
``cfg.global_attn_layers``; consecutive SWA layers share K/V
(``kv_share_group=2``: the first layer of a group produces K/V, the others
reuse them and have no K/V projections); ``cfg.meta_tokens`` learned
registers are prepended to the sequence.

Layers are heterogeneous, so params are a list of per-layer dicts, walked
in a Python loop.  Where the work goes on a CUDA tensor:

* prefill attention of the global layers, and of every layer while the
  sequence (meta included) fits the window, goes through
  ``layers.attention`` and so through the flash kernel; a longer sequence's
  SWA layers pad to whole windows and run the plain
  ``layers.local_block_attention``;
* every layer's SSM prefill goes through ``ssm.ssm_prefill``/``ssm_block``
  and so through the ssd_scan kernel (the scan's result does not depend on
  the chunk length: the plain path keeps ``cfg.ssm.chunk``);
* paged decode of the global producers goes through
  ``layers.paged_decode_attend`` and so through the paged-attention kernel,
  one launch a global layer; the SWA producers rebuild the ring the padded
  oracle holds with ``layers.ring_gather`` and attend in plain PyTorch,
  reading no value on the host, so the step can be captured.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.distribution.sharding import constrain, on_local_shards
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.layers import tree_map

_KV_KEYS = ("wk", "wv", "bk", "bv")


def _is_global(cfg, l: int) -> bool:
    return l in cfg.global_attn_layers


def _kv_producer(cfg, l: int) -> int:
    """Index of the layer whose K/V layer ``l`` consumes."""
    if _is_global(cfg, l) or cfg.kv_share_group <= 1:
        return l
    base = l - (l % cfg.kv_share_group)
    return l if _is_global(cfg, base) else base


def kv_producers(cfg) -> "list[int]":
    return sorted({_kv_producer(cfg, l) for l in range(cfg.num_layers)})


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def _layout(cfg, l: int):
    """Layer ``l``'s (shape, fill) leaves but its SSM's; a consumer layer
    has no K/V projections."""
    attn = L.attn_layout(cfg)
    if _kv_producer(cfg, l) != l:
        for n in _KV_KEYS:
            attn.pop(n, None)
    d = (cfg.d_model,)
    return {"ln1": L.norm_layout(cfg), "attn": attn, "fuse_attn": (d, "ones"),
            "fuse_ssm": (d, "ones"), "ln2": L.norm_layout(cfg), "mlp": L.mlp_layout(cfg)}


def param_shapes(cfg):
    """The params' names and shapes, as the JAX ``init`` makes them."""
    shape = lambda leaf: leaf[0]  # noqa: E731
    return {
        "embed": tree_map(shape, L.embed_layout(cfg)),
        "meta": (cfg.meta_tokens, cfg.d_model),
        "layers": [dict(tree_map(shape, _layout(cfg, l)), ssm=S.ssm_param_shapes(cfg))
                   for l in range(cfg.num_layers)],
        "final_norm": tree_map(shape, L.norm_layout(cfg)),
    }


def param_specs(cfg):
    """Logical sharding names for every param; a consumer layer has no K/V
    projections."""
    def layer(l):
        attn = L.attn_specs(cfg)
        if _kv_producer(cfg, l) != l:
            for n in _KV_KEYS:
                attn.pop(n, None)
        return {"ln1": L.norm_specs(cfg), "attn": attn, "ssm": S.ssm_specs(cfg),
                "fuse_attn": ("p_none",), "fuse_ssm": ("p_none",), "ln2": L.norm_specs(cfg),
                "mlp": L.mlp_specs(cfg)}

    return {"embed": L.embed_specs(cfg), "meta": ("p_none", "p_embed"),
            "layers": [layer(l) for l in range(cfg.num_layers)],
            "final_norm": L.norm_specs(cfg)}


def init(cfg, *, generator: "torch.Generator", device, dtype=torch.float32):
    """The reference's distributions (fan-in scaled truncated normals,
    embeddings and meta tokens at 0.02, ``ssm.init_ssm`` per layer, norm and
    fuse scales 1), drawn from ``generator`` (on ``device``) in a fixed
    order."""
    def leaves(layout):
        return tree_map(lambda leaf: L.init_leaf(leaf, generator=generator, device=device,
                                                 dtype=dtype), layout)

    embed = leaves(L.embed_layout(cfg))
    meta_shape = (cfg.meta_tokens, cfg.d_model)
    meta = (L.ninit(meta_shape, generator=generator, device=device, dtype=dtype, scale=0.02)
            if cfg.meta_tokens else torch.zeros(meta_shape, dtype=dtype, device=device))
    layers = []
    for l in range(cfg.num_layers):
        lp = leaves(_layout(cfg, l))
        lp["ssm"] = S.init_ssm(cfg, generator=generator, device=device, dtype=dtype)
        layers.append(lp)
    return {"embed": embed, "meta": meta, "layers": layers,
            "final_norm": leaves(L.norm_layout(cfg))}


# ---------------------------------------------------------------------------
# the block's parts
# ---------------------------------------------------------------------------

def _rope(cfg, positions):
    return L.rope_angles(positions, int(cfg.hd * cfg.partial_rotary), cfg.rope_theta)


def _qkv(cfg, p, h, cos, sin):
    """q, and (k, v) where the layer makes its own (None for a consumer of
    another layer's), from h: projections of one input
    (``layers.projections``)."""
    own = "wk" in p
    names = ("q", "k", "v") if own else ("q",)
    out = L.projections(h, *(p["w" + n] for n in names))
    if cfg.attn_qkv_bias:
        out = tuple(t + p["b" + n] for t, n in zip(out, names))
    q = L.apply_rope(L.group_heads(cfg, out[0], "q"), cos, sin)
    if not own:
        return q, None
    return q, (L.apply_rope(L.group_heads(cfg, out[1], "kv"), cos, sin),
               L.group_heads(cfg, out[2], "kv"))


def _fuse_mlp(cfg, lp, x, y_attn, y_ssm):
    """x + the mean of the two normalized paths, then the MLP's residual."""
    eps = cfg.norm_eps
    x = x + 0.5 * (L.rmsnorm(y_attn, lp["fuse_attn"], eps) + L.rmsnorm(y_ssm, lp["fuse_ssm"], eps))
    return x + L.mlp(cfg, lp["mlp"], L.apply_norm(cfg, x, lp["ln2"]))


# rows and heads of a (B, S, H, D) pad along S are independent
_PAD_SHARD_DIMS = {"batch": ((0,), (0,)), "heads": ((2,), (2,))}


def _pad_to(x, mult: int):
    """``x`` (B, S, H, D) zero-padded along S to a multiple of ``mult``;
    under a mesh on the local shards of rows and heads (torch 2.11's
    ``DTensor`` failed to plan this pad in Hymba-1.5B's prefill_32k)."""
    pad = (-x.shape[1]) % mult
    if not pad:
        return x
    return on_local_shards(functools.partial(F.pad, pad=(0, 0, 0, 0, 0, pad)), (x,),
                           _PAD_SHARD_DIMS)


def _prefill_attend(cfg, l: int, q, k, v, *, q_block, impl):
    S_, w = q.shape[1], cfg.sliding_window
    if _is_global(cfg, l) or w is None or S_ <= w:
        return L.attention(q, k, v, causal=True, q_block=q_block, impl=impl)
    return L.local_block_attention(_pad_to(q, w), _pad_to(k, w), _pad_to(v, w), window=w)[:, :S_]


def _prefill(cfg, params, tokens, *, q_block, impl, keep_kv: bool, keep_state: bool,
             remat: str = "none"):
    """The stack over meta + tokens -> (final-normed content positions
    (B, T, D), {producer: (k, v)} if ``keep_kv``, per-layer SSM caches if
    ``keep_state``)."""
    x = L.embed(cfg, params["embed"], tokens)
    B = x.shape[0]
    if cfg.meta_tokens:
        meta = params["meta"][None].expand(B, -1, -1).to(x.dtype)
        x = torch.cat([meta, x], dim=1)
    S_ = x.shape[1]
    cos, sin = _rope(cfg, torch.arange(S_, device=x.device)[None].expand(B, S_))
    remat = L.remat_whole(remat)
    shared, kvs, caches = None, {}, []

    def block(x, lp, l, shared):
        h = L.apply_norm(cfg, x, lp["ln1"])
        cache = None
        if keep_state:
            y_ssm, cache = S.ssm_prefill(cfg, lp["ssm"], h, impl=impl)
        else:
            y_ssm = S.ssm_block(cfg, lp["ssm"], h, impl=impl)
        q, kv = _qkv(cfg, lp["attn"], h, cos, sin)
        k, v = kv if kv is not None else shared
        o = _prefill_attend(cfg, l, q, k, v, q_block=q_block, impl=impl)
        x = _fuse_mlp(cfg, lp, x, L.out_proj(cfg, lp["attn"], o), y_ssm)
        return constrain(x, "batch", "seq", "embed"), (k, v), cache

    for l, lp in enumerate(params["layers"]):
        x, (k, v), cache = L.remat_call(remat, block, x, lp, l, shared)
        if keep_state:
            caches.append(cache)
        if _kv_producer(cfg, l) == l:
            shared = (k, v)
            if keep_kv:
                kvs[l] = (L.whole_heads(cfg, k), L.whole_heads(cfg, v))
    x = L.apply_norm(cfg, x, params["final_norm"])
    return x[:, cfg.meta_tokens:], kvs, caches


def forward(cfg, params, batch, *, q_block: int = 512, remat: str = "none",
            return_kv: bool = False, last_only: bool = False, impl: str = "auto"):
    """Teacher-forcing forward. batch["tokens"]: (B, S) int.

    Returns (logits (B, S, V), aux_loss) or, with ``return_kv``, (logits,
    aux_loss, {producer layer: (k, v)}), each (B, meta + S, K, hd).  The
    meta positions are dropped before the unembedding; ``aux_loss`` is 0.
    ``remat`` dots or full recomputes each block whole in the backward, as
    the reference does.  ``impl="ref"`` keeps attention and the scans on
    the plain path."""
    x, kvs, _ = _prefill(cfg, params, batch["tokens"], q_block=q_block, impl=impl,
                         keep_kv=return_kv, keep_state=False, remat=remat)
    if last_only:
        x = x[:, -1:]
    logits = L.unembed(cfg, params["embed"], x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return (logits, aux, kvs) if return_kv else (logits, aux)


def loss_fn(cfg, params, batch, **kw):
    """Mean next-token cross-entropy (f32); ``kw`` goes to ``forward``."""
    logits, _ = forward(cfg, params, batch, **kw)
    return L.xent_loss(logits, batch["labels"], batch.get("loss_mask"))


# ---------------------------------------------------------------------------
# decode: ring caches for SWA producers, full caches for global layers,
# SSM state for every layer
# ---------------------------------------------------------------------------

def _cache_slots(cfg) -> "dict[int, tuple[str, int]]":
    """producer layer -> ("swa" or "glob", its index in that cache)."""
    slots, n = {}, {"swa": 0, "glob": 0}
    for l in kv_producers(cfg):
        kind = "glob" if _is_global(cfg, l) else "swa"
        slots[l] = (kind, n[kind])
        n[kind] += 1
    return slots


def init_cache(cfg, batch: int, max_seq: int, *, device, dtype=torch.bfloat16):
    """Zeroed decode cache on ``device``: ``swa_k``/``swa_v`` (SWA producers,
    batch, ring, K, hd) with ring = min(window, max_seq), ``glob_k``/
    ``glob_v`` (global producers, batch, max_seq, K, hd), and every layer's
    ``ssm_state`` (L, batch, H, N, P) f32 and ``ssm_conv`` (L, batch,
    d_conv - 1, C).  ``max_seq`` counts meta tokens too."""
    kinds = [k for k, _ in _cache_slots(cfg).values()]
    ring = min(cfg.sliding_window or max_seq, max_seq)
    K, hd = cfg.num_kv_heads, cfg.hd

    def kv(kind, width):
        return torch.zeros((kinds.count(kind), batch, width, K, hd), dtype=dtype, device=device)

    one = S.init_ssm_cache(cfg, batch, device=device, dtype=dtype)
    return {"swa_k": kv("swa", ring), "swa_v": kv("swa", ring),
            "glob_k": kv("glob", max_seq), "glob_v": kv("glob", max_seq),
            "ssm_state": one["state"].expand(cfg.num_layers, *one["state"].shape).clone(),
            "ssm_conv": one["conv"].expand(cfg.num_layers, *one["conv"].shape).clone()}


def seed_cache(cfg, cache, k, v, state):
    """Write ``paged_prefill``'s rows into an ``init_cache`` cache of the
    same batch, IN PLACE, as the padded oracle starts from them: k/v (B,
    producers, T', K, hd), meta included; ``state`` its batch-leading
    ``ssm_state``/``ssm_conv``.  A global producer takes tokens [0, T'); an
    SWA producer the ring layout, token t in slot t % ring (the last ``ring``
    tokens: what writing all of them in order leaves).  Returns the cache."""
    T = k.shape[2]
    ring = cache["swa_k"].shape[2]
    t = torch.arange(max(T - ring, 0), T, device=k.device)
    for li, (kind, i) in enumerate(_cache_slots(cfg).values()):
        if kind == "glob":
            cache["glob_k"][i, :, :T] = k[:, li]
            cache["glob_v"][i, :, :T] = v[:, li]
        else:
            cache["swa_k"][i][:, t % ring] = k[:, li, t]
            cache["swa_v"][i][:, t % ring] = v[:, li, t]
    cache["ssm_state"].copy_(state["ssm_state"].movedim(0, 1))
    cache["ssm_conv"].copy_(state["ssm_conv"].movedim(0, 1))
    return cache



def cache_specs(cfg):
    """Logical sharding names of ``init_cache``'s leaves (the K/V stacks'
    first dim counts producers, not layers: unsharded)."""
    kv = (None, "batch", "seq", "kv_heads", "head_dim")
    return {
        "swa_k": kv,
        "swa_v": kv,
        "glob_k": kv,
        "glob_v": kv,
        "ssm_state": ("layers", "batch", "ssm_heads", "ssm_state", None),
        "ssm_conv": ("layers", "batch", None, "ssm_inner"),
    }

def decode_step(cfg, params, cache, tokens, pos: int):
    """tokens: (B, 1) int; ``pos`` counts CONTENT tokens (the meta offset is
    added here).  Returns (logits (B, 1, V), cache); the cache is updated in
    place.  Plain PyTorch: the padded oracle of ``paged_decode_step``."""
    x = L.embed(cfg, params["embed"], tokens)
    B = x.shape[0]
    apos = pos + cfg.meta_tokens
    cos, sin = _rope(cfg, torch.full((B, 1), apos, dtype=torch.int64, device=x.device))
    slots = _cache_slots(cfg)
    w = cfg.sliding_window
    shared = None
    for l, lp in enumerate(params["layers"]):
        h = L.apply_norm(cfg, x, lp["ln1"])
        y_ssm, new = S.ssm_decode_step(cfg, lp["ssm"], h, {"state": cache["ssm_state"][l],
                                                           "conv": cache["ssm_conv"][l]})
        cache["ssm_state"][l] = new["state"]
        cache["ssm_conv"][l] = new["conv"]
        q, kv = _qkv(cfg, lp["attn"], h, cos, sin)
        if kv is not None:
            k, v = kv
            kind, i = slots[l]
            ck, cv = cache[f"{kind}_k"][i], cache[f"{kind}_v"][i]
            if kind == "glob":
                L.cache_update(ck, cv, k, v, apos)
                o = L.decode_attend(cfg, q, ck, cv, apos)
            else:
                L.cache_update(ck, cv, k, v, apos, ring=ck.shape[1])
                o = L.decode_attend(cfg, q, ck, cv, apos, window=w)
                shared = (ck, cv)
        else:  # a consumer follows an SWA producer: its ring
            o = L.decode_attend(cfg, q, *shared, apos, window=w)
        x = _fuse_mlp(cfg, lp, x, L.out_proj(cfg, lp["attn"], o), y_ssm)
    x = L.apply_norm(cfg, x, params["final_norm"])
    return L.unembed(cfg, params["embed"], x), cache


# ---------------------------------------------------------------------------
# paged serving contract
# ---------------------------------------------------------------------------

def paged_spec(cfg):
    """One slab layer per K/V PRODUCER (consumers share the producer's
    pages, as they share its cache in ``decode_step``).  SWA layers keep the
    full history in pages; decode rebuilds the ring with
    ``layers.ring_gather``, so one table serves the whole stack."""
    from repro_torch.serving.paged import PageSpec

    return PageSpec(layers=len(kv_producers(cfg)), page_size=0, kv_heads=cfg.num_kv_heads,
                    head_dim=cfg.hd, dtype=torch.float32)


def paged_prefill(cfg, params, tokens, extras=None, *, impl: str = "auto"):
    """tokens: (B, T) -> (k, v, state, last_logits).

    k/v: (B, producers, T', K, hd) with T' = meta + T: the meta registers
    page in with the prompt, so a sequence's page length and its decode
    positions are one absolute coordinate.  state: batch-leading
    ``ssm_state`` (B, L, H, N, P) f32 and ``ssm_conv`` (B, L, d_conv - 1,
    C), the caches ``ssm.ssm_prefill`` leaves.  last_logits: (B, V) f32."""
    x, kvs, caches = _prefill(cfg, params, tokens, q_block=512, impl=impl, keep_kv=True,
                              keep_state=True)
    logits = L.unembed(cfg, params["embed"], x[:, -1:])
    producers = kv_producers(cfg)
    k = torch.stack([kvs[l][0] for l in producers], dim=1)
    v = torch.stack([kvs[l][1] for l in producers], dim=1)
    state = {"ssm_state": torch.stack([c["state"] for c in caches], dim=1),
             "ssm_conv": torch.stack([c["conv"] for c in caches], dim=1)}
    return k, v, state, logits[:, 0]


def paged_decode_step(cfg, params, k_pages, v_pages, state, tokens, positions, tables, lengths,
                      *, impl: str = "auto"):
    """One ragged decode step against the page pool.

    k_pages/v_pages: (producers, N, P, K, hd) slabs, updated IN PLACE;
    tokens: (B,); positions == lengths: (B,) int32 ABSOLUTE page coordinates
    (meta included); tables: (B, M) int32; state: batch-leading, as
    ``paged_prefill`` returns it.  Per row the math is ``decode_step``'s:
    global producers scatter and attend over ``lengths + 1`` slots through
    the paged-attention kernel on a CUDA tensor (``impl="ref"``, or a CPU
    tensor: the gather path); SWA producers scatter, rebuild the ring of
    ``min(window, M * P)`` slots and attend over ``min(pos + 1, ring)`` of
    them; consumers reuse their producer's ring; every layer's SSM state
    advances.  Returns (k_pages, v_pages, state, logits (B, V))."""
    x = L.embed(cfg, params["embed"], tokens.reshape(-1, 1))
    cos, sin = _rope(cfg, positions[:, None])
    width = tables.shape[1] * k_pages.shape[2]
    ring = min(cfg.sliding_window, width) if cfg.sliding_window else width
    prod_ix = {l: i for i, l in enumerate(kv_producers(cfg))}
    states, convs = [], []
    shared = None
    for l, lp in enumerate(params["layers"]):
        h = L.apply_norm(cfg, x, lp["ln1"])
        y_ssm, new = S.ssm_decode_step(cfg, lp["ssm"], h, {"state": state["ssm_state"][:, l],
                                                           "conv": state["ssm_conv"][:, l]})
        states.append(new["state"])
        convs.append(new["conv"])
        q, kv = _qkv(cfg, lp["attn"], h, cos, sin)
        if kv is not None:
            k, v = kv
            i = prod_ix[l]
            kp, vp = L.page_scatter(k_pages[i], v_pages[i], k, v, tables, positions)
            if _is_global(cfg, l):
                o = L.paged_decode_attend(q, kp, vp, tables, lengths, impl=impl)
            else:
                shared = (L.ring_gather(kp, tables, positions, ring),
                          L.ring_gather(vp, tables, positions, ring),
                          torch.clamp(positions + 1, max=ring))
                o = L.attention(q, shared[0], shared[1], causal=False, valid_len=shared[2])
        else:
            o = L.attention(q, shared[0], shared[1], causal=False, valid_len=shared[2])
        x = _fuse_mlp(cfg, lp, x, L.out_proj(cfg, lp["attn"], o), y_ssm)
    x = L.apply_norm(cfg, x, params["final_norm"])
    state = {"ssm_state": torch.stack(states, dim=1), "ssm_conv": torch.stack(convs, dim=1)}
    return k_pages, v_pages, state, L.unembed(cfg, params["embed"], x)[:, 0]
