"""Whisper-style encoder-decoder backbone [arXiv:2212.04356]
(``src/repro/models/encdec.py`` on PyTorch).

The conv/mel frontend is a STUB, as in the reference: the encoder consumes
precomputed frame embeddings (B, S_enc, D); sinusoidal positions are added
here.  Decoder: learned positions, causal self-attention with a KV cache,
and cross-attention over the encoder states (K/V computed once, at
prefill).  ``enc_layers`` and ``dec_layers`` are Python lists of layer
dicts, as in the reference.

On a CUDA tensor the encoder's self-attention (non-causal) and the
decoder's prefill self-attention (causal) run the flash kernel, and the
paged decode's self-attention the paged-attention kernel; cross-attention
(queries and keys of other lengths) stays on the plain path.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.models import layers as L
from repro_torch.models.layers import tree_map


def _sinusoid(S, D, device=None):
    pos = np.arange(S)[:, None]
    dim = np.arange(D // 2)[None]
    inv = 1.0 / (10_000 ** (dim / max(D // 2 - 1, 1)))
    ang = pos * inv
    return torch.from_numpy(
        np.concatenate([np.sin(ang), np.cos(ang)], axis=-1).astype(np.float32)).to(device)


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def _block_layout(cfg, cross: bool):
    p = {"ln1": L.norm_layout(cfg), "attn": L.attn_layout(cfg),
         "ln2": L.norm_layout(cfg), "mlp": L.mlp_layout(cfg)}
    if cross:
        p["ln_x"] = L.norm_layout(cfg)
        p["xattn"] = L.attn_layout(cfg)
    return p


def _layout(cfg):
    """Nested (shape, fill) leaves, as ``layers.init_leaf`` takes them."""
    e = cfg.encdec
    return {
        "embed": L.embed_layout(cfg),
        "dec_pos": ((e.max_target_positions, cfg.d_model), 0.02),
        "enc_layers": [_block_layout(cfg, False) for _ in range(e.encoder_layers)],
        "dec_layers": [_block_layout(cfg, True) for _ in range(cfg.num_layers)],
        "enc_norm": L.norm_layout(cfg),
        "final_norm": L.norm_layout(cfg),
    }


def param_shapes(cfg):
    """The params' names and shapes, as the JAX ``init`` makes them."""
    return tree_map(lambda leaf: leaf[0], _layout(cfg))


def _block_specs(cfg, cross: bool):
    s = {"ln1": L.norm_specs(cfg), "attn": L.attn_specs(cfg), "ln2": L.norm_specs(cfg),
         "mlp": L.mlp_specs(cfg)}
    if cross:
        s["ln_x"] = L.norm_specs(cfg)
        s["xattn"] = L.attn_specs(cfg)
    return s


def param_specs(cfg):
    """Logical sharding names for every param."""
    return {
        "embed": L.embed_specs(cfg),
        "dec_pos": ("p_none", "p_embed"),
        "enc_layers": [_block_specs(cfg, False) for _ in range(cfg.encdec.encoder_layers)],
        "dec_layers": [_block_specs(cfg, True) for _ in range(cfg.num_layers)],
        "enc_norm": L.norm_specs(cfg),
        "final_norm": L.norm_specs(cfg),
    }


def init(cfg, *, generator: "torch.Generator", device, dtype=torch.float32):
    """Truncated-normal ([-2, 2]) weights scaled by 1/sqrt(fan-in), like
    the reference's ``ninit``; embeddings and decoder positions at 0.02;
    norm scales 1, biases 0.  Drawn from ``generator`` (on ``device``) leaf
    by leaf in a fixed order."""
    return tree_map(lambda leaf: L.init_leaf(leaf, generator=generator, device=device,
                                             dtype=dtype), _layout(cfg))


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _self_block(cfg, lp, x, *, causal, q_block, impl):
    h = L.apply_norm(cfg, x, lp["ln1"])
    q, k, v = L.qkv_proj(cfg, lp["attn"], h)
    o = L.attention(q, k, v, causal=causal, q_block=q_block, impl=impl)
    x = x + L.out_proj(cfg, lp["attn"], o)
    return x, (k, v)


def _cross(cfg, lp, x, ek, ev, *, impl="auto"):
    h = L.apply_norm(cfg, x, lp["ln_x"])
    q = L.linear(h, lp["xattn"]["wq"])
    if cfg.attn_qkv_bias:
        q = q + lp["xattn"]["bq"]
    o = L.cross_attend(L.group_heads(cfg, q, "q"), ek, ev, impl=impl)
    return x + L.out_proj(cfg, lp["xattn"], o)


def _mlp_block(cfg, lp, x):
    return x + L.mlp(cfg, lp["mlp"], L.apply_norm(cfg, x, lp["ln2"]))


def encode(cfg, params, frames, *, remat: str = "none", impl: str = "auto"):
    """frames: (B, S_enc, D) stub embeddings -> encoder states.  ``remat``
    dots or full recomputes each layer whole in the backward, as the
    reference does."""
    x = frames + _sinusoid(frames.shape[1], cfg.d_model, frames.device).to(frames.dtype)

    def enc_layer(x, lp):
        x, _ = _self_block(cfg, lp, x, causal=False, q_block=None, impl=impl)
        return _mlp_block(cfg, lp, x)

    for lp in params["enc_layers"]:
        x = L.remat_call(L.remat_whole(remat), enc_layer, x, lp)
    return L.apply_norm(cfg, x, params["enc_norm"])


def _cross_kv(cfg, params, enc):
    """Cross-attention K/V of every decoder layer, from the encoder states
    (under head groups in the group layout, ``layers.group_heads``):
    projections of one input (``layers.projections``)."""
    lps = params["dec_layers"]
    kv = L.projections(enc, *(lp["xattn"][w] for lp in lps for w in ("wk", "wv")))
    out = []
    for i, lp in enumerate(lps):
        k, v = kv[2 * i], kv[2 * i + 1]
        if cfg.attn_qkv_bias:
            k, v = k + lp["xattn"]["bk"], v + lp["xattn"]["bv"]
        out.append((L.group_heads(cfg, k, "kv"), L.group_heads(cfg, v, "kv")))
    return out


def forward(cfg, params, batch, *, q_block: "Optional[int]" = 512, remat: str = "none",
            return_kv: bool = False, last_only: bool = False, impl: str = "auto"):
    """batch: {'frames': (B, S_enc, D) stub, 'tokens': (B, S_dec)}.

    Returns (logits, aux) or, with ``return_kv``, (logits, aux, {"self":
    [(k, v)] a decoder layer, "cross": [(k, v)] a decoder layer}); aux is
    0.  ``remat`` dots or full recomputes each encoder and decoder layer
    whole in the backward, as the reference does.  ``impl="ref"`` keeps
    every attention on the plain path."""
    enc = encode(cfg, params, batch["frames"], remat=remat, impl=impl)
    xkv = _cross_kv(cfg, params, enc)

    tokens = batch["tokens"]
    B, S = tokens.shape
    x = L.embed(cfg, params["embed"], tokens)
    pos_tab = params["dec_pos"]
    idx = torch.arange(S, device=tokens.device) % pos_tab.shape[0]  # cells may exceed 448
    x = x + L.table_rows(pos_tab, idx)[None].to(x.dtype)

    def dec_layer(x, lp, ek, ev):
        x, kv = _self_block(cfg, lp, x, causal=True, q_block=q_block, impl=impl)
        x = _cross(cfg, lp, x, ek, ev, impl=impl)
        return _mlp_block(cfg, lp, x), kv

    kvs = []
    for lp, (ek, ev) in zip(params["dec_layers"], xkv):
        x, kv = L.remat_call(L.remat_whole(remat), dec_layer, x, lp, ek, ev)
        kvs.append(kv)

    x = L.apply_norm(cfg, x, params["final_norm"])
    if last_only:
        x = x[:, -1:]
    logits = L.unembed(cfg, params["embed"], x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if return_kv:
        whole = [tuple(L.whole_heads(cfg, t) for t in kv) for kv in kvs]
        return logits, aux, {"self": whole, "cross": [tuple(L.whole_heads(cfg, t) for t in kv)
                                                      for kv in xkv]}
    return logits, aux


def loss_fn(cfg, params, batch, **kw):
    """Mean next-token cross-entropy (f32); ``kw`` goes to ``forward``."""
    logits, _ = forward(cfg, params, batch, **kw)
    return L.xent_loss(logits, batch["labels"], batch.get("loss_mask"))


# ---------------------------------------------------------------------------
# decode (one token, contiguous self cache + cross K/V)
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_seq: int, *, device, dtype=torch.bfloat16):
    """Zeroed self K/V (L, batch, max_seq, K, hd) and cross K/V (L, batch,
    S_enc, K, hd) on ``device``."""
    e = cfg.encdec
    Ld, K, hd = cfg.num_layers, cfg.num_kv_heads, cfg.hd
    self_shape, cross_shape = (Ld, batch, max_seq, K, hd), (Ld, batch, e.encoder_seq, K, hd)
    return {"self_k": torch.zeros(self_shape, dtype=dtype, device=device),
            "self_v": torch.zeros(self_shape, dtype=dtype, device=device),
            "cross_k": torch.zeros(cross_shape, dtype=dtype, device=device),
            "cross_v": torch.zeros(cross_shape, dtype=dtype, device=device)}



def cache_specs(cfg):
    """Logical sharding names of ``init_cache``'s leaves."""
    kv = ("layers", "batch", "seq", "kv_heads", "head_dim")
    return {"self_k": kv, "self_v": kv, "cross_k": kv, "cross_v": kv}

def decode_step(cfg, params, cache, tokens, pos: int):
    """One decoder token against the self cache and the cross K/V.

    Returns (logits (B, 1, V), cache); the cache is updated in place."""
    x = L.embed(cfg, params["embed"], tokens)
    pos_tab = params["dec_pos"]
    x = x + pos_tab[pos % pos_tab.shape[0]][None, None].to(x.dtype)
    for i, lp in enumerate(params["dec_layers"]):
        h = L.apply_norm(cfg, x, lp["ln1"])
        q, k, v = L.qkv_proj(cfg, lp["attn"], h)
        ck, cv = L.cache_update(cache["self_k"][i], cache["self_v"][i], k, v, pos)
        o = L.decode_attend(cfg, q, ck, cv, pos)
        x = x + L.out_proj(cfg, lp["attn"], o)
        x = _cross(cfg, lp, x, cache["cross_k"][i], cache["cross_v"][i])
        x = _mlp_block(cfg, lp, x)
    x = L.apply_norm(cfg, x, params["final_norm"])
    return L.unembed(cfg, params["embed"], x), cache


# ---------------------------------------------------------------------------
# paged serving contract
# ---------------------------------------------------------------------------

def paged_spec(cfg):
    """Decoder self-KV lives in pages; the fixed-size cross K/V (one entry
    per encoder frame, never grows) rides as per-sequence state."""
    from repro_torch.serving.paged import PageSpec

    return PageSpec(layers=cfg.num_layers, page_size=0, kv_heads=cfg.num_kv_heads,
                    head_dim=cfg.hd, dtype=torch.float32)


def paged_prefill(cfg, params, tokens, extras=None, *, impl: str = "auto"):
    """tokens: (B, T); extras['frames']: (B, S_enc, D) stub embeddings.

    Returns (k, v, state, last_logits): self-KV rows (B, L, T, K, hd) for
    the pages, and the cross K/V stacked batch-leading as resident state
    {"cross_k", "cross_v"}: (B, L, S_enc, K, hd)."""
    logits, _, kv = forward(cfg, params, {"frames": extras["frames"], "tokens": tokens},
                            return_kv=True, last_only=True, impl=impl)
    k = torch.stack([kv_l[0] for kv_l in kv["self"]], dim=1)  # (B, L, T, K, hd)
    v = torch.stack([kv_l[1] for kv_l in kv["self"]], dim=1)
    state = {"cross_k": torch.stack([x[0] for x in kv["cross"]], dim=1),
             "cross_v": torch.stack([x[1] for x in kv["cross"]], dim=1)}
    return k, v, state, logits[:, -1]


def paged_decode_step(cfg, params, k_pages, v_pages, state, tokens, positions, tables, lengths,
                      *, impl: str = "auto"):
    """One ragged decoder step: scatter the self-KV into the pages (IN
    PLACE), attend over each row's own prefix (the paged-attention kernel on
    a CUDA tensor; ``impl="ref"``: the gather path), cross-attend the
    resident encoder K/V.  Per-row math is ``decode_step``'s."""
    tokens = tokens.reshape(-1, 1)
    x = L.embed(cfg, params["embed"], tokens)
    pos_tab = params["dec_pos"]
    x = x + pos_tab[positions.long() % pos_tab.shape[0]][:, None].to(x.dtype)
    for i, lp in enumerate(params["dec_layers"]):
        h = L.apply_norm(cfg, x, lp["ln1"])
        q, k, v = L.qkv_proj(cfg, lp["attn"], h)
        kp, vp = L.page_scatter(k_pages[i], v_pages[i], k, v, tables, positions)
        o = L.paged_decode_attend(q, kp, vp, tables, lengths, impl=impl)
        x = x + L.out_proj(cfg, lp["attn"], o)
        x = _cross(cfg, lp, x, state["cross_k"][:, i], state["cross_v"][:, i])
        x = _mlp_block(cfg, lp, x)
    x = L.apply_norm(cfg, x, params["final_norm"])
    return k_pages, v_pages, state, L.unembed(cfg, params["embed"], x)[:, 0]
