"""Model building blocks on PyTorch tensors (the parts of
``src/repro/models/layers.py`` the dense, moe, vlm, encdec and hybrid
families use).

Conventions
-----------
* Activations are ``(batch, seq, ...)``; params are plain dicts of tensors,
  named as in the JAX tree.
* Norms, rotary embeddings, scores and softmax compute in f32; projections
  keep the activation dtype, as the reference's ``preferred_element_type``
  does; the logits are f32.
* ``attention`` sends self-attention on a CUDA tensor (causal or not,
  queries and keys both from position 0, Sq == Skv, no valid length, no
  logit softcap) through the hand-written flash kernel
  (``repro_torch.kernels.flash_attention``).  Every other case (decode,
  cross-attention, a softcap, a sliding window), and every CPU tensor,
  computes the plain math of the reference, chunked over query blocks of
  ``q_block`` (exact: each block sees all keys).
* Sliding windows (``local_block_attention``, ``cache_update(ring=)``,
  ``decode_attend(window=)``, ``ring_gather``, ``paged_ring_attend``) are
  plain PyTorch, as in the reference, which has no kernel for them.
* ``paged_decode_attend`` sends a CUDA tensor through the hand-written
  paged-attention kernel (``repro_torch.kernels.paged_attention``); a CPU
  tensor, or ``impl="ref"``, gathers the pages into a contiguous cache and
  runs the plain ``attention``, as the reference always does.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.paged_attention.ops import paged_attention

F32 = torch.float32
NEG_INF = -1e30


def tree_map(fn, tree):
    """``fn`` over the leaves of nested dicts and lists (whisper's layers
    are a list of dicts, as in the reference)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def ninit(shape, *, generator: "torch.Generator", device, dtype=F32,
          scale: "Optional[float]" = None):
    """Truncated normal on [-2, 2] times ``scale`` (None: 1/sqrt(fan-in),
    fan-in = shape[-2]), drawn in f32 from ``generator``, as the
    reference's ``ninit``."""
    t = torch.empty(shape, dtype=F32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(scale if scale is not None else 1.0 / math.sqrt(shape[-2])).to(dtype)


def init_leaf(leaf, *, generator: "torch.Generator", device, dtype=F32):
    """A (shape, fill) leaf: fill is "ones", "zeros", or ``ninit``'s scale.
    A third element, where there is one, is the leaf's own dtype (the MoE
    router stays f32 whatever ``dtype`` the rest takes)."""
    shape, fill, dtype = (*leaf, dtype)[:3]
    if fill in ("ones", "zeros"):
        return torch.full(shape, 1.0 if fill == "ones" else 0.0, dtype=dtype, device=device)
    return ninit(shape, generator=generator, device=device, dtype=dtype, scale=fill)


def embed_layout(cfg):
    """The embedding's (shape, fill) leaves: the table at 0.02, and an
    untied unembedding at fan-in scale."""
    emb = {"table": ((cfg.vocab_size, cfg.d_model), 0.02)}
    if not cfg.tie_embeddings:
        emb["unembed"] = ((cfg.d_model, cfg.vocab_size), None)
    return emb


def attn_layout(cfg, lead=()):
    """The attention block's (shape, fill) leaves, with leading dims
    ``lead``: fan-in scaled projections, zero biases where the config has
    them."""
    d, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    p = {"wq": ((*lead, d, H * hd), None), "wk": ((*lead, d, K * hd), None),
         "wv": ((*lead, d, K * hd), None), "wo": ((*lead, H * hd, d), None)}
    if cfg.attn_qkv_bias:
        p.update({"bq": ((*lead, H * hd), "zeros"), "bk": ((*lead, K * hd), "zeros"),
                  "bv": ((*lead, K * hd), "zeros")})
    if cfg.attn_out_bias:
        p["bo"] = ((*lead, d), "zeros")
    return p


def mlp_layout(cfg, lead=()):
    """The MLP's (shape, fill) leaves, with leading dims ``lead``."""
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp_type in ("swiglu", "geglu"):
        p = {"wi_gate": ((*lead, d, f), None), "wi_up": ((*lead, d, f), None),
             "wo": ((*lead, f, d), None)}
        if cfg.mlp_bias:
            p.update({"bi_gate": ((*lead, f), "zeros"), "bi_up": ((*lead, f), "zeros"),
                      "bo": ((*lead, d), "zeros")})
        return p
    p = {"wi": ((*lead, d, f), None), "wo": ((*lead, f, d), None)}
    if cfg.mlp_bias:
        p.update({"bi": ((*lead, f), "zeros"), "bo": ((*lead, d), "zeros")})
    return p


def norm_layout(cfg, lead=()):
    """The norm's (shape, fill) leaves, with leading dims ``lead``."""
    d = (*lead, cfg.d_model)
    if cfg.norm_type in ("rmsnorm", "layernorm_nobias"):
        return {"scale": (d, "ones")}
    if cfg.norm_type == "layernorm":
        return {"scale": (d, "ones"), "bias": (d, "zeros")}
    return {}  # nonparam


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(x, w, eps: float):
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * w.float()).to(x.dtype)


def layernorm(x, w, b, eps: float):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if w is not None:
        y = y * w.float()
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


def apply_norm(cfg, x, p):
    """Dispatch on cfg.norm_type; ``p`` is the layer's norm param dict."""
    if cfg.norm_type == "rmsnorm":
        return rmsnorm(x, p["scale"], cfg.norm_eps)
    if cfg.norm_type == "layernorm":
        return layernorm(x, p["scale"], p["bias"], cfg.norm_eps)
    if cfg.norm_type == "layernorm_nobias":
        return layernorm(x, p["scale"], None, cfg.norm_eps)
    if cfg.norm_type == "nonparam_layernorm":  # olmo
        return layernorm(x, None, None, cfg.norm_eps)
    raise ValueError(cfg.norm_type)


# ---------------------------------------------------------------------------
# rotary embeddings (RoPE / partial RoPE / M-RoPE)
# ---------------------------------------------------------------------------

def rope_angles(positions, rotary_dim: int, theta: float, sections=()):
    """positions: (B, S) int, or (3, B, S) for M-RoPE (t, h, w streams).

    Returns (cos, sin) of shape (B, S, rotary_dim), rotate-half convention
    (angles repeated over both halves).  With ``sections`` the frequency
    bands of the half are split between the t, h and w position ids."""
    half = rotary_dim // 2
    inv_freq = 1.0 / (theta ** (torch.arange(0, half, dtype=F32, device=positions.device) / half))
    if sections:
        assert positions.ndim == 3, "mrope needs (3, B, S) positions"
        assert sum(sections) == half, (sections, half)
        parts, start = [], 0
        for i, sec in enumerate(sections):
            parts.append(positions[i].to(F32)[..., None] * inv_freq[start:start + sec])
            start += sec
        freqs = torch.cat(parts, dim=-1)  # (B, S, half)
    else:
        freqs = positions.to(F32)[..., None] * inv_freq  # (B, S, half)
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x):
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(x, cos, sin):
    """x: (B, S, H, D_rot_or_more); rotates the first cos.shape[-1] dims."""
    rot = cos.shape[-1]
    xr, xp = x[..., :rot], x[..., rot:]
    c = cos[:, :, None, :].float()
    s = sin[:, :, None, :].float()
    xf = xr.float()
    out = (xf * c + _rotate_half(xf) * s).to(x.dtype)
    if xp.shape[-1]:
        out = torch.cat([out, xp], dim=-1)
    return out


# ---------------------------------------------------------------------------
# attention core
# ---------------------------------------------------------------------------

def _block_attend(q, k, v, qpos, kpos, *, causal, window=None, softcap=None, valid_len=None):
    """q: (B, Sq, K, R, D); k/v: (B, Skv, K, D); qpos: (Sq,); kpos: (Skv,).

    Returns (B, Sq, K, R, D).  Scores and softmax in f32; a ``softcap``
    bounds the scores to ``softcap * tanh(s / softcap)`` before the mask.
    A ``window`` keeps the keys in ``(qpos - window, qpos]``.
    ``valid_len`` may be a scalar (one cache fill level for the whole batch)
    or a (B,) tensor (ragged paged decode: each row attends over its own
    prefix)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqkrd,bskd->bkrqs", q.float(), k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    mask = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > (qpos[:, None] - window)
    if valid_len is not None and getattr(valid_len, "ndim", 0) == 1:
        mask_b = mask[None] & (kpos[None, None, :] < valid_len[:, None, None])  # (B, Sq, Skv)
        s = s.masked_fill(~mask_b[:, None, None], NEG_INF)
    else:
        if valid_len is not None:
            mask &= kpos[None, :] < valid_len
        s = s.masked_fill(~mask, NEG_INF)
    w = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bkrqs,bskd->bqkrd", w, v)


def attention(
    q,
    k,
    v,
    *,
    causal: bool = True,
    window: "Optional[int]" = None,
    q_offset: int = 0,
    q_block: "Optional[int]" = None,
    valid_len=None,
    softcap: "Optional[float]" = None,
    impl: str = "auto",
):
    """GQA attention. q: (B, Sq, H, D); k/v: (B, Skv, K, D); H % K == 0.

    ``q_block``: the plain path takes queries in blocks of this size, so
    the peak score tensor is (B, H, q_block, Skv).  ``valid_len``: number
    of valid cache slots (decode), a scalar or a (B,) tensor of per-row
    prefixes (paged decode).  ``window``: each query sees the keys in
    ``(qpos - window, qpos]``.  ``softcap``: scores become ``softcap *
    tanh(s / softcap)`` before the mask.  ``impl``: ``auto`` sends
    self-attention on a CUDA tensor (causal or not, Sq == Skv from position
    0, no ``valid_len``, no window) through the flash kernel; the kernel has
    no softcap and no window (nor has the Pallas one), so a call with
    either takes the plain path.  ``ref`` keeps every case on the plain
    path."""
    if impl not in ("auto", "ref"):
        raise ValueError(f"impl={impl!r}: use auto or ref")
    B, Sq, H, D = q.shape
    if (impl == "auto" and q.is_cuda and q_offset == 0 and Sq == k.shape[1]
            and valid_len is None and softcap is None and window is None):
        return flash_attention(q, k, v, causal=causal)
    K = k.shape[2]
    qr = q.reshape(B, Sq, K, H // K, D)
    kpos = torch.arange(k.shape[1], device=q.device)
    qpos = q_offset + torch.arange(Sq, device=q.device)
    step = Sq if q_block is None else q_block
    blocks = [_block_attend(qr[:, i:i + step], k, v, qpos[i:i + step], kpos, causal=causal,
                            window=window, softcap=softcap, valid_len=valid_len)
              for i in range(0, Sq, step)]
    return torch.cat(blocks, dim=1).reshape(B, Sq, H, D)


def local_block_attention(q, k, v, *, window: int, q_offset: int = 0):
    """Sliding-window attention in O(S * window): queries in blocks of
    ``window`` attend to their own and the previous key block only (block 0
    to a zero block, masked).  Exact for window-limited causal attention
    when Sq == Skv and Sq % window == 0: the caller pads, and a length that
    is not a whole number of windows raises.  Plain PyTorch, one block at a
    time, so the peak score tensor is (B, K, R, window, 2 * window) f32."""
    B, S, H, D = q.shape
    K = k.shape[2]
    if S % window:
        raise ValueError(f"local_block_attention: length {S} is not a multiple of the "
                         f"window {window} (pad upstream)")
    qr = q.reshape(B, S // window, window, K, H // K, D)
    kr = k.reshape(B, S // window, window, K, D)
    vr = v.reshape(B, S // window, window, K, D)
    ar = torch.arange(window, device=q.device)
    blocks = []
    for i in range(S // window):
        kp = kr[:, i - 1] if i else torch.zeros_like(kr[:, 0])
        vp = vr[:, i - 1] if i else torch.zeros_like(vr[:, 0])
        kk = torch.cat([kp, kr[:, i]], dim=1)  # (B, 2w, K, D)
        vv = torch.cat([vp, vr[:, i]], dim=1)
        qpos = q_offset + i * window + ar
        kpos = q_offset + (i - 1) * window + torch.arange(2 * window, device=q.device)
        blocks.append(_block_attend(qr[:, i], kk, vv, qpos, kpos, causal=True, window=window))
    return torch.stack(blocks, dim=1).reshape(B, S, H, D)


# ---------------------------------------------------------------------------
# attention block (projections) and MLPs
# ---------------------------------------------------------------------------

def qkv_proj(cfg, p, x):
    """x: (B, S, D) -> q (B, S, H, hd), k/v (B, S, K, hd), in x's dtype."""
    B, S, _ = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q = torch.matmul(x, p["wq"])
    k = torch.matmul(x, p["wk"])
    v = torch.matmul(x, p["wv"])
    if cfg.attn_qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q.reshape(B, S, H, hd), k.reshape(B, S, K, hd), v.reshape(B, S, K, hd)


def out_proj(cfg, p, o):
    B, S = o.shape[:2]
    y = torch.matmul(o.reshape(B, S, -1), p["wo"])
    if cfg.attn_out_bias:
        y = y + p["bo"]
    return y


def mlp(cfg, p, x):
    if cfg.mlp_type in ("swiglu", "geglu"):
        g = torch.matmul(x, p["wi_gate"])
        u = torch.matmul(x, p["wi_up"])
        if cfg.mlp_bias:
            g, u = g + p["bi_gate"], u + p["bi_up"]
        # jax.nn.gelu is the tanh approximation by default
        act = F.silu(g) if cfg.mlp_type == "swiglu" else F.gelu(g, approximate="tanh")
        h = act * u
    else:
        h = torch.matmul(x, p["wi"])
        if cfg.mlp_bias:
            h = h + p["bi"]
        h = F.gelu(h, approximate="tanh")
    y = torch.matmul(h, p["wo"])
    if cfg.mlp_bias:
        y = y + p["bo"]
    return y


# ---------------------------------------------------------------------------
# embeddings / unembedding
# ---------------------------------------------------------------------------

def embed(cfg, p, tokens):
    return p["table"][tokens]


def unembed(cfg, p, x):
    """f32 logits; bf16 operands are widened exactly, so the products and
    their sums are f32 as in the reference."""
    w = p["table"].T if cfg.tie_embeddings else p["unembed"]
    return torch.matmul(x.float(), w.float())


# ---------------------------------------------------------------------------
# KV cache helpers (contiguous per-layer cache, ring buffer for SWA)
# ---------------------------------------------------------------------------

def cache_update(ck, cv, k_new, v_new, pos: int, *, ring: "Optional[int]" = None):
    """Insert (B, s, K, D) new keys/values at slot ``pos`` (``ring``: a
    sliding-window ring of that length, slot ``pos % ring``).  Updates
    ``ck`` and ``cv`` IN PLACE (the reference returns new arrays) and
    returns them."""
    s = k_new.shape[1]
    slot = pos if ring is None else pos % ring
    ck[:, slot:slot + s] = k_new.to(ck.dtype)
    cv[:, slot:slot + s] = v_new.to(cv.dtype)
    return ck, cv


def decode_attend(cfg, q, ck, cv, pos: int, *, window: "Optional[int]" = None):
    """One-token attention against a cache. q: (B, 1, H, D); cache (B, S,
    K, D); slots past ``pos`` are masked.  Plain math: the flash kernel's
    causal mask counts query positions from 0.  With ``window`` the cache is
    a ring: every resident entry is in the window and in the past, so only
    the ``min(pos + 1, ring)`` written slots count."""
    if window is None:
        return attention(q, ck, cv, causal=True, q_offset=pos, valid_len=pos + 1)
    return attention(q, ck, cv, causal=False, valid_len=min(pos + 1, ck.shape[1]))


# ---------------------------------------------------------------------------
# paged KV helpers: the model side of the paging contract
# ---------------------------------------------------------------------------

def page_scatter(kp, vp, k_new, v_new, tables, positions):
    """Scatter one decode-step token per row into a page slab, IN PLACE
    (an index_put on the slab's device; the reference returns new slabs).

    kp/vp: (N, P, K, D) slabs of ONE layer (views of a folded slab write
    through); k_new/v_new: (B, 1, K, D); tables: (B, M) page tables;
    positions: (B,), the token's slot, i.e. the row's current length
    (token ``t`` lives at ``pages[table[b, t // P], t % P]``).  Returns
    (kp, vp)."""
    P = kp.shape[1]
    pos = positions.long()
    page = tables.gather(1, (pos // P)[:, None])[:, 0].long()
    slot = pos % P
    kp.index_put_((page, slot), k_new[:, 0].to(kp.dtype))
    vp.index_put_((page, slot), v_new[:, 0].to(vp.dtype))
    return kp, vp


def page_gather(pages, tables):
    """(N, P, K, D) slab + (B, M) table -> (B, M*P, K, D) contiguous cache,
    slot ``t`` holding token ``t`` of the row (stale slots past the length
    included: they are masked downstream)."""
    _, P, K, D = pages.shape
    B, M = tables.shape
    return pages[tables.long()].reshape(B, M * P, K, D)


def paged_decode_attend(q, kp, vp, tables, lengths, *, impl: str = "auto"):
    """One-token GQA attention against paged KV.

    q: (B, 1, H, D); kp/vp: (N, P, K, D); tables: (B, M) int32; lengths:
    (B,) int32, the tokens already resident EXCLUDING the one scattered
    this step, so rows attend over ``lengths + 1`` slots.  A CUDA tensor
    goes through the paged-attention kernel (q cast to the slab's dtype and
    back); a CPU tensor, or ``impl="ref"``, through ``page_gather`` and the
    plain ``attention``, bit-equal to the padded ``decode_attend`` when the
    oracle's cache is ``tables.shape[1] * P`` wide."""
    if impl not in ("auto", "ref"):
        raise ValueError(f"impl={impl!r}: use auto or ref")
    if impl == "auto" and q.is_cuda:
        o = paged_attention(q[:, 0].to(kp.dtype), kp, vp, tables, lengths + 1)
        return o[:, None].to(q.dtype)
    kc = page_gather(kp, tables)
    vc = page_gather(vp, tables)
    return attention(q, kc, vc, causal=False, valid_len=lengths + 1, impl="ref")


def ring_gather(pages, tables, positions, ring: int):
    """Rebuild a sliding-window ring cache (B, ring, K, D) from paged
    full-history KV.  Slot ``s`` of a ring written by ``cache_update(...,
    ring=ring)`` holds the newest token ``p <= pos`` with ``p % ring == s``,
    that is ``p = pos - ((pos - s) % ring)``; a slot not written yet
    (``p < 0``) is clamped to token 0 and masked by the caller's
    ``valid_len = min(pos + 1, ring)``, as the oracle masks its zero slots.
    Reads no value on the host: the ring length comes from the caller."""
    P = pages.shape[1]
    pos = positions.long()[:, None]
    s = torch.arange(ring, device=pages.device)
    p = torch.clamp(pos - torch.remainder(pos - s, ring), min=0)  # (B, ring)
    page = tables.long().gather(1, p // P)
    return pages[page, p % P]


def paged_ring_attend(q, kp, vp, tables, positions, *, ring: int):
    """Sliding-window one-token attention against paged KV: the ring the
    oracle's cache would hold at ``pos = positions`` (the new token already
    scattered), then the same windowed attend, per row bit-equal to
    ``decode_attend(..., window=w)``."""
    kc = ring_gather(kp, tables, positions, ring)
    vc = ring_gather(vp, tables, positions, ring)
    valid = torch.clamp(positions + 1, max=ring)
    return attention(q, kc, vc, causal=False, valid_len=valid)
