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
* Training: ``xent_loss`` is the reference's f32 cross-entropy;
  ``remat_call`` maps the reference's remat policies (none, full, dots)
  to ``torch.utils.checkpoint``; ``unstack`` splits stacked layer params
  so their gradients are stacked once.  Under grad the flash kernel
  computes attention's forward and its backward differentiates the plain
  path (``kernels._autograd``).
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.distribution.sharding import (axis_rules, constrain, current_mesh,
                                                current_rules, from_groups, make_groups,
                                                on_local_shards, per_rank, place_like,
                                                reduce_grad_once, to_groups)
from repro_torch.kernels._autograd import kernel_with_plain_grad
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.pytree import tree_flatten, tree_unflatten

F32 = torch.float32
NEG_INF = -1e30
# The flash kernel's backward recomputes the plain attention in query blocks
# of this size, so its peak score tensor is (B, H, GRAD_Q_BLOCK, Skv).
GRAD_Q_BLOCK = 512
# Under a mesh the flash kernel runs on local shards of batch rows and of
# heads (GQA: a rank's query heads use its own kv heads when both shard
# evenly), the dims of q, k, v and the output (B, S, H, D) attention treats
# independently.
ATTENTION_SHARD_DIMS = {"batch": ((0, 0, 0), (0,)), "heads": ((2, 2, 2), (2,))}


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

def unstack(tree, n: int):
    """A tree of leaves stacked on a leading axis of ``n`` (a model's layer
    params) -> n trees: one ``unbind`` a leaf, whose backward stacks the
    gradients of the n parts once."""
    leaves, treedef = tree_flatten(tree)
    cols = [torch.unbind(t) for t in leaves]
    return [tree_unflatten(treedef, [c[i] for c in cols]) for i in range(n)]


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
# logical sharding names (``distribution.sharding`` maps them onto a mesh)
# ---------------------------------------------------------------------------

def norm_specs(cfg):
    if cfg.norm_type in ("rmsnorm", "layernorm_nobias"):
        return {"scale": ("p_none",)}
    if cfg.norm_type == "layernorm":
        return {"scale": ("p_none",), "bias": ("p_none",)}
    return {}


def attn_specs(cfg):
    s = {"wq": ("p_embed", "p_heads"), "wk": ("p_embed", "p_kv_heads"),
         "wv": ("p_embed", "p_kv_heads"), "wo": ("p_heads", "p_embed")}
    if cfg.attn_qkv_bias:
        s.update({"bq": ("p_heads",), "bk": ("p_kv_heads",), "bv": ("p_kv_heads",)})
    if cfg.attn_out_bias:
        s["bo"] = ("p_none",)
    return s


def mlp_specs(cfg):
    if cfg.mlp_type in ("swiglu", "geglu"):
        s = {"wi_gate": ("p_embed", "p_mlp"), "wi_up": ("p_embed", "p_mlp"),
             "wo": ("p_mlp", "p_embed")}
        if cfg.mlp_bias:
            s.update({"bi_gate": ("p_mlp",), "bi_up": ("p_mlp",), "bo": ("p_none",)})
        return s
    s = {"wi": ("p_embed", "p_mlp"), "wo": ("p_mlp", "p_embed")}
    if cfg.mlp_bias:
        s.update({"bi": ("p_mlp",), "bo": ("p_none",)})
    return s


def embed_specs(cfg):
    s = {"table": ("p_vocab", "p_embed")}
    if not cfg.tie_embeddings:
        s["unembed"] = ("p_embed", "p_vocab")
    return s


def stack_specs(tree):
    """Layer specs gain a leading "layers" dim (params stacked over layers)."""
    if isinstance(tree, dict):
        return {k: stack_specs(v) for k, v in tree.items()}
    return ("layers",) + tree


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

# a norm over a last dim sharded over the mesh (the SSM's gated norm over
# d_inner): rows are independent; a rank's sum of squares over its columns is
# its part of the row's sum, and each rank scales its own columns
_NORM_SUMSQ_DIMS = {"batch": ((0,), (0,)), "seq": ((1,), (1,)), "cols": ((2,), ("sum",))}
_NORM_SCALE_DIMS = {"batch": ((0, 0, None), (0,)), "seq": ((1, 1, None), (1,)),
                    "cols": ((2, None, 0), (2,))}


def _sum_sq(x):
    xf = x.float()
    return torch.sum(xf * xf, dim=-1)


def _rms_scale(x, r, w):
    return (x.float() * r[..., None] * w.float()).to(x.dtype)


def _last_dim_sharded(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor) and x.ndim == 3 and any(q.is_shard(2) for q in x.placements)


def rmsnorm(x, w, eps: float):
    """RMSNorm over the last dim in f32.  Under a mesh that shards the last
    dim (B, S, C), each rank's sum of squares over its own columns, summed
    over the ranks (an all-reduce of (B, S)), scales its columns, as the
    reference's GSPMD partitions the reduction: the rows are never
    gathered."""
    if _last_dim_sharded(x):
        ss = constrain(on_local_shards(_sum_sq, (x,), _NORM_SUMSQ_DIMS), "batch", "seq")
        r = torch.rsqrt(ss / x.shape[-1] + eps)
        return on_local_shards(_rms_scale, (x, r, w), _NORM_SCALE_DIMS)
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
    path.  Under grad the flash kernel computes the forward and the
    backward differentiates the plain path in query blocks of
    ``GRAD_Q_BLOCK`` (``kernels._autograd``).  Under head groups
    (``group_heads``) q, k, v and the result are in the group layout, and
    each rank runs its group's heads."""
    if impl not in ("auto", "ref"):
        raise ValueError(f"impl={impl!r}: use auto or ref")
    B, Sq, H, D = q.shape
    k, v = _kv_for_query_heads(q, k, v)
    if (impl == "auto" and q.is_cuda and q_offset == 0 and Sq == k.shape[1]
            and valid_len is None and softcap is None and window is None):
        return kernel_with_plain_grad(
            functools.partial(flash_attention, causal=causal),
            functools.partial(attention, causal=causal, q_block=GRAD_Q_BLOCK, impl="ref"),
            q, k, v, shard_dims=ATTENTION_SHARD_DIMS)
    plain = functools.partial(_plain_attention, causal=causal, window=window, q_offset=q_offset,
                              q_block=q_block, valid_len=valid_len, softcap=softcap)
    if isinstance(valid_len, torch.Tensor):  # per-row lengths: the paged decode, no mesh
        return plain(q, k, v)
    # under a mesh on the local shards of batch and heads, as the kernel
    # runs: DTensor would flatten two sharded dims into the products' batch
    # dim (torch 2.11's DTensor refuses to)
    return on_local_shards(plain, (q, k, v), ATTENTION_SHARD_DIMS)


# a rank's kv heads, by index, from keys or values it holds whole
_TAKE_HEADS_DIMS = {"batch": ((0, None), (0,)), "seq": ((1, None), (1,)),
                    "heads": ((None, 0), (2,))}


def _take_heads(t, idx):
    return t.index_select(2, idx)


def _kv_for_query_heads(q, k, v):
    """``k`` and ``v`` ready to run on each rank's own query heads.  Where
    the plan shards the query heads over a mesh dim whose ranks the kv
    heads are too few to share (so k and v are replicated along it), and
    each rank's query heads read one kv head, every rank takes that head
    (no communication): k and v become (B, S, n, D) over the n ranks,
    sharded like q's heads, so query head j still reads its own kv head
    j // (H / K).  Otherwise (no mesh, kv heads sharded with the query
    heads, or a rank's query heads spanning kv heads) k and v as they
    are: ``attention`` then runs on the local shards or on gathered
    heads."""
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

    if not (isinstance(q, DTensor) and isinstance(k, DTensor) and isinstance(v, DTensor)):
        return k, v
    H, K, mesh = q.shape[2], k.shape[2], q.device_mesh
    n, pl = 1, []
    for i, (a, b, c) in enumerate(zip(q.placements, k.placements, v.placements)):
        if a == Shard(2):
            if b != Replicate() or c != Replicate():
                return k, v
            n *= mesh.size(i)
        pl.append(Shard(0) if a == Shard(2) else Replicate())
    if n == 1 or K % n == 0 or H % n or (H // K) % (H // n):
        return k, v
    idx = torch.arange(n, device=q.device) * (H // n) // (H // K)  # rank r's kv head
    idx = distribute_tensor(idx, mesh, pl, src_data_rank=None)
    return (on_local_shards(_take_heads, (k, idx), _TAKE_HEADS_DIMS),
            on_local_shards(_take_heads, (v, idx), _TAKE_HEADS_DIMS))


# ---------------------------------------------------------------------------
# head groups: heads the model axis does not divide
# ---------------------------------------------------------------------------

def head_groups(t, n: int, rule: str = "heads"):
    """How the reference's GSPMD runs ``n`` heads that the plan's ``rule``
    puts on mesh dims whose m ranks do not divide n (``spec_for`` then
    drops the rule, so the plan holds them whole on every rank): in g =
    gcd(n, m) groups of m / g ranks, the ranks in mesh order, group j
    running heads [j n / g, (j + 1) n / g).  Returns (those mesh dims of
    ``t``'s mesh, m, g), or None without a mesh or the rule, where the rule
    divides n, where g is 1 (the heads then stay whole on every rank, as in
    the reference), or where the plan shards the sequence over those dims
    (decode over a cache whose slots they shard: flash decoding)."""
    from torch.distributed.tensor import DTensor

    rules = current_rules()
    r = rules.get(rule) if rules is not None else None
    if r is None or not isinstance(t, DTensor):
        return None
    mesh = t.device_mesh
    names = tuple(mesh.mesh_dim_names)
    axes = (r,) if isinstance(r, str) else tuple(r)
    seq = rules.get("seq")
    if seq is not None and set(axes) & set((seq,) if isinstance(seq, str) else seq):
        return None
    dims = [names.index(a) for a in axes if a in names and mesh.size(names.index(a)) > 1]
    m = math.prod(mesh.size(i) for i in dims)
    g = math.gcd(n, m)
    if n % m == 0 or g == 1:
        return None
    return dims, m, g


@functools.lru_cache(maxsize=64)
def _head_reads(n: int, k: int, hd: int, g: int):
    """The columns each group reads of the query heads' projection and of
    the kv heads', the kv heads its n / g query heads read (GQA)."""
    hg, r = n // g, n // k
    q = tuple(tuple(range(j * hg * hd, (j + 1) * hg * hd)) for j in range(g))
    kv = tuple(tuple(range(j * hg // r * hd, (j * hg // r + max(hg // r, 1)) * hd))
               for j in range(g))
    return q, kv


def _head_layouts(cfg, t):
    """The group layouts (``distribution.sharding.make_groups``) of the
    query and kv heads' columns under head groups, or None, also where a
    group's query heads read part of a kv head's query heads and the next
    group the rest (no config does)."""
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    grp = head_groups(t, H)
    if grp is None or (H * hd) % grp[1]:
        return None
    dims, m, g = grp
    hg, r = H // g, H // K
    if hg % r and r % hg:
        return None
    q, kv = _head_reads(H, K, hd, g)
    return (make_groups(t.device_mesh, dims, g, q, H * hd, t.device),
            make_groups(t.device_mesh, dims, g, kv, K * hd, t.device))


def group_heads(cfg, t, kind: str):
    """``t`` (B, S, n * hd), the projection of the query heads (``kind``
    "q", n = H) or of the kv heads ("kv", n = K), split into heads.  Under
    head groups (``head_groups``) in the group layout: each rank the heads
    its group runs, or the kv heads they read, (B, S, m n', hd) sharded
    over the m ranks, taken from the projection gathered over them (as the
    reference's GSPMD gathers it); its backward takes each rank's own
    columns of its group's whole gradient (``to_groups``), which needs no
    sum over the ranks."""
    n = cfg.num_heads if kind == "q" else cfg.num_kv_heads
    lay = _head_layouts(cfg, t)
    if lay is None:
        return split_heads(t, n, cfg.hd)
    out = to_groups(t, 2, lay[0 if kind == "q" else 1])
    return split_heads(out, out.shape[2] // cfg.hd, cfg.hd)


def whole_heads(cfg, t):
    """``t`` (B, S, K', hd), kv heads from ``group_heads``, as the K heads,
    whole on every rank, as the plan places heads it cannot divide (a
    prefill's KV cache): gathered over the group ranks.  ``t`` itself when
    it is not in the group layout."""
    if t.shape[2] == cfg.num_kv_heads:
        return t
    lay = _head_layouts(cfg, t)[1]
    return split_heads(from_groups(merge_heads(t, 2), 2, lay, whole=True), cfg.num_kv_heads,
                       cfg.hd)


def _plain_attention(q, k, v, *, causal, window, q_offset, q_block, valid_len, softcap):
    B, Sq, H, D = q.shape
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
    time, so the peak score tensor is (B, K, R, window, 2 * window) f32.
    Under a mesh on the local shards of batch and heads (or head groups),
    as ``attention``."""
    k, v = _kv_for_query_heads(q, k, v)
    return on_local_shards(functools.partial(_local_block_attention, window=window,
                                             q_offset=q_offset), (q, k, v), ATTENTION_SHARD_DIMS)


def _local_block_attention(q, k, v, *, window: int, q_offset: int):
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

# Splitting or merging a dim of a ``DTensor`` is a view, which ``DTensor``
# can take only of shards that fall on whole slices of the new dims, and
# never of an uneven shard (one its own ops may leave, forward or backward).
# These helpers gather what cannot be viewed first, in the forward and, for
# the gradient, in the backward (the reference's GSPMD reshards the same
# way).  A plain tensor is reshaped as is.

def _gathered(t, dims=()):
    """``t`` with the mesh dims sharding any of ``dims``, and every uneven
    shard, gathered."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(t, DTensor):
        return t
    mesh, pl = t.device_mesh, list(t.placements)
    keep = [q if not q.is_shard() or (q.dim not in dims and t.shape[q.dim] % mesh.size(i) == 0)
            else Replicate() for i, q in enumerate(pl)]
    return t if keep == pl else t.redistribute(mesh, keep)


def _splittable(t, n: int, d: int):
    """``t`` ready to have dim ``d`` split into (n, -1): its shards along
    ``d`` kept only where their ranks divide n (or n is 1)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(t, DTensor):
        return t
    ranks = 1
    for i, q in enumerate(t.placements):
        ranks *= t.device_mesh.size(i) if q.is_shard(d) else 1
    return _gathered(t, () if n == 1 or n % ranks == 0 else (d,))


class _GradThrough(torch.autograd.Function):
    """Identity whose backward passes the gradient through ``fix``, its
    local shard made contiguous: the view that follows in the backward (a
    matmul's, a reshape's) is then always a view (torch 2.11's ``DTensor``
    dispatches a strided gradient's as ``view``, which fails, and its
    ``contiguous()`` looks at the global strides only)."""

    @staticmethod
    def forward(ctx, t, fix):
        ctx.fix = fix
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        g = ctx.fix(g)
        if not g._local_tensor.is_contiguous():
            g = g.clone(memory_format=torch.contiguous_format)
        return g, None


def stacked_like(t, n: int):
    """An uninitialised (n, *t.shape) buffer of ``t``'s dtype, to hold ``n``
    tensors like ``t`` stacked: under a mesh a ``DTensor`` placed as ``t``
    is along its dims, so each rank holds its own shard of every slice
    (``new_empty`` of a ``DTensor`` replicates it at its global shape)."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(t, DTensor):
        return t.new_empty((n, *t.shape))
    local = t.to_local()
    pl = [Shard(q.dim + 1) if q.is_shard() else q for q in t.placements]
    buf = local.new_empty((n, *local.shape))
    shape = (n, *t.shape)
    return DTensor.from_local(buf, t.device_mesh, pl, run_check=False, shape=shape,
                              stride=_contiguous(shape))


def split_heads(t, n: int, hd: int, dim: int = -1):
    """``t`` with dim ``dim`` (of n * hd) split into (n, hd)."""
    from torch.distributed.tensor import DTensor

    d = dim % t.ndim
    out = _splittable(t, n, d)
    out = out.reshape(*out.shape[:d], n, hd, *out.shape[d + 1:])
    if isinstance(t, DTensor) and t.requires_grad:  # the backward merges (n, hd) back
        out = _GradThrough.apply(out, lambda g: _gathered(g, (d + 1,)))
    return out


def merge_heads(t, dim: int):
    """``t`` with dims ``dim`` and ``dim + 1`` merged into one."""
    from torch.distributed.tensor import DTensor

    d = dim % t.ndim
    n = t.shape[d]
    out = _gathered(t, (d + 1,))
    out = out.reshape(*out.shape[:d], -1, *out.shape[d + 2:])
    if isinstance(t, DTensor) and t.requires_grad:  # the backward splits it into (n, -1)
        out = _GradThrough.apply(out, lambda g: _splittable(g, n, d))
    return out


def _linear_dims(nd: int) -> dict:
    """``on_local_shards``' dims of ``x @ w`` for an ``nd``-dim ``x`` and a
    2-dim ``w``: rows (batch, then position) independent, and so are the
    weight's columns; a contraction over a dim both shard gives each
    rank's part of the sum."""
    dims = {a: ((d, None), (d,)) for a, d in (("batch", 0), ("seq", 1)) if d < nd - 1}
    dims["in"] = ((nd - 1, 0), ("sum",))
    dims["out"] = ((None, 1), (nd - 1,))
    return dims


def _matmul(x, w):
    """``x @ w`` in the wider of their dtypes, as the reference's einsum
    promotes: an f32 sum with a bias against a bf16 weight runs in f32 with
    f32 partial sums (the narrower operand cast here, on the local shards,
    after any gather)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(dt), w.to(dt))


def linear(x, w):
    """``x @ w`` in the wider of their dtypes (``_matmul``).  Under a mesh
    on each rank's own rows and the weight's shards as the plan places
    them: a column-parallel weight gives the rank's columns, a row-parallel
    one (its input dim sharded with ``x``'s last) the rank's part of the
    sum (``Partial``), and an FSDP weight is gathered over the batch ranks,
    so its gradient is each rank's product of its own rows, summed over
    them.  ``DTensor``'s own plan may instead gather a whole weight or its
    gradient (torch 2.13 does, for OLMo-1B's train step) or compute work
    the plan gives another rank."""
    return on_local_shards(_matmul, (x, w), _linear_dims(x.ndim))


def projections(x, *ws):
    """``linear(x, w)`` for each of ``ws``: projections of one input (q, k
    and v; an MLP's gate and up), each a weight or a pair (f, w) for
    ``linear(f(x), w)``, f linear and keeping x's layout (``once_a_group``).
    Under a mesh their input gradients, each rank's share of a sum where
    the weights shard their columns, are added while still partial and
    reduced once (``reduce_grad_once``), as the reference's XLA sums them
    before its one all-reduce."""
    x = reduce_grad_once(x)
    dims = _linear_dims(x.ndim)
    out = []
    for w in ws:
        f, w = w if isinstance(w, tuple) else (None, w)
        out.append(on_local_shards(_matmul, (x if f is None else f(x), w), dims,
                                   partial_grads=True))
    return tuple(out)


def qkv_proj(cfg, p, x):
    """x: (B, S, D) -> q (B, S, H, hd), k/v (B, S, K, hd), in the wider of
    x's and the weights' dtypes; under head groups in the group layout
    (``group_heads``)."""
    q, k, v = projections(x, p["wq"], p["wk"], p["wv"])
    if cfg.attn_qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = constrain(group_heads(cfg, q, "q"), "batch", "seq", "heads", "head_dim")
    k = constrain(group_heads(cfg, k, "kv"), "batch", "seq", "kv_heads", "head_dim")
    v = constrain(group_heads(cfg, v, "kv"), "batch", "seq", "kv_heads", "head_dim")
    return q, k, v


def out_proj(cfg, p, o):
    """o (B, S, H, hd), or in the group layout of head groups, to (B, S,
    D): there each rank takes its own 1/m of o's columns, which lie in its
    group's heads (``from_groups``: no communication), and multiplies them
    by its rows of ``wo``, a ``Partial`` sum in which no term is twice."""
    grouped = o.shape[2] != cfg.num_heads
    o = merge_heads(o, 2)
    if grouped:
        o = from_groups(o, 2, _head_layouts(cfg, o)[0])
    y = constrain(linear(o, p["wo"]), "batch", "seq", "embed")
    return y + p["bo"] if cfg.attn_out_bias else y


def mlp(cfg, p, x):
    if cfg.mlp_type in ("swiglu", "geglu"):
        g, u = projections(x, p["wi_gate"], p["wi_up"])
        if cfg.mlp_bias:
            g, u = g + p["bi_gate"], u + p["bi_up"]
        g = constrain(g, "batch", "seq", "mlp")
        u = constrain(u, "batch", "seq", "mlp")
        # jax.nn.gelu is the tanh approximation by default
        act = F.silu(g) if cfg.mlp_type == "swiglu" else F.gelu(g, approximate="tanh")
        h = act * u
    else:
        h = linear(x, p["wi"])
        if cfg.mlp_bias:
            h = h + p["bi"]
        h = F.gelu(constrain(h, "batch", "seq", "mlp"), approximate="tanh")
    y = constrain(linear(h, p["wo"]), "batch", "seq", "embed")
    return y + p["bo"] if cfg.mlp_bias else y


# ---------------------------------------------------------------------------
# embeddings / unembedding
# ---------------------------------------------------------------------------

# rows of a lookup are independent; the table has none of them (gathered)
_EMBED_SHARD_DIMS = {"batch": ((0, None), (0,))}
# a vocab-parallel lookup: rows independent; over the vocab's ranks each
# rank's rows of the result (zero where a token is not among its rows) are its
# part of a sum
_EMBED_VOCAB_DIMS = {"vocab": ((None, 0, 0), ("sum",)), "batch": ((0, None, None), (0,))}


def _lookup(tokens, table):
    return table[tokens]


def _lookup_of_shard(tokens, table, vocab):
    """The rows of ``table`` (the ids ``vocab``, a contiguous range) at
    ``tokens``, zero where a token is not one of them; the backward adds
    into the table's own rows (``index_add``)."""
    local = tokens.long() - vocab[0]
    own = (local >= 0) & (local < vocab.shape[0])
    rows = table.index_select(0, local.clamp(0, vocab.shape[0] - 1).reshape(-1))
    return rows.reshape(*tokens.shape, -1).masked_fill(~own[..., None], 0)


def embed(cfg, p, tokens):
    """The table's rows at ``tokens``.  Under a mesh on each rank's own
    rows; with the table's vocab sharded, vocab-parallel, as the
    reference's GSPMD partitions ``jnp.take``: each rank looks the tokens
    up in its own rows, and the ranks' parts are summed (an all-reduce of
    (B, S, D)), so the table is gathered only over the batch ranks of an
    FSDP layout; its backward is each rank's plain ``index_add`` into its
    own rows.  An unsharded vocab is gathered as it is (``DTensor``'s
    strategy for the indexing's backward, ``index_put``, fails on torch
    2.11)."""
    from torch.distributed.tensor import DTensor, Shard

    table = p["table"]
    if isinstance(table, DTensor) and Shard(0) in table.placements:
        dims = [i for i, q in enumerate(table.placements) if q == Shard(0)]
        vocab = per_rank(torch.arange(table.shape[0], device=table.device), table.device_mesh,
                         dims)
        x = on_local_shards(_lookup_of_shard, (tokens, table, vocab), _EMBED_VOCAB_DIMS)
    else:
        x = on_local_shards(_lookup, (tokens, table), _EMBED_SHARD_DIMS)
    return constrain(x, "batch", "seq", "embed")


def table_rows(table, idx):
    """``table[idx]`` for an index every rank holds whole (positions).
    Under a mesh each rank looks the rows up in the table gathered, so they
    come back replicated: ``DTensor``'s own plan shards them over the
    model ranks, and every product after them would follow."""
    return on_local_shards(_lookup, (idx, table), {})


# rows (batch and position) of the unembedding are independent, and so are
# its vocab columns
_UNEMBED_SHARD_DIMS = {"batch": ((0, None), (0,)), "seq": ((1, None), (1,)),
                       "vocab": ((None, 1), (2,))}


def _logits(x, w):
    return torch.matmul(x.float(), w.float())


def unembed(cfg, p, x):
    """f32 logits; bf16 operands are widened exactly, so the products and
    their sums are f32 as in the reference.  Under a mesh on each rank's
    own rows and vocab columns, the weight gathered over the batch ranks:
    its gradient is then each rank's product of its own rows, summed over
    the batch ranks (``DTensor``'s plan for the product's backward gathers
    the whole batch's logits gradient instead).  Where the vocab is not
    sharded, every model rank computes the same logits, and the weight's
    gradient is split over those ranks by its rows (``_SplitWeightGrad``),
    as the reference's GSPMD splits it."""
    w = p["table"].T if cfg.tie_embeddings else p["unembed"]
    dims = _repeated_dims(x, w)
    if dims and torch.is_grad_enabled() and w.requires_grad:
        logits = _SplitWeightGrad.apply(x, w, dims)
    else:
        logits = on_local_shards(_logits, (x, w), _UNEMBED_SHARD_DIMS)
    return constrain(logits, "batch", "seq", "vocab")


def _repeated_dims(x, w) -> list:
    """The mesh dims over which ``x @ w`` would be computed whole on every
    rank (x's rows and w both whole there), where their ranks divide w's
    rows; none where x is sharded on its last dim."""
    from torch.distributed.tensor import DTensor

    if not (isinstance(x, DTensor) and isinstance(w, DTensor)) or any(
            q.is_shard(x.ndim - 1) or q.is_partial() for q in x.placements):
        return []
    mesh = x.device_mesh
    dims = [i for i in range(mesh.ndim) if mesh.size(i) > 1
            and x.placements[i].is_replicate() and w.placements[i].is_replicate()]
    return dims if dims and w.shape[0] % math.prod(mesh.size(i) for i in dims) == 0 else []


def _contiguous(shape) -> tuple:
    return tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))


def _rows_grad(x, g, rows, *, dtype):
    """The gradient of the weight's ``rows`` of ``x @ w``, from x's and the
    logits gradient's local rows."""
    xr = x.index_select(x.ndim - 1, rows).reshape(-1, rows.shape[0]).float()
    return torch.matmul(xr.T, g.reshape(-1, g.shape[-1])).to(dtype)


class _SplitWeightGrad(torch.autograd.Function):
    """The logits of x's own rows against w gathered whole (an FSDP gather
    over the batch ranks, kept for the backward, as the plain product keeps
    it); in the backward each rank of the mesh dims ``dims``, where the
    product repeats, computes the gradient of its own block of w's rows
    only, a part of a sum over x's row ranks, and the blocks are laid out
    as w is."""

    @staticmethod
    def forward(ctx, x, w, dims):
        from torch.distributed.tensor import DTensor, Replicate

        mesh = x.device_mesh
        wl = w.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()
        rows = per_rank(torch.arange(w.shape[0], device=w.device), mesh, dims).to_local()
        xl = x.to_local()
        ctx.save_for_backward(xl, wl, rows)
        ctx.meta = (tuple(x.placements), tuple(w.placements), tuple(w.shape), tuple(dims),
                    x.dtype, mesh)
        y = _logits(xl, wl)
        shape = (*x.shape[:-1], w.shape[1])
        return DTensor.from_local(y, mesh, x.placements, run_check=False, shape=shape,
                                  stride=_contiguous(shape))

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor, Partial, Shard

        xl, wl, rows = ctx.saved_tensors
        xp, wp, wshape, dims, xdtype, mesh = ctx.meta
        gl = g.redistribute(mesh, xp).to_local()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            shape = (*g.shape[:-1], wshape[0])
            dx = DTensor.from_local(torch.matmul(gl, wl.float().T).to(xdtype), mesh, xp,
                                    run_check=False, shape=shape, stride=_contiguous(shape))
        if ctx.needs_input_grad[1]:
            part = _rows_grad(xl, gl, rows, dtype=wl.dtype)
            pl = [Shard(0) if i in dims else Partial() if q.is_shard() else q
                  for i, q in enumerate(xp)]
            dw = DTensor.from_local(part, mesh, pl, run_check=False, shape=wshape,
                                    stride=_contiguous(wshape)).redistribute(mesh, wp)
        return dx, dw, None


# rows (batch and position) of the cross-entropy are independent
_XENT_SHARD_DIMS = {"batch": ((0, 0), (0,)), "seq": ((1, 1), (1,))}


def _gold_logit(logits, labels):
    return torch.gather(logits, -1, labels[..., None].long())[..., 0]


# vocab-parallel cross-entropy: rows independent; over the vocab columns a
# rank's maximum, its sum of exponentials and its gold logit (a row's label
# lies in one shard; the others give 0) are combined by max and sum
_XENT_MAX_DIMS = {"batch": ((0,), (0,)), "seq": ((1,), (1,)), "vocab": ((2,), ("max",))}
_XENT_SUMEXP_DIMS = {"batch": ((0, 0), (0,)), "seq": ((1, 1), (1,)), "vocab": ((2, None), ("sum",))}
_XENT_VOCAB_DIMS = {"batch": ((0, 0, None), (0,)), "seq": ((1, 1, None), (1,)),
                    "vocab": ((2, None, 0), ("sum",))}


def _row_max(logits):
    return torch.amax(logits, dim=-1)


def _sum_exp(logits, m):
    return torch.sum(torch.exp(logits - m[..., None]), dim=-1)


def _gold_logit_of_shard(logits, labels, vocab):
    """The gold logit where the label is one of ``vocab`` (the ids whose
    columns ``logits`` holds, a contiguous range), else 0."""
    local = labels.long() - vocab[0]
    own = (local >= 0) & (local < vocab.shape[0])
    gold = torch.gather(logits, -1, local.clamp(0, vocab.shape[0] - 1)[..., None])[..., 0]
    return torch.where(own, gold, torch.zeros_like(gold))


def _vocab_sharded(logits) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(logits, DTensor) and any(q.is_shard(logits.ndim - 1)
                                               for q in logits.placements)


def xent_loss(logits, labels, mask=None):
    """Mean next-token cross-entropy in f32: logsumexp minus the gold
    logit; with ``mask``, the mask-weighted mean (at least 1 in the
    denominator).  Under a mesh, on each rank's own rows: with the vocab
    sharded, vocab-parallel (each rank's max, sum of exponentials and gold
    logit over its columns, combined over the vocab ranks), as the
    reference's GSPMD partitions the reductions, so no rank holds a row's
    whole vocab; otherwise the gold logit from whole vocab rows.
    ``DTensor``'s own gather backward would hold the gradient of the whole
    batch's logits on every rank."""
    logits = logits.float()
    if _vocab_sharded(logits):
        m = constrain(on_local_shards(_row_max, (logits.detach(),), _XENT_MAX_DIMS),
                      "batch", "seq")
        lse = torch.log(on_local_shards(_sum_exp, (logits, m), _XENT_SUMEXP_DIMS)) + m
        vocab = place_like(torch.arange(logits.shape[-1], device=logits.device), logits, "vocab")
        gold = on_local_shards(_gold_logit_of_shard, (logits, labels, vocab), _XENT_VOCAB_DIMS)
    else:
        logits = constrain(logits, "batch", "seq", None)
        lse = torch.logsumexp(logits, dim=-1)
        gold = on_local_shards(_gold_logit, (logits, labels), _XENT_SHARD_DIMS)
    nll = lse - gold
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


# ---------------------------------------------------------------------------
# rematerialization (the reference's jax.checkpoint policies)
# ---------------------------------------------------------------------------

REMATS = ("none", "full", "dots")
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """JAX's ``dots_with_no_batch_dims_saveable``: keep the outputs of the
    products without batch dims (``mm``/``addmm``: the projections),
    recompute the rest."""
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
    return create_selective_checkpoint_contexts(_dots_policy)


def remat_whole(remat: str) -> str:
    """The policy for a family whose reference checkpoints each layer whole
    under both ``full`` and ``dots`` (encdec, hybrid)."""
    if remat not in REMATS:
        raise ValueError(f"remat={remat!r}: use one of {REMATS}")
    return "none" if remat == "none" else "full"


def _under_rules(fn):
    """``fn`` run under the axis rules and mesh active now, wherever it is
    called: the autograd engine runs a CUDA tensor's backward, and so a
    checkpoint's recompute, on a thread of its own, where this thread's
    rules are not set (head groups would then lay the recompute out
    otherwise than the forward)."""
    rules, mesh = current_rules(), current_mesh()
    if rules is None:
        return fn

    def run(*args):
        with axis_rules(rules, mesh):
            return fn(*args)

    return run


def remat_call(remat: str, fn, *args):
    """``fn(*args)`` under the ``remat`` policy: ``none`` keeps every
    activation for the backward; ``full`` keeps the inputs and recomputes
    the rest in the backward (``jax.checkpoint``); ``dots`` also keeps the
    projections' outputs (selective checkpointing).  A kernel inside ``fn``
    launches again in each recompute.  The layers draw no random numbers,
    so the recompute does not stash and restore the RNG states (which a
    CUDA graph capture refuses: the elastic trainer captures the
    backward).  A recompute runs under the axis rules and mesh of the
    forward (``_under_rules``)."""
    if remat == "none":
        return fn(*args)
    fn = _under_rules(fn)
    if remat == "full":
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    if remat == "dots":
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                          context_fn=_dots_context)
    raise ValueError(f"remat={remat!r}: use one of {REMATS}")


# ---------------------------------------------------------------------------
# KV cache helpers (contiguous per-layer cache, ring buffer for SWA)
# ---------------------------------------------------------------------------

def cache_update(ck, cv, k_new, v_new, pos: int, *, ring: "Optional[int]" = None):
    """Insert (B, s, K, D) new keys/values at slot ``pos`` (``ring``: a
    sliding-window ring of that length, slot ``pos % ring``).  Updates
    ``ck`` and ``cv`` IN PLACE (the reference returns new arrays) and
    returns them.  Under a mesh whose plan shards the cache's slots, each
    rank writes one token where it holds its slot (a slice assignment on
    the ``DTensor`` would gather the cache)."""
    s = k_new.shape[1]
    slot = pos if ring is None else pos % ring
    if _slots_sharded(ck) and s == 1:
        kpos = torch.arange(ck.shape[1], device=ck.device)
        for c, new in ((ck, k_new), (cv, v_new)):
            on_local_shards(functools.partial(_write_slot, slot=slot), (c, new, kpos),
                            _SLOT_WRITE_DIMS)
        return ck, cv
    ck[:, slot:slot + s] = k_new.to(ck.dtype)
    cv[:, slot:slot + s] = v_new.to(cv.dtype)
    return ck, cv


# a one-token write into a cache (B, S, K, D) whose slots are sharded: rows
# and heads are independent, the slots the rank's own
_SLOT_WRITE_DIMS = {"batch": ((0, 0, None), (0,)), "heads": ((2, 2, None), (2,)),
                    "seq": ((1, None, 0), (1,))}


def _write_slot(c, new, kpos, *, slot: int):
    """Writes ``new`` (B, 1, K, D) IN PLACE at ``slot`` of ``c``, whose
    slots are ``kpos``, if one of them is ``slot``; else rewrites a slot
    with its own value."""
    i = torch.clamp(slot - kpos[:1], 0, c.shape[1] - 1)
    own = torch.any(kpos == slot)
    c.index_copy_(1, i, torch.where(own, new.to(c.dtype), c.index_select(1, i)))
    return c


def decode_attend(cfg, q, ck, cv, pos: int, *, window: "Optional[int]" = None):
    """One-token attention against a cache. q: (B, 1, H, D); cache (B, S,
    K, D); slots past ``pos`` are masked.  Plain math: the flash kernel's
    causal mask counts query positions from 0.  With ``window`` the cache is
    a ring: every resident entry is in the window and in the past, so only
    the ``min(pos + 1, ring)`` written slots count.  Under a mesh whose
    plan shards the cache's slots (flash decoding: the kv heads too few to
    share the model axis), each rank attends every query head to its own
    slots (``_slot_attend``); otherwise on the local shards of batch and
    heads (``attention``)."""
    valid = pos + 1 if window is None else min(pos + 1, ck.shape[1])
    if _slots_sharded(ck):
        return _slot_attend(q, ck, cv, valid)
    if window is None:
        return attention(q, ck, cv, causal=True, q_offset=pos, valid_len=valid)
    return attention(q, ck, cv, causal=False, valid_len=valid)


def cross_attend(q, k, v, *, impl: str = "auto"):
    """Non-causal attention of q (B, Sq, H, D) against every slot of k/v
    (B, S, K, D): cross-attention.  One token against a cache whose slots
    the plan shards (a decode's cross K/V, the kv heads too few to share
    the model axis): flash decoding on each rank's own slots
    (``_slot_attend``), so no collective moves the cache, as the
    reference's GSPMD partitions it; otherwise ``attention``."""
    if q.shape[1] == 1 and _slots_sharded(k):
        return _slot_attend(q, k, v, k.shape[1])
    return attention(q, k, v, causal=False, impl=impl)


def _slots_sharded(cache) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(cache, DTensor) and any(p.is_shard(1) for p in cache.placements)


# one-token attention over a cache whose slots are sharded: rows are
# independent; the scores keep the slots' sharding (their dim 4), over which
# a rank's maximum score, its sum of weights and its weighted values are
# combined by max and sum
_SLOT_SCORE_DIMS = {"batch": ((0, 0, None), (0,)), "seq": ((None, 1, 0), (4,))}
_SLOT_MAX_DIMS = {"batch": ((0,), (0,)), "seq": ((4,), ("max",))}
_SLOT_SUM_DIMS = {"batch": ((0, 0, 0), (0, 0)), "seq": ((4, 1, None), ("sum", "sum"))}
_SLOT_NORM_DIMS = {"batch": ((0, 0), (0,))}


def _slot_scores(q, k, kpos, *, valid):
    """(B, K, R, 1, s) f32 scores of q (B, 1, H, D) against the slots
    ``kpos`` of k (B, s, K, D), slots from ``valid`` on masked."""
    B, _, H, D = q.shape
    K = k.shape[2]
    s = torch.einsum("bqkrd,bskd->bkrqs", q.reshape(B, 1, K, H // K, D).float(), k.float())
    return (s * (1.0 / math.sqrt(D))).masked_fill(kpos >= valid, NEG_INF)


def _slot_max(s):
    return torch.amax(s, dim=-1)


def _slot_sums(s, v, m):
    w = torch.exp(s - m[..., None])
    return torch.sum(w, dim=-1), torch.einsum("bkrqs,bskd->bqkrd", w.to(v.dtype), v)


def _slot_normalize(o, total):
    B, _, K, R, D = o.shape
    return (o.float() / total.permute(0, 3, 1, 2)[..., None]).to(o.dtype).reshape(B, 1, K * R, D)


def _slot_attend(q, ck, cv, valid):
    """Flash decoding on each rank's own slots: the query gathered (one
    token), its scores against the rank's slots, their maximum combined
    over the slot ranks, then the weights' sum and the weighted values, so
    the cache is never gathered; the reference's GSPMD partitions the
    reductions the same way."""
    kpos = torch.arange(ck.shape[1], device=q.device)
    s = on_local_shards(functools.partial(_slot_scores, valid=valid), (q, ck, kpos),
                        _SLOT_SCORE_DIMS)
    m = on_local_shards(_slot_max, (s.detach(),), _SLOT_MAX_DIMS)
    total, o = on_local_shards(_slot_sums, (s, cv, m), _SLOT_SUM_DIMS)
    return on_local_shards(_slot_normalize, (o, total), _SLOT_NORM_DIMS)


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
