"""Plain PyTorch reference of a dense decoder-only LM (OLMo-1B's block):
pre-norm attention and MLP residuals, RoPE (rotate-half), causal softmax
attention, SwiGLU, tied or untied unembedding.  Nothing of the program is
imported; the weights it reads are the benchmark's, made here from the seed.

The param tree has the layout the served and trained model takes (layer
weights stacked on a leading axis), so one set of weights feeds both sides.

``precision`` selects the arithmetic of every product: ``"f32"`` (the
caller turns TF32 off) or ``"fp8"``, each operand rounded to float8 e4m3
with a per-tensor scale before an f32 product, the step below a bf16
compute that a later change could be tempted by.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

F32 = torch.float32
FP8_MAX = 448.0


def _hd(a):
    return a.get("head_dim") or a["d_model"] // a["num_heads"]


def norm_layout(a, lead=()):
    d = (*lead, a["d_model"])
    t = a["norm_type"]
    if t in ("rmsnorm", "layernorm_nobias"):
        return {"scale": (d, "ones")}
    if t == "layernorm":
        return {"scale": (d, "ones"), "bias": (d, "zeros")}
    return {}


def layout(a):
    """(shape, init) leaves: init is a normal's std, "ones" or "zeros";
    products at 1/sqrt(fan-in), the embedding at 0.02."""
    L, d, H, K, hd, f, V = (a["num_layers"], a["d_model"], a["num_heads"], a["num_kv_heads"],
                            _hd(a), a["d_ff"], a["vocab_size"])
    s = 1.0 / math.sqrt(d)
    emb = {"table": ((V, d), 0.02)}
    if not a.get("tie_embeddings"):
        emb["unembed"] = ((d, V), s)
    return {
        "embed": emb,
        "layers": {
            "ln1": norm_layout(a, (L,)),
            "attn": {"wq": ((L, d, H * hd), s), "wk": ((L, d, K * hd), s),
                     "wv": ((L, d, K * hd), s), "wo": ((L, H * hd, d), 1 / math.sqrt(H * hd))},
            "ln2": norm_layout(a, (L,)),
            "mlp": {"wi_gate": ((L, d, f), s), "wi_up": ((L, d, f), s),
                    "wo": ((L, f, d), 1 / math.sqrt(f))},
        },
        "final_norm": norm_layout(a),
    }


def build(tree, seed: int, device, dtype=F32):
    """The leaves of a layout tree from ``seed``: every normal leaf (its init
    a float, the std) a scaled view of ONE standard-normal draw on ``device``
    (a ``torch.Generator`` there), "ones" and "zeros" filled, and a callable
    init called as ``init(shape, generator, device)`` after the draw."""
    leaves = []

    def walk(t):
        if isinstance(t, dict):
            for k in t:
                walk(t[k])
        elif isinstance(t, list):
            for v in t:
                walk(v)
        elif isinstance(t[1], float):
            leaves.append(t)

    walk(tree)
    total = sum(math.prod(shape) for shape, _ in leaves)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    flat = torch.randn(total, generator=gen, device=device, dtype=F32)
    if dtype != F32:
        flat = flat.to(dtype)
    offsets = {}
    at = 0
    for leaf in leaves:
        n = math.prod(leaf[0])
        offsets[id(leaf)] = at
        at += n

    def make(t):
        if isinstance(t, dict):
            return {k: make(v) for k, v in t.items()}
        if isinstance(t, list):
            return [make(v) for v in t]
        shape, init = t
        if callable(init):
            return init(shape, gen, device).to(dtype)
        if isinstance(init, str):
            if init == "ones":
                return torch.ones(shape, dtype=dtype, device=device)
            if init == "zeros":
                return torch.zeros(shape, dtype=dtype, device=device)
            raise ValueError(init)
        at = offsets[id(t)]
        return flat[at:at + math.prod(shape)].view(shape).mul_(init)

    return make(tree)


def make_params(a: dict, seed: int, device, dtype=F32):
    return build(layout(a), seed, device, dtype)


# ---------------------------------------------------------------------------
# arithmetic
# ---------------------------------------------------------------------------

def fp8_round(x):
    """``x`` through float8 e4m3 and back, scaled so its largest magnitude
    maps to the format's largest; the gradient passes straight through the
    rounding to ``x``."""
    xf = x.float()
    with torch.no_grad():
        scale = FP8_MAX / xf.abs().amax().clamp(min=1e-12)
        q = (xf * scale).to(torch.float8_e4m3fn).float() / scale
    return xf + (q - xf).detach()


def mm(x, w, precision: str = "f32"):
    if precision == "fp8":
        return torch.matmul(fp8_round(x), fp8_round(w))
    return torch.matmul(x.float(), w.float())


def norm(a, x, p):
    t, eps = a["norm_type"], a["norm_eps"]
    x = x.float()
    if t == "rmsnorm":
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * p["scale"].float()
    mu = x.mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(((x - mu) ** 2).mean(-1, keepdim=True) + eps)
    if t in ("layernorm", "layernorm_nobias"):
        y = y * p["scale"].float()
    if t == "layernorm":
        y = y + p["bias"].float()
    return y


def rope(x, pos, theta: float):
    """Rotate-half RoPE over the whole head: x (B, S, H, D), pos (S,)."""
    D = x.shape[-1]
    half = D // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=F32, device=x.device) / half))
    ang = pos.float()[:, None] * inv[None]
    cos = torch.cat([ang.cos(), ang.cos()], -1)[None, :, None]
    sin = torch.cat([ang.sin(), ang.sin()], -1)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return x * cos + torch.cat([-x2, x1], -1) * sin


def attend(q, k, v, window=None):
    """Causal softmax attention (keys in ``(q - window, q]`` with a window);
    q (B, S, H, D), k/v (B, S, K, D), K dividing H."""
    B, S, H, D = q.shape
    R = H // k.shape[2]
    k = k.repeat_interleave(R, dim=2)
    v = v.repeat_interleave(R, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(D)
    i = torch.arange(S, device=q.device)
    mask = i[None, :] <= i[:, None]
    if window is not None:
        mask &= i[None, :] > i[:, None] - window
    s = s.masked_fill(~mask, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)


def mlp(a, p, x, precision):
    g = mm(x, p["wi_gate"], precision)
    u = mm(x, p["wi_up"], precision)
    act = F.silu(g) if a["mlp_type"] == "swiglu" else F.gelu(g, approximate="tanh")
    return mm(act * u, p["wo"], precision)


def unembed_weight(a, params):
    return params["embed"]["table"].T if a.get("tie_embeddings") else params["embed"]["unembed"]


def hidden(a, params, tokens, precision: str = "f32"):
    """Final-normed hidden states (B, S, D) f32 of ``tokens`` (B, S)."""
    L, H, K, hd = a["num_layers"], a["num_heads"], a["num_kv_heads"], _hd(a)
    x = params["embed"]["table"][tokens.long()].float()
    B, S, _ = x.shape
    pos = torch.arange(S, device=x.device)
    lay = params["layers"]
    for l in range(L):
        lp = {g: {n: w[l] for n, w in lay[g].items()} for g in lay}
        h = norm(a, x, lp["ln1"])
        q = mm(h, lp["attn"]["wq"], precision).view(B, S, H, hd)
        k = mm(h, lp["attn"]["wk"], precision).view(B, S, K, hd)
        v = mm(h, lp["attn"]["wv"], precision).view(B, S, K, hd)
        q, k = rope(q, pos, a["rope_theta"]), rope(k, pos, a["rope_theta"])
        o = attend(q, k, v).reshape(B, S, H * hd)
        x = x + mm(o, lp["attn"]["wo"], precision)
        x = x + mlp(a, lp["mlp"], norm(a, x, lp["ln2"]), precision)
    return norm(a, x, params["final_norm"])


def logits(a, params, tokens, positions, precision: str = "f32"):
    """f32 logits of one sequence ``tokens`` (S,) at ``positions`` (n,)."""
    h = hidden(a, params, tokens[None], precision)[0, positions]
    return mm(h, unembed_weight(a, params), precision)


def loss(a, params, tokens, labels, precision: str = "f32"):
    """Mean next-token cross-entropy in f32 over ``tokens``/``labels`` (B, S)."""
    z = mm(hidden(a, params, tokens, precision), unembed_weight(a, params), precision)
    return F.cross_entropy(z.reshape(-1, z.shape[-1]), labels.reshape(-1).long())
