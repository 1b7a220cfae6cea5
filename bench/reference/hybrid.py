"""Plain PyTorch reference of Hymba's hybrid-head LM [arXiv:2411.13676].

Learned meta tokens ahead of the prompt; in every block attention heads and
Mamba-2 (SSD) heads read the same normed input, and their outputs, each
RMS-normed and scaled, are averaged into the residual, followed by a SwiGLU
MLP.  Attention is causal over a sliding window (keys in ``(q - window,
q]``) except in the global layers, which see the whole prefix; a layer
that does not begin a K/V group (``kv_share_group``) reuses its group
leader's keys and values.  The SSM runs its causal depthwise conv, then the
recurrence h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T, y_t = C_t h_t + D x_t
(computed in chunks, which is the same sum), the gate y * silu(z) and an
RMS norm.  Positions (RoPE) count the meta tokens.

Nothing of the program is imported; the weights are the benchmark's, made
from the seed in the layout the served model takes (a list of per-layer
dicts).  ``dense.py`` beside this file supplies the shared arithmetic.
"""
from __future__ import annotations

import importlib.util
import math
import sys
from pathlib import Path

import torch
import torch.nn.functional as F


def _sibling(name: str):
    mod_name = f"bench_reference_{name}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, Path(__file__).with_name(f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


_d = _sibling("dense")
F32 = torch.float32
mm, norm, rope, attend, mlp, unembed_weight = (_d.mm, _d.norm, _d.rope, _d.attend, _d.mlp,
                                              _d.unembed_weight)


def _hd(a):
    return a.get("head_dim") or a["d_model"] // a["num_heads"]


def is_global(a, l: int) -> bool:
    return l in tuple(a.get("global_attn_layers") or ())


def kv_producer(a, l: int) -> int:
    g = int(a.get("kv_share_group") or 1)
    if is_global(a, l) or g <= 1:
        return l
    base = l - (l % g)
    return l if is_global(a, base) else base


def ssm_dims(a):
    s = a["ssm"]
    di = s["expand"] * a["d_model"]
    return di, di // s["head_dim"], s["head_dim"], s["n_groups"], s["d_state"], s["d_conv"]


def _a_log(shape, gen, device):
    return torch.log(torch.arange(1, shape[0] + 1, dtype=F32, device=device))


def _dt_bias(shape, gen, device):
    """The inverse softplus of a log-uniform draw on [1e-3, 1e-1]."""
    u = torch.rand(shape, generator=gen, device=device, dtype=F32)
    dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
    return torch.log(torch.expm1(dt))


def layout(a):
    d, H, K, hd, f, V = (a["d_model"], a["num_heads"], a["num_kv_heads"], _hd(a), a["d_ff"],
                         a["vocab_size"])
    di, Hs, P, G, N, W = ssm_dims(a)
    conv_dim = di + 2 * G * N
    s = 1.0 / math.sqrt(d)
    emb = {"table": ((V, d), 0.02)}
    if not a.get("tie_embeddings"):
        emb["unembed"] = ((d, V), s)
    layers = []
    for l in range(a["num_layers"]):
        attn = {"wq": ((d, H * hd), s)}
        if kv_producer(a, l) == l:
            attn.update({"wk": ((d, K * hd), s), "wv": ((d, K * hd), s)})
        attn["wo"] = ((H * hd, d), 1 / math.sqrt(H * hd))
        layers.append({
            "ln1": _d.norm_layout(a), "attn": attn,
            "fuse_attn": ((d,), "ones"), "fuse_ssm": ((d,), "ones"),
            "ln2": _d.norm_layout(a),
            "mlp": {"wi_gate": ((d, f), s), "wi_up": ((d, f), s), "wo": ((f, d), 1 / math.sqrt(f))},
            "ssm": {"w_z": ((d, di), s), "w_xbc": ((d, conv_dim), s), "w_dt": ((d, Hs), s),
                    "conv_w": ((W, conv_dim), 1 / math.sqrt(W)), "conv_b": ((conv_dim,), "zeros"),
                    "A_log": ((Hs,), _a_log), "D": ((Hs,), "ones"), "dt_bias": ((Hs,), _dt_bias),
                    "norm_scale": ((di,), "ones"), "w_out": ((di, d), 1 / math.sqrt(di))},
        })
    return {"embed": emb, "meta": ((a["meta_tokens"], d), 0.02), "layers": layers,
            "final_norm": _d.norm_layout(a)}


def make_params(a: dict, seed: int, device, dtype=F32):
    return _d.build(layout(a), seed, device, dtype)


def rmsnorm(x, w, eps):
    x = x.float()
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def ssd(x, dt, A, Bm, Cm, chunk: int = 64):
    """y_t = C_t h_t with h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T from
    h_{-1} = 0, in chunks: x (B, S, H, P), dt (B, S, H), A (H,), Bm/Cm (B, S,
    G, N) -> y (B, S, H, P)."""
    Bsz, S, H, P = x.shape
    R = H // Bm.shape[2]
    Bh = Bm.repeat_interleave(R, dim=2)
    Ch = Cm.repeat_interleave(R, dim=2)
    N = Bh.shape[-1]
    h = torch.zeros(Bsz, H, N, P, dtype=F32, device=x.device)
    ys = []
    for c0 in range(0, S, chunk):
        xc, dtc, Bc, Cc = x[:, c0:c0 + chunk], dt[:, c0:c0 + chunk], Bh[:, c0:c0 + chunk], \
            Ch[:, c0:c0 + chunk]
        Lc = xc.shape[1]
        cum = torch.cumsum(dtc * A, dim=1)  # (B, L, H)
        seg = cum[:, :, None, :] - cum[:, None, :, :]  # (B, i, j, H)
        causal = torch.tril(torch.ones(Lc, Lc, dtype=torch.bool, device=x.device))
        decay = torch.exp(seg.masked_fill(~causal[None, :, :, None], float("-inf")))
        w = torch.einsum("bihn,bjhn->bijh", Cc, Bc) * decay * dtc[:, None, :, :]
        y = torch.einsum("bijh,bjhp->bihp", w, xc)
        y = y + torch.einsum("bihn,bhnp->bihp", Cc * torch.exp(cum)[..., None], h)
        tail = torch.exp(cum[:, -1:, :] - cum) * dtc  # (B, L, H)
        h = torch.exp(cum[:, -1])[:, :, None, None] * h + torch.einsum(
            "bjhn,bjhp->bhnp", Bc * tail[..., None], xc)
        ys.append(y)
    return torch.cat(ys, dim=1)


def ssm_mixer(a, p, h, precision):
    di, Hs, P, G, N, W = ssm_dims(a)
    B, S, _ = h.shape
    z = mm(h, p["w_z"], precision)
    raw = mm(h, p["w_xbc"], precision)
    dt_raw = mm(h, p["w_dt"], precision)
    cw = p["conv_w"].float()
    pad = F.pad(raw, (0, 0, W - 1, 0))
    conv = sum(pad[:, j:j + S] * cw[j] for j in range(W)) + p["conv_b"].float()
    xbc = F.silu(conv)
    xs = xbc[..., :di].reshape(B, S, Hs, P)
    Bm = xbc[..., di:di + G * N].reshape(B, S, G, N)
    Cm = xbc[..., di + G * N:].reshape(B, S, G, N)
    dt = F.softplus(dt_raw + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    y = ssd(xs, dt, A, Bm, Cm) + xs * p["D"].float()[:, None]
    y = rmsnorm(y.reshape(B, S, di) * F.silu(z), p["norm_scale"], a["norm_eps"])
    return mm(y, p["w_out"], precision)


def hidden(a, params, tokens, precision: str = "f32"):
    """Final-normed hidden states (B, T, D) f32 of ``tokens`` (B, T), the
    meta positions dropped."""
    H, K, hd, M = a["num_heads"], a["num_kv_heads"], _hd(a), a["meta_tokens"]
    emb = params["embed"]["table"][tokens.long()].float()
    B = emb.shape[0]
    x = torch.cat([params["meta"].float()[None].expand(B, -1, -1), emb], dim=1)
    S = x.shape[1]
    pos = torch.arange(S, device=x.device)
    shared = None
    for l, lp in enumerate(params["layers"]):
        h = norm(a, x, lp["ln1"])
        y_ssm = ssm_mixer(a, lp["ssm"], h, precision)
        at = lp["attn"]
        q = rope(mm(h, at["wq"], precision).view(B, S, H, hd), pos, a["rope_theta"])
        if "wk" in at:
            k = rope(mm(h, at["wk"], precision).view(B, S, K, hd), pos, a["rope_theta"])
            v = mm(h, at["wv"], precision).view(B, S, K, hd)
            shared = (k, v)
        k, v = shared
        o = attend(q, k, v, window=None if is_global(a, l) else a["sliding_window"])
        y_attn = mm(o.reshape(B, S, H * hd), at["wo"], precision)
        x = x + 0.5 * (rmsnorm(y_attn, lp["fuse_attn"], a["norm_eps"])
                       + rmsnorm(y_ssm, lp["fuse_ssm"], a["norm_eps"]))
        x = x + mlp(a, lp["mlp"], norm(a, x, lp["ln2"]), precision)
    return norm(a, x, params["final_norm"])[:, M:]


def logits(a, params, tokens, positions, precision: str = "f32"):
    """f32 logits of one sequence ``tokens`` (S,) at content ``positions``."""
    h = hidden(a, params, tokens[None], precision)[0, positions]
    return mm(h, unembed_weight(a, params), precision)
