"""Mamba-2 SSD (state-space duality) layer [arXiv:2405.21060] on PyTorch
(``src/repro/models/ssm.py``).

Chunked SSD forward (paper §6): within-chunk "attention-like" diagonal
blocks + inter-chunk state recurrence.  ``ssm_block`` and ``ssm_prefill``
send the scan of a CUDA tensor through the hand-written ``ssd_scan``
kernel (``repro_torch.kernels.ssd_scan``), with the final state; on the
CPU, and with ``impl="ref"``, they run ``ssd_chunked``, this module's
plain version of the same math.  (The reference model never calls its
Pallas kernel: it always runs its ``ssd_chunked``.)  Under grad the
kernel computes the forward and the backward differentiates
``ssd_chunked`` (``kernels._autograd``).

Params keep the reference's layout: separate z / xBC / dt projections
(identical math to one fused in_proj).
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.distribution.sharding import constrain, on_local_shards
from repro_torch.kernels._autograd import kernel_with_plain_grad
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import layers as L

F32 = torch.float32


def _dims(cfg):
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    H = s.n_heads(cfg.d_model)
    return s, di, H, s.head_dim, s.n_groups, s.d_state


def ssm_param_shapes(cfg):
    """One layer's param names and shapes, as the reference's ``init_ssm``."""
    s, di, H, P, G, N = _dims(cfg)
    d, conv_dim = cfg.d_model, di + 2 * G * N
    return {"w_z": (d, di), "w_xbc": (d, conv_dim), "w_dt": (d, H),
            "conv_w": (s.d_conv, conv_dim), "conv_b": (conv_dim,), "A_log": (H,), "D": (H,),
            "dt_bias": (H,), "norm_scale": (di,), "w_out": (di, d)}


def ssm_specs(cfg):
    """One layer's logical sharding names."""
    return {"w_z": ("p_embed", "p_ssm_inner"), "w_xbc": ("p_embed", "p_ssm_inner"),
            "w_dt": ("p_embed", "p_ssm_heads"), "conv_w": ("p_none", "p_ssm_inner"),
            "conv_b": ("p_ssm_inner",), "A_log": ("p_ssm_heads",), "D": ("p_ssm_heads",),
            "dt_bias": ("p_ssm_heads",), "norm_scale": ("p_ssm_inner",),
            "w_out": ("p_ssm_inner", "p_embed")}


def init_ssm(cfg, *, generator: "torch.Generator", device, dtype=F32):
    """One layer's params, with the reference's distributions: truncated-
    normal projections (fan-in scaled; the conv at 1/sqrt(d_conv)),
    A_log = log(1..H) (A in [-H, -1]), D = 1, and dt_bias the inverse
    softplus of a log-uniform draw on [1e-3, 1e-1].  A_log, D and dt_bias
    are f32 whatever ``dtype``."""
    shapes = ssm_param_shapes(cfg)
    H = shapes["A_log"][0]

    def normal(name, scale=None):
        return L.ninit(shapes[name], generator=generator, device=device, dtype=dtype,
                       scale=scale)

    u = torch.empty(H, dtype=F32, device=device)
    u.uniform_(math.log(1e-3), math.log(1e-1), generator=generator)
    return {
        "w_z": normal("w_z"),
        "w_xbc": normal("w_xbc"),
        "w_dt": normal("w_dt"),
        "conv_w": normal("conv_w", 1.0 / math.sqrt(cfg.ssm.d_conv)),
        "conv_b": torch.zeros(shapes["conv_b"], dtype=dtype, device=device),
        "A_log": torch.log(torch.arange(1, H + 1, dtype=F32, device=device)),
        "D": torch.ones(H, dtype=F32, device=device),
        "dt_bias": torch.log(torch.expm1(torch.exp(u))),  # inverse softplus
        "norm_scale": torch.ones(shapes["norm_scale"], dtype=dtype, device=device),
        "w_out": normal("w_out"),
    }


# batch rows and channels of the depthwise conv are independent: under a
# mesh it runs on the local shards of both (DTensor's own convolution
# handles shards of the last dim, here the sequence, and no others)
_CONV_SHARD_DIMS = {"batch": ((0, None, None), (0,)), "channels": ((2, 1, 0), (2,))}


def _causal_depthwise_conv(x, w, b):
    """x: (B, S, C); w: (W, C) depthwise causal conv; returns (B, S, C),
    contiguous."""
    return on_local_shards(_depthwise_conv, (x, w, b), _CONV_SHARD_DIMS)


def _depthwise_conv(x, w, b):
    W, C = w.shape
    xp = F.pad(x.transpose(1, 2), (W - 1, 0))
    return F.conv1d(xp, w.t().unsqueeze(1), b, groups=C).transpose(1, 2).contiguous()


def _expand_groups(t, H):
    """(B, L, G, N) -> (B, L, H, N) by repeating groups over heads."""
    R = H // t.shape[2]
    return t.repeat_interleave(R, dim=2) if R > 1 else t


def ssd_chunked(xh, dt, A, Bg, Cg, chunk: int):
    """Chunked SSD scan, the plain version.

    xh: (B, S, H, P) inputs; dt: (B, S, H) (post-softplus);
    A: (H,) negative; Bg/Cg: (B, S, G, N).
    Returns (y (B, S, H, P) f32, final_state (B, H, N, P) f32), the state
    starting at zero.  A ragged tail is zero-padded: dt = 0 and B = C = 0
    leave state and output inert."""
    Bsz, S, H, P = xh.shape
    N = Bg.shape[-1]
    Lc = min(chunk, S)
    pad = (-S) % Lc
    xf, dtf = xh.float(), dt.float()
    Bh, Ch = _expand_groups(Bg, H).float(), _expand_groups(Cg, H).float()
    if pad:
        xf, Bh, Ch = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (xf, Bh, Ch))
        dtf = F.pad(dtf, (0, 0, 0, pad))
    state = torch.zeros((Bsz, H, N, P), dtype=F32, device=xh.device)
    mask = torch.tril(torch.ones((Lc, Lc), dtype=torch.bool, device=xh.device))
    A = A.float()
    ys = []
    for c0 in range(0, S + pad, Lc):
        xc, dtc, Bc, Cc = (t[:, c0:c0 + Lc] for t in (xf, dtf, Bh, Ch))
        cum = torch.cumsum(dtc * A, dim=1)  # (B, L, H)
        # intra-chunk: att[b,h,i,j] = (C_i . B_j) exp(cum_i - cum_j) dt_j, j <= i.
        # The exponent is masked, not the product: for j > i it is positive
        # and may overflow, and a masked inf would give a 0 * inf = NaN
        # gradient (the reference masks the product and has that fault).
        scores = torch.einsum("bihn,bjhn->bhij", Cc, Bc)
        seg = (cum[:, :, None, :] - cum[:, None, :, :]).permute(0, 3, 1, 2)
        decay = torch.exp(seg.masked_fill(~mask, float("-inf")))
        att = scores * decay * dtc.transpose(1, 2)[:, :, None, :]
        y_intra = torch.einsum("bhij,bjhp->bihp", att, xc)
        # inter-chunk: contribution of the incoming state
        y_inter = torch.einsum("bihn,bhnp->bihp", Cc * torch.exp(cum)[..., None], state)
        # chunk state: S_c = sum_j exp(cum_L - cum_j) dt_j B_j x_j^T
        w = torch.exp(cum[:, -1:, :] - cum) * dtc
        s_c = torch.einsum("bjhn,bjhp->bhnp", Bc * w[..., None], xc)
        state = torch.exp(cum[:, -1])[:, :, None, None] * state + s_c
        ys.append(y_intra + y_inter)
    return torch.cat(ys, dim=1)[:, :S], state


def _ssd_shard_dims(G: int) -> dict:
    """The dims of (xs, dt, A, Bg, Cg) -> (y, state) the SSD scan treats
    independently, for its kernel under a mesh: batch rows, and heads when
    every head reads the one group's B and C (G == 1)."""
    dims = {"batch": ((0, 0, None, 0, 0), (0, 0))}
    if G == 1:
        dims["heads"] = ((2, 2, 0, None, None), (2, 1))
    return dims


def _mixer(cfg, p, x, impl: str):
    """proj -> conv -> SSD -> gated norm -> out proj, shared by
    ``ssm_block`` and ``ssm_prefill``.  Returns (out, final state, raw xBC)."""
    if impl not in ("auto", "ref"):
        raise ValueError(f"impl={impl!r}: use auto or ref")
    s, di, H, P, G, N = _dims(cfg)
    B_, S, _ = x.shape
    z = constrain(torch.matmul(x, p["w_z"]), "batch", "seq", "ssm_inner")
    xbc_raw = constrain(torch.matmul(x, p["w_xbc"]), "batch", "seq", "ssm_inner")
    dt_raw = torch.matmul(x.float(), p["w_dt"].float())

    # f32 for the scan (no copy in f32); x, B and C are views of it
    xbc = F.silu(_causal_depthwise_conv(xbc_raw, p["conv_w"], p["conv_b"])).float()
    xs = xbc[..., :di].reshape(B_, S, H, P)
    Bg = xbc[..., di:di + G * N].reshape(B_, S, G, N)
    Cg = xbc[..., di + G * N:].reshape(B_, S, G, N)

    dt = F.softplus(dt_raw + p["dt_bias"].float())  # (B, S, H) f32
    A = -torch.exp(p["A_log"].float())  # (H,)

    if impl == "auto" and xs.is_cuda:
        # under grad: the kernel's forward, the gradient of ssd_chunked
        y, state = kernel_with_plain_grad(
            functools.partial(ssd_ops.ssd, impl="cuda", return_state=True),
            functools.partial(ssd_chunked, chunk=s.chunk), xs, dt, A, Bg, Cg,
            shard_dims=_ssd_shard_dims(G))
    else:
        y, state = ssd_chunked(xs, dt, A, Bg, Cg, s.chunk)
    y = y + xs * p["D"].float()[:, None]
    y = y.reshape(B_, S, di).to(x.dtype)

    # gated RMSNorm (mamba2): norm(y * silu(z)) * scale
    y = L.rmsnorm(y * F.silu(z), p["norm_scale"], cfg.norm_eps)
    return constrain(torch.matmul(y, p["w_out"]), "batch", "seq", "embed"), state, xbc_raw


def ssm_block(cfg, p, x, *, return_state: bool = False, impl: str = "auto"):
    """Full Mamba-2 block: proj -> conv -> SSD -> gated norm -> out proj.

    x: (B, S, D) -> (B, S, D) [, final ssm state (B, H, N, P) f32].
    ``impl="ref"`` keeps the scan on ``ssd_chunked``."""
    out, state, _ = _mixer(cfg, p, x, impl)
    return (out, state) if return_state else out


def ssm_prefill(cfg, p, x, *, impl: str = "auto"):
    """``ssm_block`` plus the decode cache prefill leaves behind.

    Returns (out (B, S, D), cache) where ``cache`` is exactly the
    ``{'state', 'conv'}`` dict ``ssm_decode_step`` consumes: the scan's
    final state and the last ``d_conv - 1`` RAW (pre-silu-conv) xBC
    projections (left-zero-padded when S < d_conv - 1, matching the
    zero-initialized rolling window)."""
    out, state, xbc_raw = _mixer(cfg, p, x, impl)
    W1 = cfg.ssm.d_conv - 1
    win = xbc_raw[:, max(x.shape[1] - W1, 0):]
    if win.shape[1] < W1:
        win = F.pad(win, (0, 0, W1 - win.shape[1], 0))
    return out, {"state": state, "conv": win.to(x.dtype)}


# ---------------------------------------------------------------------------
# decode path: O(1) state update per token
# ---------------------------------------------------------------------------

def init_ssm_cache(cfg, batch: int, *, device, dtype=F32):
    s, di, H, P, G, N = _dims(cfg)
    return {"state": torch.zeros((batch, H, N, P), dtype=F32, device=device),
            "conv": torch.zeros((batch, s.d_conv - 1, di + 2 * G * N), dtype=dtype,
                                device=device)}


def ssm_decode_step(cfg, p, x, cache):
    """x: (B, 1, D); cache: {'state', 'conv'} -> (y (B, 1, D), new cache).
    Plain PyTorch: one token's update is a few small products."""
    s, di, H, P, G, N = _dims(cfg)
    B_ = x.shape[0]

    z = torch.matmul(x, p["w_z"])
    xbc_t = torch.matmul(x, p["w_xbc"])
    dt_raw = torch.matmul(x.float(), p["w_dt"].float())

    # rolling causal conv window
    win = torch.cat([cache["conv"], xbc_t.to(cache["conv"].dtype)], dim=1)  # (B, W, C)
    conv_out = (win.float() * p["conv_w"].float()).sum(1) + p["conv_b"].float()
    xbc = F.silu(conv_out)[:, None, :].to(x.dtype)  # (B, 1, C)
    new_conv = win[:, 1:]

    xs = xbc[..., :di].reshape(B_, H, P).float()
    Bg = _expand_groups(xbc[..., di:di + G * N].reshape(B_, 1, G, N), H)[:, 0].float()
    Cg = _expand_groups(xbc[..., di + G * N:].reshape(B_, 1, G, N), H)[:, 0].float()

    dt = F.softplus(dt_raw[:, 0] + p["dt_bias"].float())  # (B, H)
    a = torch.exp(dt * -torch.exp(p["A_log"].float()))  # (B, H)

    state = cache["state"] * a[:, :, None, None] + (Bg * dt[..., None])[..., None] * xs[:, :, None]
    y = torch.einsum("bhn,bhnp->bhp", Cg, state) + xs * p["D"].float()[:, None]
    y = y.reshape(B_, 1, di).to(x.dtype)

    y = L.rmsnorm(y * F.silu(z), p["norm_scale"], cfg.norm_eps)
    return torch.matmul(y, p["w_out"]), {"state": state, "conv": new_conv}
