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

from repro_torch.distribution.sharding import (constrain, from_groups, make_groups,
                                                on_local_shards, once_a_group, split_last_dim,
                                                to_groups)
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
    """The bias is added after the conv, as the reference adds it: a bf16
    conv and an f32 bias (a layer's 1-D params stay f32 under bf16
    compute) give f32."""
    W, C = w.shape
    xp = F.pad(x.transpose(1, 2), (W - 1, 0))
    return (F.conv1d(xp, w.t().unsqueeze(1), groups=C).transpose(1, 2) + b).contiguous()


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
    independently, for its kernel or ``ssd_chunked`` under a mesh: batch
    rows, and heads when every head reads the one group's B and C (G ==
    1), B and C whole on every rank."""
    dims = {"batch": ((0, 0, None, 0, 0), (0, 0))}
    if G == 1:
        dims["heads"] = ((2, 2, 0, None, None), (2, 1))
    return dims


def _ssm_layouts(cfg, x):
    """Under head groups of the SSM heads (``layers.head_groups``, rule
    "ssm_heads"; one group of B and C, and d_inner a multiple of the
    ranks), the group layouts of the heads and of x's (and y's) d_inner
    columns; else None."""
    s, di, H, P, G, N = _dims(cfg)
    grp = L.head_groups(x, H, "ssm_heads")
    if grp is None or G != 1 or di % grp[1]:
        return None
    dims, m, g = grp
    hg = H // g
    heads = [list(range(j * hg, (j + 1) * hg)) for j in range(g)]
    cols = [list(range(j * hg * P, (j + 1) * hg * P)) for j in range(g)]
    mesh, dev = x.device_mesh, x.device
    return make_groups(mesh, dims, g, heads, H, dev), make_groups(mesh, dims, g, cols, di, dev)


def _columns_sharded(w) -> bool:
    """Whether ``w`` (a ``DTensor``) has its last dim sharded over a mesh
    dim of more than one rank."""
    from torch.distributed.tensor import DTensor

    return isinstance(w, DTensor) and any(
        q.is_shard(w.ndim - 1) and w.device_mesh.size(i) > 1 for i, q in enumerate(w.placements))


def _gathered_columns(t):
    """``t`` with its last dim gathered (replicated) over the mesh dims that
    shard it, in its own dtype."""
    from torch.distributed.tensor import Replicate

    last = t.ndim - 1
    return t.redistribute(t.device_mesh, [Replicate() if q.is_shard(last) else q
                                          for q in t.placements])


def _split_columns(t, at: int, names):
    """``t``'s last dim, sharded over the model ranks, split at ``at`` into
    two parts, each sharded as ``names`` (its logical names) place it: each
    rank gets its own share of the x columns and of the B and C columns
    (the plain shards, of (d_inner + 2 G N) / m columns, cut across them).
    ``t`` is a weight, so it is gathered over the ranks that shard its
    columns, not the activations of every row."""
    whole = _gathered_columns(t)
    return constrain(whole[..., :at], *names), constrain(whole[..., at:], *names)


def _last(t, n: int):
    """``t``'s last ``n`` positions (dim 1), all of them if it has fewer."""
    return t[:, max(t.shape[1] - n, 0):]


# the x and the B, C columns convolved together, on the local shards of
# rows and of both parts' columns
_CONV_PAIR_DIMS = {"batch": ((0, 0, None, None, None, None), (0, 0)),
                   "channels": ((2, 2, 1, 1, 0, 0), (2, 2))}


def _conv_silu_pair(x, bc, w_x, w_bc, b_x, b_bc):
    """The conv and silu of x and of B, C, each rank's columns of both in
    one depthwise conv (as many as its plain shard of xBC: one launch)."""
    n = x.shape[-1]
    y = F.silu(_depthwise_conv(torch.cat([x, bc], -1), torch.cat([w_x, w_bc], -1),
                               torch.cat([b_x, b_bc], -1)))
    return y[..., :n].contiguous(), y[..., n:].contiguous()


def _mixer(cfg, p, x, impl: str, *, return_state: bool = True, window: bool = False):
    """proj -> conv -> SSD -> gated norm -> out proj, shared by
    ``ssm_block`` and ``ssm_prefill``.  Returns (out, final state, the raw
    xBC of the last ``d_conv - 1`` positions or None without ``window``);
    the state is None under head groups without ``return_state``.

    Under a mesh that shards xBC's columns over the model ranks, as the
    reference's GSPMD partitions it: ``w_xbc`` and the conv's weights are
    split into the x part, each rank its own heads' columns, and the B and
    C part, each rank an equal share (``_split_columns``: the weights
    gathered, not the rows), so x is projected, convolved and scanned on
    the rank that owns its heads with no communication, and only B and C
    (2 G N columns) are gathered, once a layer, in the compute dtype; the
    cast to f32 follows the split, as in the reference, whose conv and
    split run in ``x.dtype``.  The conv is depthwise, so splitting the
    columns before it gives the same values.

    Under head groups of the SSM heads (``_ssm_layouts``) each rank runs
    its group's heads, as the reference's GSPMD does: x, projected on each
    rank's own 1/m of its columns, enters the group layout (gathered over
    the group's ranks), B and C whole as above, their gradient counted once
    a group, dt from ``w_dt``'s columns of the group's heads, A and D
    theirs; each rank's own 1/m of y's columns meets its columns of z in
    the gated norm, whose sum of squares is summed over the ranks, and its
    rows of ``w_out``.  The state comes back with the heads whole
    (gathered over one rank of each group)."""
    if impl not in ("auto", "ref"):
        raise ValueError(f"impl={impl!r}: use auto or ref")
    s, di, H, P, G, N = _dims(cfg)
    w_dt, dt_bias, A_log, Dh = p["w_dt"], p["dt_bias"], p["A_log"], p["D"]
    lay = _ssm_layouts(cfg, x)
    if lay is not None:
        heads, cols = lay
        w_dt, dt_bias, A_log, Dh = (to_groups(t, t.ndim - 1, heads)
                                    for t in (w_dt, dt_bias, A_log, Dh))
    # z, xBC (or its x and its B, C parts) and dt (in f32; in head groups
    # the group's heads, x counted once a group): projections of x, one
    # input-gradient reduction for all
    sharded = _columns_sharded(p["w_xbc"])  # else one device, or xBC's columns whole
    ws = [p["w_z"], *(_split_columns(p["w_xbc"], di, ("p_embed", "p_ssm_inner")) if sharded
                      else [p["w_xbc"]])]
    ws.append(w_dt.float() if lay is None
              else (functools.partial(once_a_group, groups=heads), w_dt.float()))
    proj = L.projections(x, *ws)
    z = constrain(proj[0], "batch", "seq", "ssm_inner")
    W1 = cfg.ssm.d_conv - 1
    tail = None
    if not sharded:
        xbc_raw = constrain(proj[1], "batch", "seq", "ssm_inner")
        # f32 for the scan (no copy in f32); x, B and C are views of it
        xbc = F.silu(_causal_depthwise_conv(xbc_raw, p["conv_w"], p["conv_b"])).float()
        xc, bc = xbc[..., :di], xbc[..., di:]
        if window:
            tail = _last(xbc_raw, W1)
    else:
        cw_x, cw_bc = _split_columns(p["conv_w"], di, ("p_none", "p_ssm_inner"))
        cb_x, cb_bc = _split_columns(p["conv_b"], di, ("p_ssm_inner",))
        x_raw, bc_raw = (constrain(t, "batch", "seq", "ssm_inner") for t in proj[1:3])
        xc, bc = on_local_shards(_conv_silu_pair, (x_raw, bc_raw, cw_x, cw_bc, cb_x, cb_bc),
                                 _CONV_PAIR_DIMS)
        bc = _gathered_columns(bc)
        if window:
            tail = constrain(torch.cat([_gathered_columns(_last(x_raw, W1)),
                                        _gathered_columns(_last(bc_raw, W1))], dim=-1),
                             "batch", None, "ssm_inner")
    if lay is not None:
        xc = to_groups(xc, 2, cols)
        bc = once_a_group(bc, heads)
    xs = L.split_heads(xc.float(), xc.shape[2] // P, P)
    bc = bc.float()
    Bg = L.split_heads(bc[..., :G * N], G, N)
    Cg = L.split_heads(bc[..., G * N:], G, N)
    dt = F.softplus(proj[-1] + dt_bias.float())  # (B, S, H) f32
    A = -torch.exp(A_log.float())  # (H,)
    dims = _ssd_shard_dims(G)

    if impl == "auto" and xs.is_cuda:
        # under grad: the kernel's forward, the gradient of ssd_chunked
        y, state = kernel_with_plain_grad(
            functools.partial(ssd_ops.ssd, impl="cuda", return_state=True),
            functools.partial(ssd_chunked, chunk=s.chunk), xs, dt, A, Bg, Cg, shard_dims=dims)
    else:  # under a mesh on local shards, as the kernel runs
        y, state = on_local_shards(functools.partial(ssd_chunked, chunk=s.chunk),
                                   (xs, dt, A, Bg, Cg), dims)
    y = L.merge_heads(y + xs * Dh.float()[:, None], 2)
    if lay is not None:
        y = from_groups(y, 2, lay[1])
        state = from_groups(state, 1, lay[0], whole=True) if return_state else None
    y = y.to(x.dtype)

    # gated RMSNorm (mamba2): norm(y * silu(z)) * scale
    y = L.rmsnorm(y * F.silu(z), p["norm_scale"], cfg.norm_eps)
    return constrain(L.linear(y, p["w_out"]), "batch", "seq", "embed"), state, tail


def ssm_block(cfg, p, x, *, return_state: bool = False, impl: str = "auto"):
    """Full Mamba-2 block: proj -> conv -> SSD -> gated norm -> out proj.

    x: (B, S, D) -> (B, S, D) [, final ssm state (B, H, N, P) f32].
    ``impl="ref"`` keeps the scan on ``ssd_chunked``."""
    out, state, _ = _mixer(cfg, p, x, impl, return_state=return_state)
    return (out, state) if return_state else out


def ssm_prefill(cfg, p, x, *, impl: str = "auto"):
    """``ssm_block`` plus the decode cache prefill leaves behind.

    Returns (out (B, S, D), cache) where ``cache`` is exactly the
    ``{'state', 'conv'}`` dict ``ssm_decode_step`` consumes: the scan's
    final state and the last ``d_conv - 1`` RAW (pre-silu-conv) xBC
    projections (left-zero-padded when S < d_conv - 1, matching the
    zero-initialized rolling window)."""
    out, state, win = _mixer(cfg, p, x, impl, window=True)
    W1 = cfg.ssm.d_conv - 1
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


# rows and heads of the decode's state read are independent
_DECODE_SHARD_DIMS = {"batch": ((0, 0), (0,)), "heads": ((1, 1), (1,))}


def _read_state(C, state):
    return torch.einsum("bhn,bhnp->bhp", C, state)


def ssm_decode_step(cfg, p, x, cache):
    """x: (B, 1, D); cache: {'state', 'conv'} -> (y (B, 1, D), new cache).
    Plain PyTorch: one token's update is a few small products."""
    s, di, H, P, G, N = _dims(cfg)

    z = L.linear(x, p["w_z"])
    xbc_t = L.linear(x, p["w_xbc"])
    dt_raw = L.linear(x.float(), p["w_dt"].float())

    # rolling causal conv window
    win = torch.cat([cache["conv"], xbc_t.to(cache["conv"].dtype)], dim=1)  # (B, W, C)
    conv_out = (win.float() * p["conv_w"].float()).sum(1) + p["conv_b"].float()
    xbc = F.silu(conv_out)[:, None, :].to(x.dtype)  # (B, 1, C)
    new_conv = win[:, 1:]
    # the cache's window holds xBC's plain column shards: one all-to-all
    # sends each rank its share of x's columns and of B and C's, and B and
    # C are gathered, in the compute dtype (under grad, or where the ranks
    # do not divide the parts, xBC is gathered once)
    parts = split_last_dim(xbc, di) if _columns_sharded(xbc) else None
    if parts is not None:
        x_t, bc = parts[0], _gathered_columns(parts[1])
    else:
        xbc = _gathered_columns(xbc) if _columns_sharded(xbc) else xbc
        x_t, bc = xbc[..., :di], xbc[..., di:]

    # per-head operands laid out as the state is: heads over the model axis
    xs = constrain(L.split_heads(x_t[:, 0], H, P).float(), "batch", "ssm_heads", None)
    Bg = _expand_groups(L.split_heads(bc[..., :G * N], G, N), H)[:, 0].float()
    Cg = _expand_groups(L.split_heads(bc[..., G * N:], G, N), H)[:, 0].float()
    Bg, Cg = (constrain(t, "batch", "ssm_heads", None) for t in (Bg, Cg))

    dt = F.softplus(dt_raw[:, 0] + p["dt_bias"].float())  # (B, H)
    a = torch.exp(dt * -torch.exp(p["A_log"].float()))  # (B, H)

    state = cache["state"] * a[:, :, None, None] + (Bg * dt[..., None])[..., None] * xs[:, :, None]
    y = on_local_shards(_read_state, (Cg, state), _DECODE_SHARD_DIMS) + xs * p["D"].float()[:, None]
    y = L.merge_heads(y, 1)[:, None].to(x.dtype)

    y = L.rmsnorm(y * F.silu(z), p["norm_scale"], cfg.norm_eps)
    out = constrain(L.linear(y, p["w_out"]), "batch", "seq", "embed")
    return out, {"state": state, "conv": new_conv}
