"""Plain PyTorch versions of the SSD scan.

``ssd_ref``: the sequential (non-chunked) recurrence of
``src/repro/kernels/ssd_scan/ref.py``,
y_t = C_t . S_t + D x_t,  S_t = exp(dt_t A) S_{t-1} + dt_t B_t x_t^T —
the exact state-space recurrence the chunked forms must match.  One step
per token: the tests' oracle, never the main path.

``ssd_three_pass``: the CUDA kernel's decomposition (``csrc/ssd_scan.cu``)
in plain PyTorch, for the tests and ``chip_smoke.py``, never the main
path.
"""
import torch
import torch.nn.functional as F


def ssd_ref(x, dt, A, B, C, D=None, *, return_state: bool = False):
    """x: (G, S, P); dt: (G, S); A: (G,); B/C: (G, S, N) -> y (G, S, P)
    in x's dtype, and with ``return_state`` the f32 state after the last
    token, (G, N, P).  G = batch*heads flattened; one scalar A per row."""
    G, S, P = x.shape
    N = B.shape[-1]
    xf, dtf, Af, Bf, Cf = (t.float() for t in (x, dt, A, B, C))
    state = torch.zeros((G, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        a = torch.exp(dtf[:, t] * Af)  # (G,)
        state = a[:, None, None] * state + dtf[:, t, None, None] * (
            Bf[:, t, :, None] * xf[:, t, None, :])
        ys.append(torch.einsum("gn,gnp->gp", Cf[:, t], state))
    y = torch.stack(ys, dim=1) if ys else torch.zeros((G, 0, P), device=x.device)
    if D is not None:
        y = y + xf * D.float()[:, None, None]
    y = y.to(x.dtype)
    return (y, state) if return_state else y


def ssd_three_pass(x, dt, A, B, C, chunk: int):
    """Model layout, as the kernel takes it: x (Bz, S, H, P); dt (Bz, S, H);
    A (H,); B/C (Bz, S, G, N), head h reading group h // (H // G) -> y
    (Bz, S, H, P) f32 and the final state (Bz, H, N, P) f32, from zero.

    The kernel's three passes over chunks of ``chunk`` tokens (the tail
    zero-padded: dt = 0 and B = C = x = 0 leave state and cum unchanged):
    1. every chunk's own state S_c = sum_j exp(cum_last - cum_j) dt_j
       B_j x_j^T, all chunks at once;
    2. a walk over the chunks that overwrites S_c, in place, with the
       state coming into chunk c (``s_in = s; s = exp(cum_last) s + S_c``);
    3. every chunk's outputs, y_i = exp(cum_i) C_i . s_in + sum_{j<=i}
       (C_i.B_j) exp(cum_i - cum_j) dt_j x_j, all chunks at once.
    Only exp(cum_i - cum_j) for j <= i, exp(cum_last - cum_j) and
    exp(cum_i) are formed, all <= 1; entries above the diagonal are
    selected to 0."""
    Bz, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    R = H // G
    nc = -(-S // chunk)
    pad = nc * chunk - S
    xf, dtf, Bf, Cf = (F.pad(t.float(), (0, 0) * (t.dim() - 2) + (0, pad)) for t in (x, dt, B, C))
    xc = xf.reshape(Bz, nc, chunk, G, R, P)
    dtc = dtf.reshape(Bz, nc, chunk, G, R)
    Bc, Cc = (t.reshape(Bz, nc, chunk, G, N) for t in (Bf, Cf))
    cum = torch.cumsum(dtc * A.float().reshape(G, R), dim=2)  # (Bz, nc, l, G, R)
    last = cum[:, :, -1]  # (Bz, nc, G, R)

    # 1. chunk states (Bz, nc, G, R, N, P)
    w = torch.exp(last[:, :, None] - cum) * dtc
    states = torch.einsum("bcjgn,bcjgrp->bcgrnp", Bc, xc * w[..., None])

    # 2. in place: chunk states -> incoming states
    s = torch.zeros_like(states[:, 0])
    for c in range(nc):
        s_c = states[:, c].clone()
        states[:, c] = s
        s = torch.exp(last[:, c])[..., None, None] * s + s_c

    # 3. chunk outputs
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    cumt = cum.permute(0, 1, 3, 4, 2)  # (Bz, nc, G, R, l)
    diff = torch.where(mask, cumt[..., :, None] - cumt[..., None, :], 0.0)
    scores = torch.einsum("bcign,bcjgn->bcgij", Cc, Bc)[:, :, :, None]
    att = torch.where(mask, scores * torch.exp(diff) * dtc.permute(0, 1, 3, 4, 2)[..., None, :],
                      0.0)
    y = torch.einsum("bcgrij,bcjgrp->bcigrp", att, xc)
    y = y + torch.exp(cum)[..., None] * torch.einsum("bcign,bcgrnp->bcigrp", Cc, states)
    return y.reshape(Bz, nc * chunk, H, P)[:, :S], s.reshape(Bz, H, N, P)
