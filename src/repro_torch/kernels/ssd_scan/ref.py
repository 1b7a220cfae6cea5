"""Plain PyTorch version of the SSD scan: the sequential (non-chunked)
recurrence of ``src/repro/kernels/ssd_scan/ref.py``.

y_t = C_t . S_t + D x_t,  S_t = exp(dt_t A) S_{t-1} + dt_t B_t x_t^T —
the exact state-space recurrence the chunked forms must match.  One step
per token: the tests' oracle, never the main path.
"""
import torch


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
