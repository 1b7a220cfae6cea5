"""Plain PyTorch version of paged attention (decode): gather every table
entry back into a contiguous cache, then exact GQA attention with a length
mask, f32 scores and softmax, as ``src/repro/kernels/paged_attention/ref.py``.

Token ``t`` of sequence ``b`` lives at ``pages[table[b, t // P], t % P]``;
table slots at or past ``ceil(length / P)`` are padding and must hold a
valid page index (page 0 by convention) so the gather stays in bounds.
"""
import math

import torch

NEG_INF = -1e30


def paged_attention_ref(q, k_pages, v_pages, page_table, lengths):
    """q: (B, H, D); k/v_pages: (N, P, K, D), H % K == 0; page_table:
    (B, M) int; lengths: (B,) int -> (B, H, D) of q's dtype.

    One decode query per sequence, attending to its first ``lengths[b]``
    cached tokens.  Masked scores are -1e30 (a select), and the softmax
    weights are cast to ``v_pages.dtype`` before P·V."""
    B, H, D = q.shape
    _, P, K, Dk = k_pages.shape
    M = page_table.shape[1]
    R = H // K
    tbl = page_table.long()
    k = k_pages[tbl].reshape(B, M * P, K, Dk)  # gather: (B, M, P, K, D)
    v = v_pages[tbl].reshape(B, M * P, K, Dk)
    qr = q.reshape(B, K, R, D)
    s = torch.einsum("bkrd,bskd->bkrs", qr.float(), k.float()) / math.sqrt(D)
    mask = torch.arange(M * P, device=q.device)[None, :] < lengths[:, None]  # (B, M*P)
    s = s.masked_fill(~mask[:, None, None, :], NEG_INF)
    w = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bkrs,bskd->bkrd", w, v)
    return o.reshape(B, H, D).to(q.dtype)


def split_bounds(lengths, page_size: int, max_pages: int, splits: int = 8):
    """The token range [lo, hi) of each split of each row, as the kernel
    cuts it: a row's n = min(length, M * P) tokens fill np = ceil(n / P)
    pages, split s takes pages [s pps, min(np, (s + 1) pps)), pps =
    ceil(np / splits), and its range ends at n.  lengths (B,) int ->
    lo, hi (splits, B), int64; an empty split has lo == hi."""
    n = lengths.long().clamp(0, max_pages * page_size)
    pps = ((n + page_size - 1) // page_size + splits - 1) // splits
    s = torch.arange(splits, device=n.device)[:, None]
    lo = torch.minimum(n, s * pps * page_size)
    hi = torch.minimum(n, (s + 1) * pps * page_size)
    return lo, hi


def paged_attention_split_ref(q, k_pages, v_pages, page_table, lengths, splits: int = 8):
    """The kernel's decomposition in plain PyTorch (a yardstick, as
    ``ssd_scan.ref.ssd_three_pass`` is for ssd_scan; nothing on the main
    path calls it).  Shapes as ``paged_attention_ref``; a leading layer
    axis (q (L, B, H, D), pages (L, N, P, K, D), one table) is taken one
    layer at a time.

    Each split of ``split_bounds`` keeps its own (m, l, acc): scores in
    f32 scaled after the dot product, -1e30 outside the split by a select,
    weights exp(s - m) at the split's own max, rounded to the pages' type
    for P·V, the row sum unrounded.  The splits merge in rank order, o =
    sum_s acc_s c_s / max(sum_s l_s c_s, 1e-30), c_s = exp(m_s - max m),
    so a length-0 row gives 0.  Slots outside every split are selected
    away before they meet a weight, so garbage there (inf, NaN) cannot
    reach the result."""
    if q.dim() == 4:
        return torch.stack([paged_attention_split_ref(q[i], k_pages[i], v_pages[i], page_table,
                                                      lengths, splits)
                            for i in range(q.shape[0])])
    B, H, D = q.shape
    _, P, K, _ = k_pages.shape
    M = page_table.shape[1]
    R = H // K
    tbl = page_table.long()
    k = k_pages[tbl].reshape(B, M * P, K, D)
    v = v_pages[tbl].reshape(B, M * P, K, D)
    s = torch.einsum("bkrd,bskd->bkrs", q.reshape(B, K, R, D).float(), k.float()) / math.sqrt(D)
    pos = torch.arange(M * P, device=q.device)
    lo, hi = split_bounds(lengths, P, M, splits)
    parts = []
    for j in range(splits):
        inside = (pos[None, :] >= lo[j][:, None]) & (pos[None, :] < hi[j][:, None])  # (B, M*P)
        sj = s.masked_fill(~inside[:, None, None, :], NEG_INF)
        m = sj.amax(dim=-1)  # (B, K, R); -1e30 for an empty split
        w = torch.exp(sj - m[..., None]).masked_fill(~inside[:, None, None, :], 0.0)
        vj = v.masked_fill(~inside[:, :, None, None], 0.0)
        acc = torch.einsum("bkrs,bskd->bkrd", w.to(v.dtype).float(), vj.float())
        parts.append((m, w.sum(dim=-1), acc))
    m_all = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    den = torch.zeros_like(m_all)
    num = torch.zeros(B, K, R, D, dtype=torch.float32, device=q.device)
    for m, l_s, acc in parts:  # rank order
        c = torch.exp(m - m_all)
        den = den + l_s * c
        num = num + acc * c[..., None]
    o = num / den.clamp_min(1e-30)[..., None]
    return o.reshape(B, H, D).to(q.dtype)


def bf16_bound(q, k_pages, v_pages, page_table, lengths, want):
    """How far two correct bf16 paged attentions may lie apart, per element
    of ``want`` (one of them, (B, H, D)), as f32: the reasoning of
    ``flash_attention.ref.bf16_bound`` over each row's valid tokens.  Each
    rounds every softmax weight to bf16 (relative error at most 2**-8) at
    its own point of the softmax and its output once (2**-8 of |o|), so
    they differ by at most about 2**-7 * (sum_i w_i |v_i| + |o|)."""
    spread = paged_attention_ref(q, k_pages, v_pages.abs(), page_table, lengths).float()
    return 2.0 ** -7 * (spread + want.float().abs())
