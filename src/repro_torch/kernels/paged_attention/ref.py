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



def bf16_bound(q, k_pages, v_pages, page_table, lengths, want):
    """How far two correct bf16 paged attentions may lie apart, per element
    of ``want`` (one of them, (B, H, D)), as f32: the reasoning of
    ``flash_attention.ref.bf16_bound`` over each row's valid tokens.  Each
    rounds every softmax weight to bf16 (relative error at most 2**-8) at
    its own point of the softmax and its output once (2**-8 of |o|), so
    they differ by at most about 2**-7 * (sum_i w_i |v_i| + |o|)."""
    spread = paged_attention_ref(q, k_pages, v_pages.abs(), page_table, lengths).float()
    return 2.0 ** -7 * (spread + want.float().abs())
