"""Plain PyTorch version of flash attention: exact (unfused) GQA attention,
f32 scores and softmax, as ``src/repro/kernels/flash_attention/ref.py``."""
import math

import torch


def flash_attention_ref(q, k, v, *, causal: bool = True):
    """q: (B, Sq, H, D); k/v: (B, Skv, K, D); H % K == 0 -> (B, Sq, H, D).

    Scores are f32, masked with -1e30 (positions both counted from 0), and
    the softmax weights are cast to ``v.dtype`` before P·V."""
    B, Sq, H, D = q.shape
    Skv, K = k.shape[1], k.shape[2]
    R = H // K
    qr = q.reshape(B, Sq, K, R, D)
    s = torch.einsum("bqkrd,bskd->bkrqs", qr.float(), k.float()) / math.sqrt(D)
    if causal:
        pos = torch.arange(max(Sq, Skv), device=q.device)
        mask = pos[None, :Skv] <= pos[:Sq, None]
        s = s.masked_fill(~mask, -1e30)
    w = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bkrqs,bskd->bqkrd", w, v)
    return o.reshape(B, Sq, H, D)


def bf16_bound(q, k, v, want, *, causal: bool = True):
    """How far two correct bf16 attentions of (q, k, v) may lie apart, per
    element of ``want`` (one of them, (B, Sq, H, D)), as f32.

    Each rounds every softmax weight w_i to bf16 (relative error at most
    2**-8) at its own point of the softmax, and rounds its output to bf16
    once (at most 2**-8 of |o|).  So two of them differ by at most about
    2**-7 * (sum_i w_i |v_i| + |o|); the sum is this plain version on |v|.
    A row that misses keys, or sees masked ones, moves by about w_i |v_i - o|
    for each: past the bound once those keys hold more than about 2**-7 of
    the row's weight."""
    spread = flash_attention_ref(q, k, v.abs(), causal=causal).float()
    return 2.0 ** -7 * (spread + want.float().abs())
