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


def split_tf32(x):
    """f32 ``x`` -> (hi, lo), tf32 values held in f32, the f32 kernel's
    3xTF32 split: hi is x rounded to tf32's 10 mantissa bits, to nearest
    with ties away from zero (as ``cvt.rna.tf32.f32`` rounds a finite
    value), and lo is x - hi (exact in f32) rounded the same way."""
    def rna(t):
        bits = t.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    x = x.float()
    hi = rna(x)
    return hi, rna(x - hi)


def _tf32_einsum(eq: str, a, b, passes: int):
    """einsum of f32 ``a`` and ``b`` with every product taken in tf32:
    hi*hi + hi*lo + lo*hi (``passes`` 3, the kernel's 3xTF32) or hi*hi
    alone (``passes`` 1, plain TF32).  Each tf32 product is exact in f32."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    out = torch.einsum(eq, ah, bh)
    if passes == 3:
        out = out + torch.einsum(eq, ah, bl) + torch.einsum(eq, al, bh)
    elif passes != 1:
        raise ValueError(f"passes={passes}: use 3 (3xTF32) or 1 (plain TF32)")
    return out


def flash_attention_tf32(q, k, v, *, causal: bool = True, passes: int = 3):
    """``flash_attention_ref`` in f32 with both products, q·kᵀ and p·v, in
    the f32 kernel's arithmetic: 3xTF32 (``passes`` 3), or plain TF32
    (``passes`` 1, hi*hi only), which the kernel does not use because it
    misses the reference's 2e-4.  For tests on the CPU."""
    B, Sq, H, D = q.shape
    Skv, K = k.shape[1], k.shape[2]
    qr = q.float().reshape(B, Sq, K, H // K, D)
    s = _tf32_einsum("bqkrd,bskd->bkrqs", qr, k.float(), passes) / math.sqrt(D)
    if causal:
        pos = torch.arange(max(Sq, Skv), device=q.device)
        s = s.masked_fill(~(pos[None, :Skv] <= pos[:Sq, None]), -1e30)
    w = torch.softmax(s, dim=-1)
    return _tf32_einsum("bkrqs,bskd->bqkrd", w, v.float(), passes).reshape(B, Sq, H, D)
