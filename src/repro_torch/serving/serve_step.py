"""Serving steps: prefill (forward + KV cache) and greedy decode.

The counterparts of ``src/repro/serving/serve_step.py``'s ``make_prefill``
and ``make_serve_step``, with the params closed over.  On a CUDA device the
prefill's attention runs the hand-written flash kernel; the decode step's
one-query attention against the cache is plain PyTorch.
"""
from __future__ import annotations

import torch

from repro_torch.models import get_model

__all__ = ["make_prefill", "make_serve_step"]


def make_serve_step(cfg, params):
    """Returns ``serve_step(cache, tokens, pos) -> (next_tokens, logits,
    cache)``: greedy decode of one token.  ``next_tokens`` (B, 1) int32,
    ``logits`` (B, 1, V) f32; the cache is updated in place and returned."""
    m = get_model(cfg)

    def serve_step(cache, tokens, pos: int):
        logits, cache = m.decode_step(cfg, params, cache, tokens, pos)
        nxt = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        return nxt, logits, cache

    return serve_step


def make_prefill(cfg, params, *, q_block: int = 512, impl: str = "auto"):
    """Returns ``prefill(batch) -> (logits_last, kv)``: logits (B, 1, V) f32
    of the last position and kv {'k', 'v'}: (L, B, S, K, hd).  ``impl="ref"``
    keeps attention on the plain path."""
    m = get_model(cfg)

    def prefill(batch):
        logits, _aux, kv = m.forward(cfg, params, batch, q_block=q_block, return_kv=True,
                                     last_only=True, impl=impl)
        return logits, kv

    return prefill
