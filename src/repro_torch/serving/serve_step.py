"""Serving steps: prefill (forward + decode cache) and greedy decode.

The counterparts of ``src/repro/serving/serve_step.py``'s ``make_prefill``
and ``make_serve_step``, with the params closed over, for the dense and
ssm families.  On a CUDA device the dense prefill's attention runs the
hand-written flash kernel and the ssm prefill's scans run the ``ssd_scan``
kernel; the decode steps are plain PyTorch.
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
    """Returns ``prefill(batch) -> (logits_last, cache)``: logits (B, 1, V)
    f32 of the last position and the prompt's cache.  Dense: kv {'k', 'v'}:
    (L, B, S, K, hd), to be copied into a decode cache of S + new slots.
    ssm: the decode cache itself, {'state', 'conv'} (the real state the
    prompt leaves, not the reference ``forward``'s zeros).  ``impl="ref"``
    keeps attention or the scan on the plain path; ``q_block`` is the
    dense plain attention's query block."""
    m = get_model(cfg)
    kw = {"q_block": q_block} if cfg.family == "dense" else {}

    def prefill(batch):
        logits, _aux, cache = m.forward(cfg, params, batch, return_kv=True, last_only=True,
                                        impl=impl, **kw)
        return logits, cache

    return prefill
