"""Uniform model API over the ported families.

    m = get_model(cfg)
    params = m.init(cfg, generator=gen, device=dev)
    logits, aux = m.forward(cfg, params, batch)
    cache = m.init_cache(cfg, B, S, device=dev)
    logits, cache = m.decode_step(cfg, params, cache, tok, pos)
"""
from __future__ import annotations

from types import ModuleType

from repro_torch.configs.base import ArchConfig
from repro_torch.models import ssm_lm, transformer

__all__ = ["get_model"]


def get_model(cfg: ArchConfig) -> ModuleType:
    if cfg.family == "dense":
        return transformer
    if cfg.family == "ssm":
        return ssm_lm
    raise NotImplementedError(
        f"model family '{cfg.family}' ({cfg.name}) is not ported yet: ROADMAP.md Queue 1 item 7")
