"""Uniform model API over the ported families.

    m = get_model(cfg)
    params = m.init(cfg, generator=gen, device=dev)
    logits, aux = m.forward(cfg, params, batch)
    cache = m.init_cache(cfg, B, S, device=dev)
    logits, cache = m.decode_step(cfg, params, cache, tok, pos)

Every ported family also exposes the paged serving contract consumed by
``PagedServeEngine.from_config``:

    spec = m.paged_spec(cfg)                        # ONE multi-layer PageSpec
    k, v, state, logits = m.paged_prefill(cfg, params, tokens, extras)
    k_pages, v_pages, state, logits = m.paged_decode_step(
        cfg, params, k_pages, v_pages, state, tokens, positions, tables, lengths)
"""
from __future__ import annotations

from types import ModuleType

from repro_torch.configs.base import ArchConfig
from repro_torch.models import ssm_lm, transformer

__all__ = ["get_model", "paged_surface"]


def get_model(cfg: ArchConfig) -> ModuleType:
    if cfg.family == "dense":
        return transformer
    if cfg.family == "ssm":
        return ssm_lm
    raise NotImplementedError(
        f"model family '{cfg.family}' ({cfg.name}) is not ported yet: ROADMAP.md Queue 1 item 7")


def paged_surface(cfg: ArchConfig):
    """(paged_spec, paged_prefill, paged_decode_step) for ``cfg``'s family,
    with a clear error if the family lacks a piece."""
    m = get_model(cfg)
    missing = [n for n in ("paged_spec", "paged_prefill", "paged_decode_step")
               if not hasattr(m, n)]
    if missing:
        raise NotImplementedError(f"model family '{cfg.family}' ({m.__name__}) lacks the paged "
                                  f"serving contract: missing {missing}")
    return m.paged_spec, m.paged_prefill, m.paged_decode_step
