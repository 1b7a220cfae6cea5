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

Every family's ``loss_fn(cfg, params, batch, remat=, q_block=, impl=)``
is the reference's (mean next-token cross-entropy in f32; transformer adds
the MoE router loss), with ``forward``'s ``remat`` policies none, full and
dots mapped to ``torch.utils.checkpoint``.

``make_batch`` builds a random batch for an (arch x shape) cell, with the
modality STUBS (whisper frames, qwen2-vl patch embeddings and M-RoPE
positions) drawn as the reference draws them; ``batch_logical_specs``
names each batch input's logical axes, and ``input_specs`` gives the
inputs as meta-device tensors (shapes and dtypes, no allocation).  Each
family's ``param_specs`` names its params' logical axes, which
``distribution.sharding.tree_sharding`` maps onto a mesh.
"""
from __future__ import annotations

from types import ModuleType

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import encdec, hybrid, ssm_lm, transformer

__all__ = ["batch_logical_specs", "get_model", "input_specs", "make_batch", "paged_surface"]


def get_model(cfg: ArchConfig) -> ModuleType:
    if cfg.family in ("dense", "moe", "vlm"):
        return transformer
    if cfg.family == "ssm":
        return ssm_lm
    if cfg.family == "encdec":
        return encdec
    if cfg.family == "hybrid":
        return hybrid
    raise ValueError(cfg.family)


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


def _batch_shapes(cfg: ArchConfig, shape: ShapeConfig, *, dtype=torch.bfloat16):
    """dict name -> (shape, dtype) for the *batch* inputs of a cell."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        d: dict = {"tokens": ((B, 1), torch.int32)}
    else:
        d = {"tokens": ((B, S), torch.int32)}
        if shape.kind == "train":
            d["labels"] = ((B, S), torch.int32)
    if cfg.family == "encdec":
        d["frames"] = ((B, cfg.encdec.encoder_seq, cfg.d_model), dtype)
    if cfg.family == "vlm" and shape.kind != "decode":
        d["patch_embeds"] = ((B, cfg.num_patches, cfg.d_model), dtype)
        d["positions"] = ((3, B, S), torch.int32)
    return d


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> "dict[str, torch.Tensor]":
    """Meta-device stand-ins for every model input: the reference's shapes
    and dtypes, no allocation."""
    return {k: torch.empty(s, dtype=dt, device="meta")
            for k, (s, dt) in _batch_shapes(cfg, shape).items()}


def batch_logical_specs(cfg: ArchConfig, shape: ShapeConfig) -> "dict[str, tuple]":
    """Logical axis names for each batch input (``_split_micro`` finds the
    batch axis by them)."""
    names = {
        "tokens": ("batch", "seq"),
        "labels": ("batch", "seq"),
        "frames": ("batch", None, "embed"),
        "patch_embeds": ("batch", None, "embed"),
        "positions": (None, "batch", "seq"),
    }
    return {k: names[k] for k in _batch_shapes(cfg, shape)}


def make_batch(cfg: ArchConfig, shape: ShapeConfig, seed: int = 0, *, device="cuda") -> dict:
    """Small random batch on ``device`` (the card unless the caller asks
    for another): the reference's numpy draws in the same order, so the
    batch is bit-equal to its ``make_batch``.  Float leaves are drawn in
    f64 and rounded to f32 first, then to their dtype, as the reference's
    conversion rounds them."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, (s, dt) in _batch_shapes(cfg, shape).items():
        if dt == torch.int32:
            hi = cfg.vocab_size if "token" in k or "label" in k else min(shape.seq_len, 4)
            arr = torch.from_numpy(rng.integers(0, hi, size=s).astype(np.int32))
        else:
            arr = torch.from_numpy(rng.normal(0, 0.02, size=s).astype(np.float32)).to(dt)
        out[k] = arr.to(device)
    return out
