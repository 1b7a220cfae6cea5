"""Config registry: ``get_config(arch_id)`` over the configs the port runs,
every reference config."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig, smoke

_MODULES = {
    "qwen2-vl-72b": "repro_torch.configs.qwen2_vl_72b",
    "olmo-1b": "repro_torch.configs.olmo_1b",
    "starcoder2-7b": "repro_torch.configs.starcoder2_7b",
    "deepseek-67b": "repro_torch.configs.deepseek_67b",
    "stablelm-1.6b": "repro_torch.configs.stablelm_1_6b",
    "phi3.5-moe-42b-a6.6b": "repro_torch.configs.phi3_5_moe",
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe_a2_7b",
    "mamba2-130m": "repro_torch.configs.mamba2_130m",
    "hymba-1.5b": "repro_torch.configs.hymba_1_5b",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
}

ALL_ARCHS: "tuple[str, ...]" = tuple(_MODULES)

# short aliases accepted by --arch
_ALIASES = {
    "qwen2-vl": "qwen2-vl-72b",
    "olmo": "olmo-1b",
    "starcoder2": "starcoder2-7b",
    "deepseek": "deepseek-67b",
    "stablelm": "stablelm-1.6b",
    "phi3.5-moe": "phi3.5-moe-42b-a6.6b",
    "qwen2-moe": "qwen2-moe-a2.7b",
    "mamba2": "mamba2-130m",
    "hymba": "hymba-1.5b",
    "whisper": "whisper-tiny",
}


def get_config(name: str) -> ArchConfig:
    key = _ALIASES.get(name, name)
    mod = _MODULES.get(key)
    if mod is None:
        raise KeyError(f"unknown arch '{name}'; known: {sorted(_MODULES)}")
    return importlib.import_module(mod).CONFIG


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape '{name}'; known: {sorted(SHAPES)}")
    return SHAPES[name]


def cells() -> "list[tuple[str, str]]":
    """All (arch, shape) cells, with the reference's documented skips."""
    out = []
    for arch in ALL_ARCHS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            if shape.name == "long_500k" and not cfg.subquadratic:
                continue  # full-attention archs skip 524k decode
            out.append((arch, shape.name))
    return out


__all__ = ["ALL_ARCHS", "SHAPES", "ArchConfig", "ShapeConfig", "cells", "get_config",
           "get_shape", "smoke"]
