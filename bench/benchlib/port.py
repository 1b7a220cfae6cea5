"""The program under test, as the harness reaches it: the port's package
on the path, a configuration file's sizes as the port's ``ArchConfig``,
and the card as the port's device."""
from __future__ import annotations

import sys

from .registry import ROOT


def import_port() -> None:
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def arch_config(arch: dict):
    """The port's ``ArchConfig`` of a configuration file's ``arch``."""
    import_port()
    from repro_torch.configs.base import ArchConfig, SSMConfig

    kw = dict(arch)
    for k in ("global_attn_layers", "mrope_sections"):
        if k in kw:
            kw[k] = tuple(kw[k])
    if kw.get("ssm") is not None:
        kw["ssm"] = SSMConfig(**kw["ssm"])
    return ArchConfig(**kw)


def cuda_device():
    """The port's first CUDA device."""
    import_port()
    from repro_torch.core import get_all_devices

    return get_all_devices(1, 0).get()[0]
