"""Arch registry: ``--arch <id>`` lookup (port of ``repro/configs/
registry.py``).  Holds the archs ported so far; the rest are queued in
ROADMAP.md."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_MODULES = {
    "internlm2-20b": "repro_torch.configs.internlm2_20b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str, ffn: str = "fff") -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(_MODULES)}")
    mod = importlib.import_module(_MODULES[arch_id])
    if ffn == "fff":
        return mod.FFF_CONFIG
    if ffn == "native":
        return mod.CONFIG
    return mod.CONFIG.with_ffn_kind(ffn)
