"""Arch registry: ``--arch <id>`` lookup (port of ``repro/configs/
registry.py``), every arch of the JAX registry.  ``get_config(arch_id,
ffn="fff")`` returns the FFF variant; ``ffn="native"`` the published
baseline (dense or MoE as the source model ships).  ``paper-vit`` (the
paper's Table-3 ViT, leaf width 32) resolves but is not in ``ARCH_IDS``,
the LM archs the drivers and the dry-run sweep."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_MODULES = {
    "whisper-small": "repro_torch.configs.whisper_small",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t_a32b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "jamba-1.5-large-398b": "repro_torch.configs.jamba_1_5_large_398b",
    "internlm2-20b": "repro_torch.configs.internlm2_20b",
    "phi3-medium-14b": "repro_torch.configs.phi3_medium_14b",
    "starcoder2-15b": "repro_torch.configs.starcoder2_15b",
    "command-r-35b": "repro_torch.configs.command_r_35b",
    "internvl2-26b": "repro_torch.configs.internvl2_26b",
    "xlstm-1.3b": "repro_torch.configs.xlstm_1_3b",
    "paper-vit": "repro_torch.configs.paper_vit",
}

ARCH_IDS = tuple(k for k in _MODULES if k != "paper-vit")


def get_config(arch_id: str, ffn: str = "fff") -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(_MODULES)}")
    mod = importlib.import_module(_MODULES[arch_id])
    if ffn == "fff":
        return mod.FFF_CONFIG
    if ffn == "native":
        return mod.CONFIG
    return mod.CONFIG.with_ffn_kind(ffn)
