"""The paper's own Table-3 setting (port of ``repro/configs/paper_vit.py``):
a 4-layer vision transformer, patch size 4, hidden dimension 128, whose
FFN sites of training width 128 become FFF layers of leaf width l in
{1, 2, 4, 8, 16, 32} and depth log2(128 / l).  The classifier head reuses
``vocab_size`` (10 CIFAR-10 classes) over the mean-pooled 65 tokens (8 x 8
patches and a CLS slot).  Used by ``examples/vit_cifar_fff_torch.py``."""
import dataclasses

import torch

from repro_torch.configs.base import BlockSpec, FFNSpec, ModelConfig


def vit_config(ffn_kind: str = "dense", leaf_width: int = 32,
               hardening_scale: float = 10.0) -> ModelConfig:
    if ffn_kind == "dense":
        ffn = FFNSpec(kind="dense", d_ff=128, activation="gelu")
    else:
        ffn = FFNSpec(kind="dense", d_ff=128,
                      activation="gelu").as_fff(leaf_width=leaf_width, trees=1)
        ffn = dataclasses.replace(ffn, hardening_scale=hardening_scale)
    return ModelConfig(
        arch_id=f"paper-vit-{ffn_kind}-l{leaf_width}",
        family="vlm",
        d_model=128,
        n_layers=4,
        n_heads=4,
        n_kv_heads=4,
        vocab_size=10,            # CIFAR-10 classes (the head reuses vocab)
        max_seq_len=65,           # 8x8 patches + CLS
        pos_emb="learned",
        norm="layernorm",
        frontend="vision_stub",
        period=(BlockSpec(mixer="attn", ffn=ffn),),
        param_dtype=torch.float32,
        accum_dtype=torch.float32,
        scan_layers=False,
        attn_chunk=64,
    )


CONFIG = vit_config("dense")
FFF_CONFIG = vit_config("fff", leaf_width=32)
