"""internvl2-26b [vlm] — 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92553 — InternViT + InternLM2 backbone; the vision frontend is a
stub (a prompt enters as precomputed patch embeddings).
[arXiv:2404.16821; hf]"""
import torch

from repro_torch.configs.base import BlockSpec, FFNSpec, ModelConfig

CONFIG = ModelConfig(
    arch_id="internvl2-26b",
    family="vlm",
    d_model=6144,
    n_layers=48,
    n_heads=48,
    n_kv_heads=8,
    vocab_size=92553,
    max_seq_len=32768,
    rope_theta=1_000_000.0,
    frontend="vision_stub",
    period=(BlockSpec(mixer="attn",
                      ffn=FFNSpec(kind="dense", d_ff=16384,
                                  activation="swiglu")),),
    param_dtype=torch.bfloat16,
    accum_dtype=torch.bfloat16,
    remat="full",
    grad_accum=16,
)

# 16 leaves x 1024 = 16384 (exact width match)
FFF_CONFIG = CONFIG.with_ffn_kind("fff", leaf_width=1024)
