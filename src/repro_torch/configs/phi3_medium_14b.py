"""phi3-medium-14b [dense] — 40L d_model=5120 40H (GQA kv=10) d_ff=17920
vocab=100352, RoPE SwiGLU GQA.  [arXiv:2404.14219; unverified]"""
import torch

from repro_torch.configs.base import BlockSpec, FFNSpec, ModelConfig

CONFIG = ModelConfig(
    arch_id="phi3-medium-14b",
    family="dense",
    d_model=5120,
    n_layers=40,
    n_heads=40,
    n_kv_heads=10,
    vocab_size=100352,
    max_seq_len=32768,
    period=(BlockSpec(mixer="attn",
                      ffn=FFNSpec(kind="dense", d_ff=17920,
                                  activation="swiglu")),),
    param_dtype=torch.bfloat16,
    accum_dtype=torch.bfloat16,
    remat="full",
    grad_accum=16,
)

# 16 leaves x 1120 = 17920 (exact width match)
FFF_CONFIG = CONFIG.with_ffn_kind("fff", leaf_width=1120)
