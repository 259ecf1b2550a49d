"""internlm2-20b [dense] — 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92544, SwiGLU, RMSNorm, RoPE.  [arXiv:2403.17297; hf]"""
import torch

from repro_torch.configs.base import BlockSpec, FFNSpec, ModelConfig

CONFIG = ModelConfig(
    arch_id="internlm2-20b",
    family="dense",
    d_model=6144,
    n_layers=48,
    n_heads=48,
    n_kv_heads=8,
    vocab_size=92544,
    max_seq_len=32768,
    rope_theta=1_000_000.0,
    period=(BlockSpec(mixer="attn",
                      ffn=FFNSpec(kind="dense", d_ff=16384,
                                  activation="swiglu")),),
    param_dtype=torch.bfloat16,
    accum_dtype=torch.bfloat16,
    remat="full",
    grad_accum=16,
)

# The paper's technique (Case 1, exact width match): 16 leaves x 1024 =
# 16384 training width; inference width 1024 (1/16).
FFF_CONFIG = CONFIG.with_ffn_kind("fff", leaf_width=1024)
