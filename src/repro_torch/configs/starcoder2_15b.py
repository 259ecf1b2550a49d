"""starcoder2-15b [dense] — 40L d_model=6144 48H (GQA kv=4) d_ff=24576
vocab=49152, GQA, RoPE, sliding-window 4096, GELU, LayerNorm, biases.
[arXiv:2402.19173; hf]"""
import torch

from repro_torch.configs.base import BlockSpec, FFNSpec, ModelConfig

CONFIG = ModelConfig(
    arch_id="starcoder2-15b",
    family="dense",
    d_model=6144,
    n_layers=40,
    n_heads=48,
    n_kv_heads=4,
    vocab_size=49152,
    max_seq_len=32768,
    norm="layernorm",
    attn_bias=True,
    period=(BlockSpec(mixer="attn", sliding_window=4096,
                      ffn=FFNSpec(kind="dense", d_ff=24576,
                                  activation="gelu")),),
    param_dtype=torch.bfloat16,
    accum_dtype=torch.bfloat16,
    remat="full",
    grad_accum=16,
)

# 16 leaves x 1536 = 24576 (exact width match)
FFF_CONFIG = CONFIG.with_ffn_kind("fff", leaf_width=1536)
