"""command-r-35b [dense] — 40L d_model=8192 64H (GQA kv=8) d_ff=22528
vocab=256000, GQA, no biases, tied embeddings.
[hf:CohereForAI/c4ai-command-r-v01; unverified]"""
import torch

from repro_torch.configs.base import BlockSpec, FFNSpec, ModelConfig

CONFIG = ModelConfig(
    arch_id="command-r-35b",
    family="dense",
    d_model=8192,
    n_layers=40,
    n_heads=64,
    n_kv_heads=8,
    vocab_size=256000,
    max_seq_len=32768,
    norm="layernorm",
    attn_bias=False,
    tie_embeddings=True,
    rope_theta=8_000_000.0,
    period=(BlockSpec(mixer="attn",
                      ffn=FFNSpec(kind="dense", d_ff=22528,
                                  activation="swiglu")),),
    param_dtype=torch.bfloat16,
    accum_dtype=torch.bfloat16,
    remat="full",
    grad_accum=16,
)

# 16 leaves x 1408 = 22528 (exact width match)
FFF_CONFIG = CONFIG.with_ffn_kind("fff", leaf_width=1408)
