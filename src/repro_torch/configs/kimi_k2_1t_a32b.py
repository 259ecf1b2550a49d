"""kimi-k2-1t-a32b [moe] — 61L d_model=7168 64H (GQA kv=8) d_ff=2048 (per
expert) vocab=163840, MoE 384 experts top-8 — trillion-param MoE.
[arXiv:2501.kimi2; unverified]

FFF-for-MoE at the trillion scale: a forest of 8 trees (the top-8 active
width), each of depth 6 (64 leaves) with leaf width 2048: a training width
of 8*64*2048 = 1,048,576 neurons against the MoE's 384*2048 = 786,432.
Routing drops from an O(384) gate to 8 * 6 node dot-products."""
import torch

from repro_torch.configs.base import BlockSpec, FFNSpec, ModelConfig

CONFIG = ModelConfig(
    arch_id="kimi-k2-1t-a32b",
    family="moe",
    d_model=7168,
    n_layers=61,
    n_heads=64,
    n_kv_heads=8,
    head_dim=112,
    vocab_size=163840,
    max_seq_len=32768,
    period=(BlockSpec(mixer="attn",
                      ffn=FFNSpec(kind="moe", d_ff=2048, activation="swiglu",
                                  moe_experts=384, moe_top_k=8)),),
    param_dtype=torch.bfloat16,
    accum_dtype=torch.bfloat16,
    remat="full",
    grad_accum=16,
    zero_stage=3,
)

FFF_CONFIG = CONFIG.with_ffn_kind("fff", leaf_width=2048, trees=8)
