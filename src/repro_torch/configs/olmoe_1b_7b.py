"""olmoe-1b-7b [moe] — 16L d_model=2048 16H (GQA kv=16) d_ff=1024 (per expert)
vocab=50304, MoE 64 experts top-8.  [arXiv:2409.02060; hf]

FFF-for-MoE showcase: 64 experts = 2^6 exactly, so the tree replacement is
width-exact — forest of 8 trees (matching top-8), each depth 3 with leaf width
1024: 8 * 8 * 1024 = 65536 = 64 * 1024.  Inference width 8*1024 = top-8 active
width, but routing is O(8*3) node dots instead of an O(64) gate."""
import torch

from repro_torch.configs.base import BlockSpec, FFNSpec, ModelConfig

CONFIG = ModelConfig(
    arch_id="olmoe-1b-7b",
    family="moe",
    d_model=2048,
    n_layers=16,
    n_heads=16,
    n_kv_heads=16,
    vocab_size=50304,
    max_seq_len=32768,
    period=(BlockSpec(mixer="attn",
                      ffn=FFNSpec(kind="moe", d_ff=1024, activation="swiglu",
                                  moe_experts=64, moe_top_k=8)),),
    param_dtype=torch.bfloat16,
    accum_dtype=torch.bfloat16,
    remat="full",
    grad_accum=16,
)

FFF_CONFIG = CONFIG.with_ffn_kind("fff", leaf_width=1024, trees=8)
