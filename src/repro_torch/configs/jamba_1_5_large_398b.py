"""jamba-1.5-large-398b [hybrid] — 72L d_model=8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16e top-2, Mamba+attn 1:7 interleave.
[arXiv:2403.19887; hf]

A period of 8: seven Mamba blocks then one attention block (1:7); an MoE
FFN on every other block, a dense FFN otherwise (Jamba's alternating
pattern).  Constant-state Mamba with 1/8 attention is sub-quadratic."""
import torch

from repro_torch.configs.base import BlockSpec, FFNSpec, ModelConfig

_MOE = FFNSpec(kind="moe", d_ff=24576, activation="swiglu",
               moe_experts=16, moe_top_k=2)
_DENSE = FFNSpec(kind="dense", d_ff=24576, activation="swiglu")

CONFIG = ModelConfig(
    arch_id="jamba-1.5-large-398b",
    family="hybrid",
    d_model=8192,
    n_layers=72,
    n_heads=64,
    n_kv_heads=8,
    vocab_size=65536,
    max_seq_len=524288,
    mamba_d_state=16,
    mamba_d_conv=4,
    mamba_expand=2,
    subquadratic=True,
    period=(
        BlockSpec(mixer="mamba", ffn=_MOE),
        BlockSpec(mixer="mamba", ffn=_DENSE),
        BlockSpec(mixer="mamba", ffn=_MOE),
        BlockSpec(mixer="mamba", ffn=_DENSE),
        BlockSpec(mixer="mamba", ffn=_MOE),
        BlockSpec(mixer="mamba", ffn=_DENSE),
        BlockSpec(mixer="mamba", ffn=_MOE),
        BlockSpec(mixer="attn", ffn=_DENSE),
    ),
    param_dtype=torch.bfloat16,
    accum_dtype=torch.bfloat16,
    remat="full",
    grad_accum=16,
    zero_stage=3,
)

# MoE sites -> a forest of 2 (top-2) trees of depth 3 (8 leaves) x leaf
# 24576: width-exact (2*8*24576 = 16*24576).  Dense sites -> one tree of
# 16 leaves x 1536.
FFF_CONFIG = CONFIG.with_ffn_kind("fff", leaf_width=0, trees=0)
