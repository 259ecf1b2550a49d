"""whisper-small [audio] — 12L d_model=768 12H (GQA kv=12) d_ff=3072
vocab=51865 — encoder-decoder; the conv frontend is a stub (the inputs are
precomputed frame embeddings).  [arXiv:2212.04356]

12 encoder + 12 decoder layers, GELU FFNs, LayerNorm with biases, learned
positions (decoder) / sinusoidal (encoder), cross-attention in every
decoder block.  The learned position table follows ``max_seq_len``
(32768 rows), not whisper's trained 448-token context."""
import torch

from repro_torch.configs.base import BlockSpec, EncoderSpec, FFNSpec, ModelConfig

_FFN = FFNSpec(kind="dense", d_ff=3072, activation="gelu")

CONFIG = ModelConfig(
    arch_id="whisper-small",
    family="audio",
    d_model=768,
    n_layers=12,
    n_heads=12,
    n_kv_heads=12,
    vocab_size=51865,
    max_seq_len=32768,
    pos_emb="learned",
    norm="layernorm",
    attn_bias=True,
    frontend="audio_stub",
    encoder=EncoderSpec(
        n_layers=12,
        period=(BlockSpec(mixer="attn", ffn=_FFN),),
        seq_len=1500,
    ),
    period=(BlockSpec(mixer="attn", ffn=_FFN, cross_attention=True),),
    param_dtype=torch.bfloat16,
    accum_dtype=torch.bfloat16,
    remat="full",
    grad_accum=16,
)

# 8 leaves x 384 = 3072 (exact width)
FFF_CONFIG = CONFIG.with_ffn_kind("fff", leaf_width=384)
