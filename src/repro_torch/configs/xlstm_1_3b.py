"""xlstm-1.3b [ssm] — 48L d_model=2048 4H (GQA kv=4) d_ff=0 vocab=50304 —
sLSTM + mLSTM blocks (xLSTM[7:1]: seven mLSTM per sLSTM).
[arXiv:2405.04517; unverified]

d_ff = 0: these blocks have no FFN site; the up and down projections
inside the mLSTM block belong to the recurrence (pre-up-projection
design), not to a replaceable feedforward layer, so the FFF technique does
not apply and the arch runs FFF-free.  Constant-state recurrence."""
import torch

from repro_torch.configs.base import BlockSpec, FFNSpec, ModelConfig

_NONE = FFNSpec(kind="none")

CONFIG = ModelConfig(
    arch_id="xlstm-1.3b",
    family="ssm",
    d_model=2048,
    n_layers=48,
    n_heads=4,
    n_kv_heads=4,
    lstm_heads=4,
    vocab_size=50304,
    max_seq_len=524288,
    pos_emb="none",
    subquadratic=True,
    period=(
        BlockSpec(mixer="mlstm", ffn=_NONE),
        BlockSpec(mixer="mlstm", ffn=_NONE),
        BlockSpec(mixer="mlstm", ffn=_NONE),
        BlockSpec(mixer="mlstm", ffn=_NONE),
        BlockSpec(mixer="mlstm", ffn=_NONE),
        BlockSpec(mixer="mlstm", ffn=_NONE),
        BlockSpec(mixer="mlstm", ffn=_NONE),
        BlockSpec(mixer="slstm", ffn=_NONE),
    ),
    param_dtype=torch.bfloat16,
    accum_dtype=torch.bfloat16,
    remat="full",
    grad_accum=16,
)

# no FFN site: FFF_CONFIG is CONFIG
FFF_CONFIG = CONFIG
