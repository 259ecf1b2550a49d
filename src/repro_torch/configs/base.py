"""Config schema (port of ``repro/configs/base.py``) with torch dtypes.

A model's layer stack is a repeated ``period`` of ``BlockSpec``s;
``FFNSpec.kind`` selects the paper's technique per FFN site.  Every field
of the JAX schema is here: attention, Mamba (``mamba_*``) and xLSTM
(``lstm_heads``) mixers, cross-attention decoder blocks over an
``EncoderSpec`` stack (whisper-small), the ``frontend`` stubs over
precomputed frame or patch embeddings, and learned or sinusoidal
positions.  ``attn_logit_softcap`` and ``scan_layers`` are recorded
fields: the JAX package reads no softcap, and the port unrolls its layers.
``zero_stage`` picks the training layout (``launch/train``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

from repro_torch import utils


@dataclasses.dataclass(frozen=True)
class FFNSpec:
    kind: str = "dense"            # dense|fff|moe|none
    d_ff: int = 0                  # dense: hidden width; moe/fff: per-expert/base width
    activation: str = "swiglu"
    # --- fff ---
    fff_leaf_width: int = 0
    fff_depth: int = 0
    fff_trees: int = 1
    fff_node_width: int = 1
    fff_st: bool = False
    fff_master_leaf: bool = False
    fff_master_width: int = 0
    hardening_scale: float = 1.0
    balance_scale: float = 0.0
    # --- moe ---
    moe_experts: int = 0
    moe_top_k: int = 2

    @property
    def training_width(self) -> int:
        if self.kind == "dense":
            return self.d_ff
        if self.kind == "moe":
            return self.moe_experts * self.d_ff
        if self.kind == "fff":
            return self.fff_trees * (2 ** self.fff_depth) * self.fff_leaf_width
        return 0

    @property
    def active_width(self) -> int:
        if self.kind == "dense":
            return self.d_ff
        if self.kind == "moe":
            return self.moe_top_k * self.d_ff
        if self.kind == "fff":
            return self.fff_trees * self.fff_leaf_width
        return 0

    def as_fff(self, leaf_width: int = 0, trees: int = 0) -> "FFNSpec":
        """Convert a dense/moe FFN site into the FFF replacement that keeps
        the training width (paper user-manual Case 1 / FFF-for-MoE)."""
        if self.kind == "none":
            return self
        total = self.training_width
        trees = trees or (self.moe_top_k if self.kind == "moe" else 1)
        leaf_width = leaf_width or max(1, self.d_ff // (16 if self.kind == "dense" else 1))
        per_tree = utils.cdiv(total, trees)
        depth = max(0, math.ceil(math.log2(max(1, utils.cdiv(per_tree, leaf_width)))))
        return dataclasses.replace(
            self, kind="fff", fff_leaf_width=leaf_width, fff_depth=depth,
            fff_trees=trees, fff_st=(self.kind == "moe"))


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    mixer: str = "attn"            # attn|mamba|mlstm|slstm
    ffn: FFNSpec = FFNSpec()
    cross_attention: bool = False  # decoder blocks of enc-dec models
    sliding_window: int = 0        # 0 = full attention


@dataclasses.dataclass(frozen=True)
class EncoderSpec:
    n_layers: int = 0
    period: Tuple[BlockSpec, ...] = ()
    seq_len: int = 0               # fixed encoder length (e.g. whisper frames)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                    # dense|moe|hybrid|ssm|vlm|audio
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    vocab_size: int
    period: Tuple[BlockSpec, ...]
    head_dim: int = 0              # 0 -> d_model // n_heads
    max_seq_len: int = 8192
    pos_emb: str = "rope"          # rope|learned|sinusoidal|none
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"          # rmsnorm|layernorm
    attn_bias: bool = False
    attn_logit_softcap: float = 0.0   # recorded; the JAX package reads none
    tie_embeddings: bool = False
    encoder: Optional[EncoderSpec] = None
    frontend: str = "none"         # none|audio_stub|vision_stub
    # mamba hyper-params (hybrid archs)
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    # xlstm hyper-params
    lstm_heads: int = 4
    # numerics
    param_dtype: Any = torch.float32
    accum_dtype: Any = torch.float32
    # runtime.  scan_layers is recorded: the port unrolls its layers
    scan_layers: bool = True
    remat: str = "none"
    grad_accum: int = 1
    # 1: params replicated over the data axes; 3: sharded over them too
    # (launch/train.train: sharding.Placements.of(fsdp=zero_stage >= 3))
    zero_stage: int = 1
    attn_chunk: int = 1024         # flash-attention chunk size
    subquadratic: bool = False

    def __post_init__(self):
        if self.n_layers % max(1, len(self.period)) != 0:
            raise ValueError(
                f"{self.arch_id}: n_layers={self.n_layers} not divisible by "
                f"period length {len(self.period)}")
        if self.n_heads % max(1, self.n_kv_heads) != 0:
            raise ValueError(f"{self.arch_id}: n_heads % n_kv_heads != 0")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def with_ffn_kind(self, kind: str, **fff_kw) -> "ModelConfig":
        """Swap every FFN site to dense/fff/moe — the --ffn flag."""
        def convert(b: BlockSpec) -> BlockSpec:
            if b.ffn.kind == "none":
                return b
            if kind == "fff":
                return dataclasses.replace(b, ffn=b.ffn.as_fff(**fff_kw))
            if kind == "dense":
                return dataclasses.replace(b, ffn=dataclasses.replace(
                    b.ffn, kind="dense", d_ff=b.ffn.training_width))
            return b
        enc = self.encoder
        if enc is not None and enc.period:
            enc = dataclasses.replace(
                enc, period=tuple(convert(b) for b in enc.period))
        return dataclasses.replace(
            self, period=tuple(convert(b) for b in self.period), encoder=enc)

    def reduced(self, n_layers: int = 0, d_model: int = 64, n_heads: int = 4,
                n_kv_heads: int = 0, vocab: int = 256, seq: int = 64
                ) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests."""
        n_layers = utils.round_up(n_layers or len(self.period), len(self.period))
        scale = d_model / self.d_model

        def shrink_ffn(f: FFNSpec) -> FFNSpec:
            if f.kind == "none":
                return f
            d_ff = max(8, int(f.d_ff * scale)) if f.d_ff else 0
            return dataclasses.replace(
                f, d_ff=min(d_ff, 4 * d_model) or 2 * d_model,
                moe_experts=min(f.moe_experts, 4) if f.moe_experts else 0,
                moe_top_k=min(f.moe_top_k, 2),
                fff_depth=min(f.fff_depth, 3),
                fff_leaf_width=min(f.fff_leaf_width, 16) or 0,
                fff_trees=min(f.fff_trees, 2))

        new_period = tuple(dataclasses.replace(b, ffn=shrink_ffn(b.ffn))
                           for b in self.period)
        nkv = n_kv_heads or max(1, min(self.n_kv_heads, n_heads))
        while n_heads % nkv:
            nkv -= 1
        enc = self.encoder
        if enc is not None:
            enc = dataclasses.replace(
                enc, n_layers=len(enc.period) if enc.period else 0,
                period=tuple(dataclasses.replace(b, ffn=shrink_ffn(b.ffn))
                             for b in enc.period),
                seq_len=min(enc.seq_len, 32) or 32)
        return dataclasses.replace(
            self, n_layers=n_layers,
            d_model=d_model, n_heads=n_heads, n_kv_heads=nkv, head_dim=0,
            vocab_size=vocab, max_seq_len=seq, period=new_period, encoder=enc,
            scan_layers=False, attn_chunk=32, remat="none",
            param_dtype=torch.float32, accum_dtype=torch.float32)
