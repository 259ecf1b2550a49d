"""Roofline terms of a dry-run cell (port of ``repro/launch/roofline.py``),
re-based from the TPU v5e's peaks to one NVIDIA H100 SXM's, each a figure
of NVIDIA's data sheets:

  T_compute    = FLOPs a rank / 989e12            [dense bf16, H100 SXM]
  T_memory     = HBM bytes a rank / 3.35e12       [HBM3, H100 SXM]
  T_collective = NVLink bytes a rank / 900e9      [NVLink, H100 SXM]
               + InfiniBand bytes a rank / 50e9   [one ConnectX-7 400 Gb/s
                                                   port a GPU, DGX H100]

The JAX package reads FLOPs and bytes from the compiled XLA module and its
collectives from the optimized HLO.  The port has no HLO: ``launch/
dryrun`` counts FLOPs with ``torch.utils.flop_counter`` on meta tensors and
fills ``CollectiveStats`` from the parameter placements, the all-gathers
of ``distributed/sharding.gathered`` and the all-reduces of its backward
and of ``reduce_gradients``.  A collective whose group spans more than one
8-GPU NVLink node (ranks ``8n .. 8n + 7``) crosses InfiniBand.

``param_counts``, ``attention_model_flops`` and ``model_flops`` (the
useful-work side: 6 N D in training, 2 N D at inference, over the active
parameters, plus the quadratic attention term) are the JAX package's
formulas unchanged.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig, ShapeSpec

PEAK_FLOPS = 989e12          # dense bf16 a GPU (H100 SXM data sheet)
HBM_BW = 3.35e12             # bytes/s a GPU (H100 SXM data sheet)
NVLINK_BW = 900e9            # bytes/s a GPU (H100 SXM data sheet)
IB_BW = 50e9                 # bytes/s a GPU: one 400 Gb/s ConnectX-7 port
NODE_GPUS = 8                # GPUs a node on one NVLink domain (DGX H100)


@dataclasses.dataclass
class CollectiveStats:
    op: str                  # all-reduce | all-gather | reduce-scatter | ...
    bytes_result: int
    group_size: int
    crosses_node: bool
    count: int = 1

    @property
    def bytes_moved(self) -> float:
        """Ring-algorithm bytes per participant."""
        n = max(self.group_size, 1)
        frac = (n - 1) / n
        if self.op == "all-reduce":
            return 2 * self.bytes_result * frac
        if self.op in ("all-gather", "reduce-scatter", "all-to-all"):
            return self.bytes_result * frac
        return self.bytes_result        # collective-permute


@dataclasses.dataclass
class RooflineTerms:
    flops: float
    bytes_hbm: float
    bytes_nvlink: float
    bytes_ib: float
    chips: int
    t_compute: float
    t_memory: float
    t_collective: float
    model_flops: float
    useful_ratio: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def roofline_fraction(self) -> float:
        """useful model FLOPs / (chips * peak * max-term): the score."""
        t = max(self.t_compute, self.t_memory, self.t_collective)
        if t <= 0:
            return 0.0
        return self.model_flops / (self.chips * PEAK_FLOPS * t)


def analyze_terms(flops: float, bytes_hbm: float,
                  colls: list[tuple[CollectiveStats, int]], chips: int,
                  model_flops: float) -> RooflineTerms:
    """``flops`` and ``bytes_hbm`` are a rank's; each collective carries a
    repetition multiplier (micro-steps a step)."""
    bytes_nvlink = sum(c.bytes_moved * c.count * mult
                       for c, mult in colls if not c.crosses_node)
    bytes_ib = sum(c.bytes_moved * c.count * mult
                   for c, mult in colls if c.crosses_node)
    t_compute = flops / PEAK_FLOPS
    t_memory = bytes_hbm / HBM_BW
    t_collective = bytes_nvlink / NVLINK_BW + bytes_ib / IB_BW
    useful = model_flops / max(flops * chips, 1.0)
    return RooflineTerms(flops, bytes_hbm, bytes_nvlink, bytes_ib, chips,
                         t_compute, t_memory, t_collective, model_flops, useful)


# ---------------------------------------------------------------------------
# MODEL_FLOPS: 6*N*D (train) / 2*N*D (inference), N = *active* params
# ---------------------------------------------------------------------------

def param_counts(cfg: ModelConfig, total_params: int, mode: str = "decode"
                 ) -> tuple[int, int]:
    """(total, effective) parameter counts.  The inactive mass is the
    conditional FFN width a pass never touches: MoE experts not selected,
    FFF leaves not selected.  FORWARD_T training (the ``train/reference``
    backend) evaluates every leaf, and all of them take a gradient, so
    that compute counts as useful; straight-through trained sites and
    every inference backend touch only the routed leaf or forest."""
    inactive = 0
    n_periods = cfg.n_layers // len(cfg.period)
    for spec in cfg.period:
        f = spec.ffn
        kk = 3 if f.activation == "swiglu" else 2
        if f.kind == "moe" or (f.kind == "fff"
                               and (mode != "train" or f.fff_st)):
            inactive += (f.training_width - f.active_width) * kk \
                * cfg.d_model * n_periods
    return total_params, total_params - inactive


def attention_model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """The quadratic attention term of the useful model FLOPs (the PaLM MFU
    convention); without it, useful-compute ratios mean nothing for small
    models at long context."""
    n_attn = sum(1 for b in cfg.period if b.mixer == "attn") \
        * (cfg.n_layers // len(cfg.period))
    H, hd = cfg.n_heads, cfg.resolved_head_dim
    window = min((b.sliding_window or shape.seq_len)
                 for b in cfg.period if b.mixer == "attn") \
        if n_attn else 0
    if shape.mode == "decode":
        ctx = min(shape.seq_len, window or shape.seq_len)
        per_token = 2 * 2 * ctx * H * hd              # qk + pv vs full cache
        tokens = shape.global_batch
        factor = 1.0
    else:
        s_eff = min(shape.seq_len, window or shape.seq_len)
        # causal lower-triangle average context = s_eff/2
        per_token = 2 * 2 * (s_eff / 2) * H * hd
        tokens = shape.global_batch * shape.seq_len
        factor = 3.0 if shape.mode == "train" else 1.0
    total = factor * n_attn * per_token * tokens
    if cfg.encoder is not None and shape.mode != "decode":
        enc_tokens = shape.global_batch * cfg.encoder.seq_len
        total += factor * cfg.encoder.n_layers * 2 * 2 * cfg.encoder.seq_len \
            * H * hd * enc_tokens / 2
    return total


def model_flops(cfg: ModelConfig, shape: ShapeSpec, total_params: int,
                embed_params: int = 0) -> float:
    """6*N*D (train) / 2*N*D (inference) over the *effective* params, plus
    the quadratic attention term (the PaLM MFU convention)."""
    _, eff = param_counts(cfg, total_params, shape.mode)
    n = eff - embed_params
    tokens = shape.global_batch * (shape.seq_len if shape.mode != "decode"
                                   else 1)
    factor = 6.0 if shape.mode == "train" else 2.0
    return factor * n * tokens + attention_model_flops(cfg, shape)
