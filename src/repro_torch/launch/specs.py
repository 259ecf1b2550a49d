"""Meta-device stand-ins for every model input of every (arch x shape) cell
(port of ``repro/launch/specs.py``): tensors with the shape and dtype the
entry point consumes and no storage, as JAX's ``ShapeDtypeStruct``s.

``input_specs(cfg, shape)`` returns the batch the entry point consumes:
  train:   {tokens|embeds [, enc_embeds], labels}
  prefill: {tokens|embeds [, enc_embeds]}
``decode_specs(cfg, shape)``: (token, caches, pos_offset), the caches at
``shape.seq_len`` capacity (``lm.init_caches`` on the meta device).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models import lm

META = torch.device("meta")


def struct(shape, dtype) -> torch.Tensor:
    """A meta tensor: a shape and a dtype, no storage."""
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def _token_batch(cfg: ModelConfig, B: int, S: int, with_labels: bool) -> dict:
    batch = {}
    if cfg.encoder is not None:
        batch["tokens"] = struct((B, S), torch.int32)
        batch["enc_embeds"] = struct((B, cfg.encoder.seq_len, cfg.d_model),
                                     cfg.param_dtype)
    elif cfg.frontend != "none":
        # a stub frontend: precomputed frame or patch embeddings
        batch["embeds"] = struct((B, S, cfg.d_model), cfg.param_dtype)
    else:
        batch["tokens"] = struct((B, S), torch.int32)
    if with_labels:
        batch["labels"] = struct((B, S), torch.int32)
    return batch


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """The batch of a train or prefill cell."""
    if shape.mode == "train":
        return _token_batch(cfg, shape.global_batch, shape.seq_len, True)
    if shape.mode == "prefill":
        return _token_batch(cfg, shape.global_batch, shape.seq_len, False)
    raise ValueError(f"decode shapes use decode_specs: {shape.name}")


def decode_specs(cfg: ModelConfig, shape: ShapeSpec) -> tuple:
    """(token, caches, pos_offset) of one decode step against caches of
    ``shape.seq_len`` positions."""
    B = shape.global_batch
    caches = lm.init_caches(cfg, B, shape.seq_len, dtype=cfg.param_dtype,
                            device=META)
    return struct((B, 1), torch.int32), caches, struct((), torch.int32)
