"""Rotary position embeddings (port of ``repro/nn/rope.py``): the rotation
acts on split halves of the head dimension, not interleaved pairs; plus
the sinusoidal absolute table of whisper's encoder."""
from __future__ import annotations

import torch


def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     device="cpu") -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotate (..., S, H, head_dim) by per-position angles; positions
    (..., S) are absolute (KV-cache decode passes the cache offsets)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)       # (hd/2,)
    angles = positions[..., None].float() * freqs                # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                        # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_embedding(seq_len: int, dim: int, max_timescale: float = 10000.0,
                         device="cpu") -> torch.Tensor:
    """The sinusoidal table (S, D), float32, whisper's formula: the sines of
    ``dim // 2`` timescales then their cosines, timescale ``i`` being
    ``max_timescale ** (i / max(dim // 2 - 1, 1))``."""
    half = dim // 2
    inv = 1.0 / (max_timescale ** (torch.arange(half, dtype=torch.float32,
                                                device=device) / max(half - 1, 1)))
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None] * inv[None, :]
    return torch.cat([torch.sin(pos), torch.cos(pos)], dim=-1)
