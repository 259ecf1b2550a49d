"""The collectives the port runs over gloo process groups, and their
transport for tensors on the card.

gloo reduces on the host.  It takes CUDA tensors too, copying them to host
memory itself; copying through pinned host memory first costs about as
much (``chip_smoke.py``'s model_parallel phase times both) and counts what
it moves.  So a CUDA tensor goes to pinned host memory, the collective
runs there, and the result comes back: the transport of a layout whose
ranks share one card, where the leaf GEMMs still run in the card's
kernels.  ``staged_bytes`` counts the bytes this transport copies
(host-bound plus card-bound) in this process.

A group of None is an axis of one rank: every collective is then the
identity.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

_staged = [0]


def staged_bytes() -> int:
    """Bytes copied between the card and pinned host memory for
    collectives since the last ``reset_staged`` (both directions)."""
    return _staged[0]


def reset_staged() -> None:
    _staged[0] = 0


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    if not t.is_cuda:
        return t.contiguous()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    _staged[0] += t.numel() * t.element_size()
    return host


def _to_card(host: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if not like.is_cuda:
        return host
    _staged[0] += host.numel() * host.element_size()
    return host.to(like.device)


def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in group-rank order."""
    n = group_size(group)
    if n == 1:
        return t
    if t.dtype == torch.bool:
        return all_gather_cat(t.to(torch.uint8), group, dim).bool()
    src = _to_host(t).reshape(-1)
    # every rank's flat tensor in turn, in one pinned buffer
    out = torch.empty(n * src.numel(), dtype=t.dtype, pin_memory=t.is_cuda)
    dist.all_gather_into_tensor(out, src, group=group)
    parts = _to_card(out, t).view((n,) + tuple(t.shape))
    if dim == 0:
        return parts.reshape((n * t.shape[0],) + tuple(t.shape[1:]))
    return torch.cat(parts.unbind(0), dim=dim)


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The reduction of every rank's ``t`` (a new tensor; ``t`` is left
    as it is).  Floating tensors of 16 bits reduce in float32."""
    if group_size(group) == 1:
        return t
    wide = t.dtype in (torch.bfloat16, torch.float16)
    buf = _to_host(t.float() if wide else t)
    if buf is t:
        buf = t.clone()
    dist.all_reduce(buf, op=op, group=group)
    out = _to_card(buf, t)
    return out.to(t.dtype) if wide else out


def all_to_all_single(send: torch.Tensor, group) -> torch.Tensor:
    """``send``'s dim 0 split evenly over the group, block ``j`` to rank
    ``j``; returns the received blocks in source-rank order."""
    if group_size(group) == 1:
        return send
    src = _to_host(send)
    recv = torch.empty(send.shape, dtype=send.dtype, pin_memory=send.is_cuda)
    dist.all_to_all_single(recv, src, group=group)
    return _to_card(recv, send)


def barrier() -> None:
    """Every rank of the world meets here (nothing without a world)."""
    if dist.is_initialized():
        dist.barrier()
