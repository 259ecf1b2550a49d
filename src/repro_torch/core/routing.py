"""Token-to-leaf dispatch helpers (port of ``repro/core/routing.py``).  This
slice needs only the slotting that ``kernels/leaf_gemm`` scatters with; the
capacity-bounded grouped and expert-parallel dispatchers arrive with the
grouped backends."""
from __future__ import annotations

import torch


def group_slots(leaf_idx: torch.Tensor, num_groups: int) -> torch.Tensor:
    """Per-token slot index within its routed group, O(B log B).

    slot[i] = |{j : leaf[j] == leaf[i], j < i}|, computed from sort ranks:
    rank_in_sorted(i) - group_offset(leaf[i]) — never a (B, E) cumsum of a
    one-hot.  Ids >= ``num_groups`` (the sentinel leaf) are slotted as one
    more group after the real ones."""
    B = leaf_idx.shape[0]
    idx = leaf_idx.long()
    sort_idx = torch.argsort(idx, stable=True)
    rank = torch.empty(B, dtype=torch.int64, device=idx.device)
    rank[sort_idx] = torch.arange(B, device=idx.device)
    sizes = torch.bincount(idx.clamp(max=num_groups), minlength=num_groups + 1)
    offsets = torch.cumsum(sizes, 0) - sizes                  # exclusive scan
    return rank - offsets[idx.clamp(max=num_groups)]
