"""Wrapper of the CUDA fused decode kernel (``csrc/fused_decode.cu``), which
replaces the Pallas TPU megakernel ``repro/kernels/fused_decode/kernel.py::
fused_forest_decode``: tree routing, the routed leaf's MLP, the forest
combine and the optional master leaf in one launch.  CPU tensors run the
plain version in ``ref.py``."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import common
from repro_torch.kernels.fused_decode import ref as R

P, I = common.P, common.I

KERNEL = common.register(common.Kernel(
    "fused_forest_decode", "fused_decode.cu", "fused_forest_decode",
    [P] * 13 + [I] * 11 + [P],
    replaces="src/repro/kernels/fused_decode/kernel.py:175"))


def fused_forest_decode(x: torch.Tensor, nw: torch.Tensor, nb: torch.Tensor,
                        leaf_w: tuple, *, depth: int, act: str = "gelu",
                        master_w: Optional[tuple] = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch: route + selected-leaf MLP + forest combine.

    x (B, D); nw (T, N, D), nb (T, N) collapsed node hyperplanes with
    N = 2^depth - 1; ``leaf_w`` = (w1 (T, E, D, l), w2 (T, E, l, O)) or,
    with ``act="swiglu"``, (wg, wu (T, E, D, l), wd (T, E, l, O));
    ``master_w`` optional, the same minus the (T, E) axes.  All one dtype.
    Returns ``(y (B, O) in x's dtype, leaf_idx (B, T) int32)``."""
    common.forward_only("fused_forest_decode", x, nw, nb, leaf_w, master_w)
    if x.device.type == "cpu":
        return R.fused_decode_ref(x, nw, nb, leaf_w, depth=depth, act=act,
                                  master_w=master_w)
    return _launch(x, nw, nb, leaf_w, depth, act, master_w)


def slots(trees: int, leaf_width: int, master_width: int) -> int:
    """The kernel's blocks per token, each owning 32 hidden units of one
    tree's routed leaf or of the master leaf (``master_width`` 0 when
    absent): the partial-output slots the wrapper allocates."""
    return trees * -(-leaf_width // 32) + -(-master_width // 32)


def _launch(x, nw, nb, leaf_w, depth, act, master_w):
    """The CUDA branch: operand checks, output and scratch allocation, the
    launch."""
    B, D = x.shape
    T, N, _ = nw.shape
    if depth < 1 or N != 2 ** depth - 1:
        raise ValueError(f"need N = 2^depth - 1 >= 1 nodes, got N={N}, "
                         f"depth={depth}")
    if (len(leaf_w) == 3) != (act == "swiglu"):
        raise ValueError(f"{len(leaf_w)} leaf weights do not fit act={act!r}")
    if act not in common.ACT_CODES:
        raise ValueError(f"unknown act {act!r}")
    E, l, O = leaf_w[0].shape[1], leaf_w[0].shape[3], leaf_w[-1].shape[3]
    common.check(x, "x")
    common.check(nw, "nw", like=x, shape=(T, N, D))
    common.check(nb, "nb", like=x, shape=(T, N))
    for w in leaf_w[:-1]:
        common.check(w, "leaf up weight", like=x, shape=(T, E, D, l))
    common.check(leaf_w[-1], "leaf down weight", like=x, shape=(T, E, l, O))
    mw = 0
    if master_w is not None:
        if len(master_w) != len(leaf_w):
            raise ValueError("master leaf must have the leaves' form")
        mw = master_w[0].shape[1]
        for w in master_w[:-1]:
            common.check(w, "master up weight", like=x, shape=(D, mw))
        common.check(master_w[-1], "master down weight", like=x,
                     shape=(mw, O))
    swiglu = act == "swiglu"
    up, up3 = leaf_w[0], (leaf_w[1] if swiglu else None)
    m_up = m_up3 = m_down = None
    if master_w is not None:
        m_up, m_up3, m_down = master_w[0], (master_w[1] if swiglu else None), master_w[-1]
    y = torch.empty((B, O), dtype=x.dtype, device=x.device)
    leaf_idx = torch.empty((B, T), dtype=torch.int32, device=x.device)
    if B == 0:
        return y, leaf_idx
    # one f32 slot per block of a token (32 hidden units of a tree's leaf
    # or of the master leaf), summed in slot order by the token's last block
    part = torch.empty((slots(T, l, mw), B, O), dtype=torch.float32,
                       device=x.device)
    counter = torch.zeros(B, dtype=torch.int32, device=x.device)
    p = common.ptr
    KERNEL.launch(p(x), p(nw), p(nb), p(up), p(up3), p(leaf_w[-1]),
                  p(m_up), p(m_up3), p(m_down), p(y), p(part), p(counter),
                  p(leaf_idx), B, D, T, depth, E, l, O, mw,
                  common.ACT_CODES[act], common.dtype_code(x),
                  *common.stream_of(x))
    return y, leaf_idx
