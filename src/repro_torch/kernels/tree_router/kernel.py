"""Wrapper of the CUDA tree_router kernel (``csrc/tree_router.cu``), which
replaces the Pallas TPU kernel ``repro/kernels/tree_router/kernel.py::
tree_router``: the hard descent of a token batch down one tree of collapsed
node hyperplanes, f32 accumulation, ties right.  CPU tensors run the plain
version in ``ref.py``.

``plan`` chooses, from the shapes alone, the form a call takes:

- ``resident`` (float32, D <= ``RESIDENT_MAX_D``, the node matrix within one
  block's shared memory): one persistent block an SM holds node_w and node_b
  in shared memory, and each token descends one node a level, ``lanes``
  lanes a token;
- ``cluster`` (every bf16 shape, and float32 past those limits): a
  thread-block cluster per 64-token tile splits D over its blocks, computes
  every node logit and sums the blocks' partials through distributed shared
  memory.

One launch per call; a launch the card refuses (a cluster, tensor map or
shared-memory size it cannot take) raises here.  Each launch counts under
its form in ``KERNEL.paths``."""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch import utils
from repro_torch.kernels import common
from repro_torch.kernels.tree_router import ref as R

P, I = common.P, common.I

KERNEL = common.register(common.Kernel(
    "tree_router", "tree_router.cu", "tree_router",
    [P, P, P, P] + [I] * 10 + [P],
    replaces="src/repro/kernels/tree_router/kernel.py:55"))

#: path codes the C entry point takes
PATH_CODES = {"cluster": 0, "resident": 1}
H100_SMS = common.H100_SMS
#: the H100's most dynamic shared memory a block (227 KB)
SMEM_MAX = 232448
#: the resident form: the widest D it takes (32 lanes of 8 float4 pieces:
#: with the next token's row in flight, 64 floats of x a lane); the lanes a
#: token ``resident_lanes`` gives a wide batch (a warp descends 8 tokens at
#: once), and the fewest levels and widest D it does so for; the fewest
#: lanes a token otherwise, and the most float4 pieces a lane they hold (8
#: lanes up to D 128: a shorter chain a level); the fewest and most warps a
#: block
RESIDENT_MAX_D, WIDE_LANES, WIDE_MIN_DEPTH, WIDE_MAX_D = 1024, 4, 4, 128
NARROW_MIN_LANES, NARROW_VECS = 8, 4
RESIDENT_MIN_WARPS, RESIDENT_MAX_WARPS = 4, 16
#: the cluster form: tokens a tile, and the most tiles a grid of 16-block
#: clusters has (else 8 blocks a cluster)
CLUSTER_TOKENS, CLUSTER_SMALL_GRID = 64, 8


class Plan(NamedTuple):
    path: str    # "resident" or "cluster"
    lanes: int   # resident: lanes a token (4, 8, 16 or 32); cluster: 0
    vecs: int    # resident: float4 pieces of x a lane (1, 2, 4 or 8); cluster: 0
    warps: int   # warps a block
    smem: int    # resident: dynamic shared memory a block, bytes; cluster: 0
                 # (the kernel sizes its ring by depth)
    grid: int    # blocks launched


@functools.lru_cache(maxsize=4096)
def plan(B: int, D: int, depth: int, dtype: torch.dtype = torch.float32,
         sms: int = H100_SMS) -> Plan:
    """The launch of one router call on x (B, D) down a tree of ``depth``
    levels.  float32 with D <= ``RESIDENT_MAX_D`` whose node rows and biases
    fit ``SMEM_MAX`` (``resident_smem``) takes the resident form: at D 128
    every depth 1-8, at D 1024 depths 1-5, at depth 8 D up to 224.  Its
    lanes a token (``resident_lanes``), the float4 pieces of a row a lane
    then holds, the fewest warps a block (4-16) that give every token a
    group of lanes at once on ``sms`` blocks, and a grid of min(SMs, the
    blocks that do).  Everything else takes the cluster form of 8 warps a
    block, whose grid is the kernel's own: ceil(B / 64) tiles of 16 blocks
    up to 8 tiles, else of 8."""
    if B < 1 or D < 1 or not 1 <= depth <= 8:
        raise ValueError(f"router plan needs positive sizes and 1 <= depth <= 8, "
                         f"got B={B} D={D} depth={depth}")
    cdiv = utils.cdiv
    if dtype == torch.float32 and D <= RESIDENT_MAX_D and resident_smem(D, depth) <= SMEM_MAX:
        lanes = resident_lanes(B, D, depth, sms)
        vecs = _pow2(cdiv(cdiv(D, 4), lanes))
        per_warp = 32 // lanes                            # tokens a warp takes at once
        warps = min(RESIDENT_MAX_WARPS, max(RESIDENT_MIN_WARPS, cdiv(B, sms * per_warp)))
        return Plan("resident", lanes, vecs, warps, resident_smem(D, depth),
                    min(sms, cdiv(B, warps * per_warp)))
    tiles = cdiv(B, CLUSTER_TOKENS)
    cluster = 16 if tiles <= CLUSTER_SMALL_GRID else 8
    return Plan("cluster", 0, 0, 8, 0, tiles * cluster)


def _pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def resident_lanes(B: int, D: int, depth: int, sms: int = H100_SMS) -> int:
    """The resident form's lanes a token: ``WIDE_LANES`` for a wide batch
    (more tokens than every SM's most warps hold at ``NARROW_MIN_LANES``
    lanes a token) down at least ``WIDE_MIN_DEPTH`` levels with D <=
    ``WIDE_MAX_D``: the descent is then bound by the SM's shared-memory and
    shuffle pipe rather than by one level's chain of latencies.  Else the
    fewest, at least ``NARROW_MIN_LANES`` (a power of two), that hold the
    row's float4 pieces in at most ``NARROW_VECS`` a lane, at most 32 (8 up
    to D 128, 16 up to D 256, 32 past it)."""
    wide = B > sms * RESIDENT_MAX_WARPS * (32 // NARROW_MIN_LANES)
    if wide and depth >= WIDE_MIN_DEPTH and D <= WIDE_MAX_D:
        return WIDE_LANES
    return min(32, max(NARROW_MIN_LANES, _pow2(utils.cdiv(utils.cdiv(D, 4), NARROW_VECS))))


def resident_smem(D: int, depth: int) -> int:
    """The resident form's shared memory: N node rows of whole float4
    pieces (zero past D), then N biases."""
    N = 2 ** depth - 1
    return N * utils.cdiv(D, 4) * 16 + N * 4


def tree_router(x: torch.Tensor, node_w: torch.Tensor, node_b: torch.Tensor,
                *, depth: int) -> torch.Tensor:
    """x (B, D), node_w (N, D), node_b (N,) with N = 2^depth - 1, one dtype
    (float32 or bfloat16) -> (B,) int32 leaf indices.  Unlike the Pallas
    kernel, B need not be a multiple of a tile: the kernel masks its ragged
    last tile itself."""
    common.forward_only("tree_router", x, node_w, node_b)
    if x.device.type == "cpu":
        return R.tree_router_ref(x, node_w, node_b, depth=depth)
    return _launch(x, node_w, node_b, depth)


def _launch(x, node_w, node_b, depth):
    """The CUDA branch: operand checks, output allocation, the launch, its
    count by form."""
    B, D = x.shape
    N = 2 ** depth - 1
    if not 1 <= depth <= 8:
        raise ValueError(f"tree_router kernel takes 1 <= depth <= 8, got {depth}")
    common.check(x, "x")
    common.check(node_w, "node_w", like=x, shape=(N, D))
    common.check(node_b, "node_b", like=x, shape=(N,))
    out = torch.empty(B, dtype=torch.int32, device=x.device)
    if B == 0:
        return out
    p = plan(B, D, depth, x.dtype, common.sm_count(x.get_device()))
    KERNEL.launch(x.data_ptr(), node_w.data_ptr(), node_b.data_ptr(),
                  out.data_ptr(), B, D, depth, common.dtype_code(x),
                  PATH_CODES[p.path], p.lanes, p.vecs, p.warps, p.grid,
                  *common.stream_of(x))
    KERNEL.paths[p.path] = KERNEL.paths.get(p.path, 0) + 1
    return out
