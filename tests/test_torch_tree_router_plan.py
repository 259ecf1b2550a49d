"""The router wrapper's launch plan (``kernels/tree_router/kernel.py::plan``),
on the CPU: which form each shape takes, the resident form's lanes, float4
pieces, warps, shared memory and grid, and the cluster form's grid.  The
kernel itself runs on the card (``chip_smoke.py``); these shapes are the
ones it and the port launch: the paper ViT's float32 sites (D 128, depths
1-8), the edges of the resident form's limits, the starcoder2 draft's
float32 router (D 6144) and every bf16 site.
"""
from __future__ import annotations

import pytest
import torch

from repro_torch import utils
from repro_torch.kernels.tree_router import kernel as trk

torch.set_num_threads(1)

BF16, F32 = torch.bfloat16, torch.float32
SMS = trk.H100_SMS

# (B, D, depth): the ViT's sites at its eval batch (16384 tokens), the
# FFN-site timing's batch (2048), one token and a ragged batch
VIT = [(B, 128, depth) for depth in range(1, 9) for B in (1, 33, 2048, 16384)]
# the resident form's limits: the last shape on it and the first past it
RESIDENT_EDGES = [(1024, 1024, 5), (1024, 224, 8), (1024, 456, 7), (1024, 920, 6),
                  (1024, 100, 8), (1024, 4, 8), (1, 1, 1)]
PAST_EDGES = [(1024, 1025, 1), (1024, 1025, 5), (1024, 1024, 6), (1024, 225, 8),
              (1024, 457, 7), (1024, 921, 6)]
# float32 at the starcoder2 draft's width, and every bf16 router site:
# internlm2-20b's prefill and verify slab, the arch sites (phi3, starcoder2,
# command-r, olmoe, kimi, jamba's two trees, whisper), the CPU tests' widths
DRAFT_F32 = [(B, 6144, depth) for depth in (3, 4) for B in (32, 1024)]
BF16_SITES = [(B, D, depth) for B in (1, 32, 256, 1024)
              for D, depth in ((6144, 4), (5120, 4), (8192, 4), (2048, 3), (7168, 6),
                               (8192, 3), (768, 3), (128, 7), (20, 5), (24, 8))]


def _per_warp(p):
    return 32 // p.lanes


@pytest.mark.parametrize("B,D,depth", VIT + RESIDENT_EDGES)
def test_float32_within_the_limits_is_resident(B, D, depth):
    p = trk.plan(B, D, depth, F32)
    assert p.path == "resident"
    assert p.smem == trk.resident_smem(D, depth) <= trk.SMEM_MAX == 232448
    # the node rows (whole float4 pieces) and biases, nothing else
    N = 2 ** depth - 1
    assert p.smem == N * utils.cdiv(D, 4) * 16 + N * 4
    # lanes a token and float4 pieces a lane hold the row, with no spare piece
    # a lane: fewer pieces would not cover D; the (lanes, pieces) pairs the C
    # entry point instantiates
    assert (p.lanes, p.vecs) in {(4, 1), (4, 2), (4, 4), (4, 8), (8, 1), (8, 2), (8, 4),
                                 (16, 4), (32, 4), (32, 8)}
    assert 4 * p.lanes * p.vecs >= D
    assert p.vecs == 1 or 4 * p.lanes * (p.vecs // 2) < D
    # 4 lanes a token only for a batch that fills the SMs at 8, down 4 or
    # more levels, at D <= 128
    wide = B > SMS * 16 * 4 and depth >= 4 and D <= 128
    assert (p.lanes == 4) == wide
    # warps a block: the fewest in 4-16 that spread B over the SMs; the grid
    # covers every token at once unless every SM has a block, and no block
    # is idle
    assert p.warps == min(16, max(4, utils.cdiv(B, SMS * _per_warp(p))))
    tokens = p.warps * _per_warp(p)
    assert p.grid == min(SMS, utils.cdiv(B, tokens))
    assert (p.grid - 1) * tokens < B


@pytest.mark.parametrize("B,depth,lanes,warps,grid", [
    (1, 7, 8, 4, 1), (33, 7, 8, 4, 3), (1024, 7, 8, 4, 64), (2048, 7, 8, 4, 128),
    (4096, 7, 8, 8, 128), (6000, 7, 8, 12, 125), (8448, 7, 8, 16, 132),
    (8449, 7, 4, 9, 118), (16384, 7, 4, 16, 128), (16384, 4, 4, 16, 128),
    (16384, 3, 8, 16, 132), (16384, 2, 8, 16, 132), (100000, 8, 4, 16, 132)])
def test_vit_lanes_warps_and_grid(B, depth, lanes, warps, grid):
    """At D 128: 8 lanes a token (4 float4 pieces a lane, 4 tokens a warp)
    up to the batch that fills every SM's 16 warps (132 x 64 tokens), and
    for shallow trees; past it, down 4 or more levels, 4 lanes (8 pieces,
    8 tokens a warp).  The fewest warps a block that spread B over the SMs,
    then one block an SM."""
    p = trk.plan(B, 128, depth, F32)
    assert (p.lanes, p.vecs, p.warps, p.grid) == (lanes, 32 // lanes, warps, grid)


@pytest.mark.parametrize("B,D,depth", PAST_EDGES + DRAFT_F32)
def test_float32_past_the_limits_is_cluster(B, D, depth):
    p = trk.plan(B, D, depth, F32)
    assert p.path == "cluster" and (p.lanes, p.vecs, p.warps, p.smem) == (0, 0, 8, 0)
    assert D > trk.RESIDENT_MAX_D or trk.resident_smem(D, depth) > trk.SMEM_MAX


@pytest.mark.parametrize("B,D,depth", BF16_SITES)
def test_bf16_is_cluster(B, D, depth):
    p = trk.plan(B, D, depth, BF16)
    assert p.path == "cluster" and (p.lanes, p.vecs, p.warps, p.smem) == (0, 0, 8, 0)
    tiles = utils.cdiv(B, trk.CLUSTER_TOKENS)
    assert p.grid == tiles * (16 if tiles <= 8 else 8)


@pytest.mark.parametrize("B,D,depth", [(0, 128, 4), (8, 0, 4), (8, 128, 0), (8, 128, 9)])
def test_plan_refuses_what_no_form_takes(B, D, depth):
    with pytest.raises(ValueError):
        trk.plan(B, D, depth, F32)


def test_fewer_sms_shrink_the_grid():
    """A card with fewer SMs: the resident grid follows it."""
    p = trk.plan(16384, 128, 7, F32, sms=66)
    assert (p.warps, p.grid) == (16, 66)
