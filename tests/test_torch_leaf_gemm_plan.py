"""The grouped GEMM wrappers' launch plan (``kernels/leaf_gemm/kernel.py::
plan``), on the CPU: which path each shape takes, its tile, its split of D
and its grid, and that the work the plan hands the blocks covers every
(leaf, row, column, range of D) exactly once.  The kernels themselves run
on the card (``chip_smoke.py``); these shapes are the ones it and the port
launch: the internlm2-20b main path (both dtypes), every bf16 arch site, the
ViT's and the starcoder2 draft's float32 sites, the JAX grouped capacities
and the CPU tests' small widths.
"""
from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

from repro_torch import utils
from repro_torch.kernels.leaf_gemm import kernel as gk

torch.set_num_threads(1)

BF16, F32 = torch.bfloat16, torch.float32
SMS = gk.H100_SMS

# (name, E, C, D, H, dual, dtype): each site's up projection (the dual form
# under SwiGLU) and its down projection, at 1024 prefill tokens
MAIN = [("internlm2 up", 16, 128, 6144, 1024, True, BF16),
        ("internlm2 down", 16, 128, 1024, 6144, False, BF16)]
MAIN_F32 = [("internlm2 up float32", 16, 128, 6144, 1024, True, F32),
            ("internlm2 down float32", 16, 128, 1024, 6144, False, F32)]
ARCH_SITES = [
    ("phi3 up", 16, 128, 5120, 1120, True, BF16),
    ("phi3 down", 16, 128, 1120, 5120, False, BF16),
    ("starcoder2 up", 16, 128, 6144, 1536, False, BF16),
    ("starcoder2 down", 16, 128, 1536, 6144, False, BF16),
    ("command-r up", 16, 128, 8192, 1408, True, BF16),
    ("command-r down", 16, 128, 1408, 8192, False, BF16),
    ("olmoe up", 8, 256, 2048, 1024, True, BF16),
    ("olmoe down", 8, 256, 1024, 2048, False, BF16),
    ("kimi up", 64, 128, 7168, 2048, True, BF16),
    ("kimi down", 64, 128, 2048, 7168, False, BF16),
    ("jamba wide up", 8, 256, 8192, 24576, True, BF16),
    ("jamba wide down", 8, 256, 24576, 8192, False, BF16),
    ("jamba narrow up", 16, 128, 8192, 1536, True, BF16),
    ("jamba narrow down", 16, 128, 1536, 8192, False, BF16),
    ("whisper up", 8, 256, 768, 384, False, BF16),
    ("whisper down", 8, 256, 384, 768, False, BF16),
    ("whisper swiglu probe", 8, 256, 768, 384, True, BF16),
]
VIT = [(f"vit l{l} {d}", E, C, *dims, False, F32)
       for l, E, C in ((32, 4, 8192), (8, 16, 2048), (1, 128, 256))
       for d, dims in (("up", (128, l)), ("down", (l, 128)))]
DRAFT = [("starcoder2 draft up", 8, 256, 6144, 16, False, F32),
         ("starcoder2 draft down", 8, 256, 16, 6144, False, F32)]
CAPACITIES = [(f"C={C} {d} {str(dt)[6:]}", 16, C, *dims, dual, dt)
              for C in (8, 16, 136, 264) for dt in (F32, BF16)
              for d, dims, dual in (("dual", (6144, 1024), True),
                                    ("down", (1024, 6144), False))]
SMALL = [(f"small D={d} H={h} {str(dt)[6:]}{' dual' if dual else ''}", 3, 16, d, h, dual, dt)
         for d, h, dt, dual in itertools.product((20, 24), (4, 8), (F32, BF16),
                                                 (False, True))]
# float32 narrow leaves off the sites' widths: odd N, N not a power of two,
# a D split, the dual form
NARROW_EXTRA = [(f"narrow N={n} D={d}", 7, 128, d, n, dual, F32)
                for n, d, dual in ((1, 45, False), (3, 20, True), (5, 100, False),
                                   (12, 1000, True), (31, 8, False), (32, 6144, True))]
# the narrow form's longest row tile (512 at N = 16) where its ring would
# pass the shared memory a block may hold: a SwiGLU draft's up projection
# (8 leaves of 16, D 6144) past 1024 prefill tokens, and D 512
RING_EDGES = [(f"narrow N=16 C={C} D={d}{' dual' if dual else ''}", 8, C, d, 16, dual, F32)
              for C, d in ((264, 6144), (384, 512), (512, 6144)) for dual in (False, True)]
SHAPES = (MAIN + MAIN_F32 + ARCH_SITES + VIT + DRAFT + CAPACITIES + SMALL + NARROW_EXTRA
          + RING_EDGES)
F32_SHAPES = [s for s in SHAPES if s[-1] == F32]
FULL_WIDTH_BF16 = [s for s in MAIN + ARCH_SITES + CAPACITIES if s[-1] == BF16]


def plan_of(shape, **kw):
    _, E, C, D, H, dual, dtype = shape
    return gk.plan(E, C, D, H, dtype=dtype, dual=dual, **kw)


def partition(ranges, n):
    """The distinct ranges tile [0, n) end to end, no gap or overlap."""
    ranges = sorted(set(ranges))
    return ranges[0][0] == 0 and ranges[-1][1] == n and all(
        a[1] == b[0] for a, b in zip(ranges, ranges[1:])) and all(
        a < b for a, b in ranges)


@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_plan_covers_every_leaf_row_column_and_range_once(shape):
    _, E, C, D, H, dual, _ = shape
    p = plan_of(shape)
    # group sizes from a seed: the float32 wide dual form deals its leaves
    # by them, so each block's leaf is the one the kernel computes
    gs = np.random.default_rng(E * C + H).integers(0, C + 1, E)
    work = gk.work(p, E, C, D, H, gs)
    assert all(0 <= b < p.grid for b, *_ in work)
    assert {b for b, *_ in work} == set(range(p.grid))   # no idle block
    per_leaf = {}
    for _, e, rows, cols, ks in work:
        per_leaf.setdefault(e, []).append((rows, cols, ks))
    assert sorted(per_leaf) == list(range(E))
    for tiles in per_leaf.values():
        rows, cols, ks = (partition([t[i] for t in tiles], n)
                          for i, n in enumerate((C, H, D)))
        assert rows and cols and ks
        # every combination of the three partitions, each exactly once
        assert len(tiles) == len(set(tiles)) == (
            len({t[0] for t in tiles}) * len({t[1] for t in tiles})
            * len({t[2] for t in tiles}))


@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_plan_splits_d_only_where_units_are_fewer_than_sms(shape):
    _, E, C, D, H, dual, dtype = shape
    p = plan_of(shape)
    assert p.units % p.splits == 0
    unsplit = p.units // p.splits
    if p.splits > 1:
        assert unsplit < SMS
        step = gk.F32_K_STEP if dtype == F32 else gk.K_STEP
        assert p.splits <= utils.cdiv(D, step)
    if p.path == "tma":
        assert unsplit == E * utils.cdiv(H, p.cols)
        assert p.grid == min(p.units, SMS)
        assert p.rows == (128 if C <= 128 else 256)
        assert p.cols in gk.TMA_COLS[dual][p.rows]
        if p.splits > 1:
            assert utils.cdiv(D, gk.K_STEP) // p.splits >= gk.MIN_SPLIT_STEPS
    else:
        assert p.grid == p.units


@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_plan_path_by_what_a_tensor_map_can_describe(shape):
    _, E, C, D, H, dual, dtype = shape
    p = plan_of(shape)
    if dtype == F32:
        assert p.path == "cuda_cores"
    elif D % 8 or H % 8:     # rows off 16 bytes: no tensor map
        assert p.path == "masked"
    else:
        assert p.path == "tma"
    if dtype == BF16:        # a base off 16 bytes takes the masked path too
        assert plan_of(shape, aligned=False).path == "masked"


def test_full_width_shapes_take_the_tma_path():
    assert {plan_of(s).path for s in FULL_WIDTH_BF16} == {"tma"}
    assert {plan_of(s).path for s in SMALL if s[-1] == BF16 and s[4] == 4} == {"masked"}


def test_plans_at_the_sites_the_redesign_names():
    """Whole leaves up to capacity 256, column tiles that divide N, and the
    D split where the units cannot fill the card."""
    by = {s[0]: plan_of(s) for s in SHAPES}
    assert by["internlm2 up"][:5] == ("tma", 128, 128, 1, 128)
    assert by["internlm2 down"][:5] == ("tma", 128, 256, 1, 384)
    assert by["olmoe up"].rows == by["olmoe down"].rows == 256   # one read of the weights
    w = by["whisper up"]
    assert (w.cols, 384 % w.cols, w.splits) == (64, 0, 2)        # 6 tiles, D in 2
    assert by["phi3 down"].cols == 128                           # 640 units: 4.85 rounds
    assert by["C=264 down bfloat16"].rows == 256                 # two row tiles
    assert len({r for _, _, r, _, _ in gk.work(
        by["C=264 down bfloat16"], 16, 264, 1024, 6144)}) == 2
    assert by["starcoder2 draft up"].splits == 16                # 8 blocks -> 128
    assert all(by[s[0]].splits == 1 for s in VIT)                # the ViT's as they were


# Each float32 site's form, tile (rows, output columns), split of D and
# grid: the wide form's blocks of 128 output columns (64 of the dual form's
# g and u) by 128 rows where D is long, 64 where D is short (the ViT's and
# the draft's down projections), C is at most 64, or D is at most 1024 with
# four waves of 128-row blocks (the main down projection); row tiles past
# the first in the grid; the narrow form's R rows by all N columns (its
# plan's cols: the columns a thread), D split where it is long (the draft's
# 6144), R no longer than C's power of two (the small widths) and its ring
# within a block's shared memory.
F32_SITES = {
    "internlm2 up float32": ("wide", 128, 64, 1, 256),
    "internlm2 down float32": ("wide", 64, 128, 1, 1536),
    "vit l32 up": ("narrow", 256, 8, 1, 128),
    "vit l32 down": ("wide", 64, 128, 1, 512),
    "vit l8 up": ("narrow", 256, 8, 1, 128),
    "vit l8 down": ("wide", 64, 128, 1, 512),
    "vit l1 up": ("narrow", 256, 1, 1, 128),
    "vit l1 down": ("wide", 64, 128, 1, 512),
    "starcoder2 draft up": ("narrow", 256, 8, 16, 128),
    "starcoder2 draft down": ("wide", 64, 128, 1, 1536),
    **{f"C={C} dual float32": ("wide", rows, 64, 1, 16 * utils.cdiv(C, rows) * 16)
       for C, rows in ((8, 64), (16, 64), (136, 128), (264, 128))},
    **{f"C={C} down float32": ("wide", 64, 128, 1, 16 * utils.cdiv(C, 64) * 48)
       for C in (8, 16, 136, 264)},
    **{s[0]: ("narrow", 16, s[4], 1, 3) for s in SMALL if s[-1] == F32},
    # 512 rows where the ring fits (the down form), else 256
    "narrow N=16 C=264 D=6144": ("narrow", 512, 8, 16, 128),
    "narrow N=16 C=264 D=6144 dual": ("narrow", 256, 8, 8, 128),
    "narrow N=16 C=384 D=512 dual": ("narrow", 256, 8, 8, 128),
    "narrow N=16 C=512 D=6144 dual": ("narrow", 256, 8, 8, 128),
}


@pytest.mark.parametrize("shape", [s for s in F32_SHAPES if s[0] in F32_SITES],
                         ids=lambda s: s[0])
def test_float32_plan_names_each_sites_form_tile_and_split(shape):
    _, E, C, D, H, dual, _ = shape
    p = plan_of(shape)
    assert (gk.f32_form(H), p.rows, p.cols, p.splits, p.grid) == F32_SITES[shape[0]]
    assert p.path == "cuda_cores" and p.units == p.grid


@pytest.mark.parametrize("shape", [s for s in F32_SHAPES if s[4] <= gk.NARROW_MAX],
                         ids=lambda s: s[0])
def test_narrow_blocks_cover_no_column_past_n(shape):
    """A narrow block covers all N columns and none past them, its threads
    take column groups that divide N exactly, and they fit one block."""
    _, E, C, D, H, dual, _ = shape
    p = plan_of(shape)
    ct = p.cols                 # the columns a thread, which the kernel takes
    assert gk.f32_form(H) == "narrow" and ct == gk.narrow_cols(H)
    assert ct in (8, 4, 2, 1) and H % ct == 0
    assert {cols for _, _, _, cols, _ in gk.work(p, E, C, D, H)} == {(0, H)}
    assert p.rows & (p.rows - 1) == 0 and p.rows >= gk.narrow_rt(H)
    assert (H // ct) * p.rows // gk.narrow_rt(H) <= gk.F32_THREADS


@pytest.mark.parametrize("shape", F32_SHAPES, ids=lambda s: s[0])
def test_float32_ring_fits_a_blocks_shared_memory(shape):
    """Three stages of x's rows (36 floats apart) and a step's 32 weight
    rows (the wide form's 128 columns, the narrow form's N an operand)
    within the H100's 227 KB (232,448 bytes) a block."""
    _, E, C, D, H, dual, _ = shape
    p = plan_of(shape)
    w = 128 if H > 32 else (2 if dual else 1) * H
    assert 3 * (p.rows * 36 + 32 * w) * 4 <= 232448
    assert gk.f32_smem(p.rows, p.cols, H, dual) == 3 * (p.rows * 36 + 32 * w) * 4


def test_wide_dual_deals_leaves_most_live_slices_first():
    """The float32 dual form with one row tile a leaf: the first blocks take
    the leaf of most live 32-row slices, ties by index; a down projection,
    or more than one row tile a leaf, keeps the index order."""
    gs = [64, 96, 0, 65, 33, 128] + [1] * 10
    p = plan_of(MAIN_F32[0])
    leaves = [e for _, e, *_ in gk.work(p, 16, 128, 6144, 1024, gs)]
    tiles = 1024 // p.cols
    assert leaves[::tiles] == [5, 1, 3, 0, 4] + list(range(6, 16)) + [2]
    by = {s[0]: s for s in SHAPES}
    for shape in (MAIN_F32[1], by["C=136 dual float32"]):   # down; two row tiles
        _, E, C, D, H, dual, _ = shape
        q = plan_of(shape)
        assert [e for _, e, *_ in gk.work(q, E, C, D, H, gs)] == [
            e for _, e, *_ in gk.work(q, E, C, D, H)]


def test_plan_refuses_empty_shapes():
    with pytest.raises(ValueError, match="positive sizes"):
        gk.plan(0, 128, 64, 64)


def test_launch_plan_reads_alignment_from_the_tensors():
    x = torch.zeros(4 * 128 * 64 + 8, dtype=BF16)
    w = torch.zeros(4, 64, 128, dtype=BF16)
    aligned = x[:4 * 128 * 64].view(4, 128, 64)
    off = x[4:4 + 4 * 128 * 64].view(4, 128, 64)     # 8 bytes off
    assert gk.launch_plan(aligned, (w,)).path == "tma"
    assert gk.launch_plan(off, (w,)).path == "masked"
    assert gk.launch_plan(aligned, (w, w)) == gk.plan(4, 128, 64, 128, dual=True)
