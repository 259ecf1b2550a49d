"""The grouped GEMM wrappers' launch plan (``kernels/leaf_gemm/kernel.py::
plan``), on the CPU: which path each shape takes, its tile, its split of D
and its grid, and that the work the plan hands the blocks covers every
(leaf, row, column, range of D) exactly once.  The kernels themselves run
on the card (``chip_smoke.py``); these shapes are the ones it and the port
launch: the internlm2-20b main path, every bf16 arch site, the ViT's
float32 sites, the JAX grouped capacities and the CPU tests' small widths.
"""
from __future__ import annotations

import itertools

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
SHAPES = MAIN + ARCH_SITES + VIT + DRAFT + CAPACITIES + SMALL
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
    work = gk.work(p, E, C, D, H)
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
    assert by["starcoder2 draft up"].splits == 4                 # 32 blocks -> 128
    assert all(by[s[0]].splits == 1 for s in VIT)                # the ViT's as they were


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
