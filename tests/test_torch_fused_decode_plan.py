"""The fused decode wrapper's launch plan (``kernels/fused_decode/kernel.py::
plan``) and the work it hands each block (``work``), on the CPU: the path
each shape takes, that every (tree, token, hidden unit, range of D) and
every (tree, token, output column, range of l) is computed exactly once,
that each distinct routed leaf's weight tile is read by one block a range,
that blocks past a tree's distinct leaves do nothing, that the finish and
the combine add the partial sums in a fixed order (trees in order, then the
master leaf), that a block's shared memory fits the H100's and that the
workspace is the plan's.  The kernels themselves run on the card
(``chip_smoke.py``); the shapes are the ones it and the port launch: the
internlm2-20b main path, every bf16 arch site, the starcoder2 float32
draft and the small shapes of its ragged phase, at decode batches 1 to 64.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch import utils
from repro_torch.kernels.fused_decode import kernel as fdk

BF16, F32 = torch.bfloat16, torch.float32

# (name, B, D, T, depth, l, O, mw, dtype, dual): each site's decode step
MAIN = ("internlm2", 8, 6144, 1, 4, 1024, 6144, 0, BF16, True)
SITES = [
    MAIN,
    ("internlm2 master", 8, 6144, 1, 4, 1024, 6144, 1024, BF16, True),
    ("phi3", 8, 5120, 1, 4, 1120, 5120, 0, BF16, True),
    ("starcoder2", 8, 6144, 1, 4, 1536, 6144, 0, BF16, False),
    ("command-r", 8, 8192, 1, 4, 1408, 8192, 0, BF16, True),
    ("olmoe T8", 8, 2048, 8, 3, 1024, 2048, 0, BF16, True),
    ("kimi T8 depth 6", 8, 7168, 8, 6, 2048, 7168, 0, BF16, True),
    ("jamba 2x8x24576", 8, 8192, 2, 3, 24576, 8192, 0, BF16, True),
    ("jamba 16x1536", 8, 8192, 1, 4, 1536, 8192, 0, BF16, True),
    ("whisper", 8, 768, 1, 3, 384, 768, 0, BF16, False),
    ("starcoder2 draft fp32", 8, 6144, 1, 3, 16, 6144, 0, F32, False),
]
BATCHES = [(f"internlm2 B={B} {str(dt)[6:]}{' master' if mw else ''}", B, 6144, 1, 4,
            1024, 6144, mw, dt, True)
           for B in (1, 8, 24, 64) for dt in (BF16, F32) for mw in (0, 1024)]
# chip_smoke.phase_ragged's fused decode shapes: two trees of depth 3, 7 tokens
RAGGED = [(f"ragged D={d} l={leaf} {act}{' master' if mw else ''} {str(dt)[6:]}", 7, d, 2, 3,
           leaf, d, mw, dt, act == "swiglu")
          for d in (20, 24) for dt in (F32, BF16)
          for act, leaf, mw in (("gelu", 4, 0), ("swiglu", 8, 5), ("relu", 8, 5))]
SHAPES = SITES + BATCHES + RAGGED
ROUTINGS = ("random", "one leaf", "own leaf")


def plan_of(shape, **kw):
    _, B, D, T, depth, l, O, mw, dtype, dual = shape
    return fdk.plan(B, D, T, depth, l, O, mw, dtype, dual, **kw)


def routing(shape, kind, seed=0):
    """(B, T) leaf indices: drawn at random, every token on one leaf, or
    each token on a leaf of its own (as far as the tree has leaves)."""
    _, B, _, T, depth, *_ = shape
    E = 2 ** depth
    if kind == "random":
        return np.random.default_rng(seed).integers(0, E, (B, T))
    if kind == "one leaf":
        return np.full((B, T), E // 2 - 1 if E > 1 else 0)
    return (np.arange(B)[:, None] + np.arange(T)[None, :]) % E


def partition(ranges, n):
    """The distinct ranges tile [0, n) end to end, no gap or overlap."""
    ranges = sorted(set(ranges))
    return bool(ranges) and ranges[0][0] == 0 and ranges[-1][1] == n and all(
        a[1] == b[0] for a, b in zip(ranges, ranges[1:])) and all(a < b for a, b in ranges)


def live(work, phase):
    return [w for w in work if w.phase == phase and w.tokens]


@pytest.mark.parametrize("kind", ROUTINGS)
@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_every_token_unit_and_range_is_computed_once(shape, kind):
    """Up: each (tree, token) meets every hidden unit over every range of D
    once, the ranges of D tiling D; down: each (tree, token) every output
    column over every range of l once; the master leaf the same over mw."""
    _, B, D, T, _, l, O, mw, _, _ = shape
    p = plan_of(shape)
    idx = routing(shape, kind)
    work = fdk.work(p, idx)
    for phase, k_len, k_len_m, width, width_m in (("up", D, D, l, mw), ("down", l, mw, O, O)):
        cover = {}
        for w in live(work, phase):
            if w.tree < T:
                assert all(idx[b, w.tree] == w.leaf for b in w.tokens)
            for b in w.tokens:
                cover.setdefault((w.tree, b), []).append((w.cols, w.ks))
        trees = list(range(T)) + ([T] if mw else [])
        assert sorted(cover) == [(t, b) for t in trees for b in range(B)]
        for (t, b), tiles in cover.items():
            assert len(tiles) == len(set(tiles)), (phase, t, b)   # nothing twice
            k_full, w_full = (k_len_m, width_m) if t == T else (k_len, width)
            by_range = {}
            for cols, ks in tiles:
                by_range.setdefault(ks, []).append(cols)
            assert partition(list(by_range), k_full), (phase, t, b)
            for cols in by_range.values():
                assert partition(cols, w_full) and len(cols) == len(set(cols))
            assert len({ks for ks in by_range}) == (
                p.splits_up if phase == "up" else p.splits_down)


@pytest.mark.parametrize("kind", ROUTINGS)
@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_each_distinct_leaf_tile_is_read_once_a_range(shape, kind):
    """A (tree, leaf) weight tile crosses from memory once per range of k,
    whatever the number of tokens routed to it, and only routed leaves are
    read."""
    p = plan_of(shape)
    idx = routing(shape, kind)
    work = fdk.work(p, idx)
    for phase in ("up", "down"):
        reads = [(w.chunk, w.tree, w.leaf, w.cols, w.ks) for w in live(work, phase)]
        assert len(reads) == len(set(reads))
        for c0, t, e, _, _ in reads:
            if t < p.T:
                assert e in idx[c0:c0 + p.chunk, t]


@pytest.mark.parametrize("kind", ROUTINGS)
@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_blocks_past_the_distinct_leaves_do_nothing(shape, kind):
    """Block z = t x rmax + r of a projection takes tree t's r-th smallest
    routed leaf; ranks at or past the tree's distinct leaves, and tiles past
    a leaf's width, get no tokens.  The grids are the plan's."""
    p = plan_of(shape)
    idx = routing(shape, kind)
    work = fdk.work(p, idx)
    for phase, grid in (("up", p.up_grid), ("down", p.down_grid)):
        blocks = [w for w in work if w.phase == phase]
        chunks = utils.cdiv(p.B, p.chunk)
        assert len(blocks) == chunks * grid[0] * grid[1] * grid[2]
        for w in blocks:
            x, y, z = w.block
            rows = idx[w.chunk:w.chunk + p.chunk]
            if z < p.T * p.rmax:
                t, r = divmod(z, p.rmax)
                distinct = sorted(set(rows[:, t].tolist()))
                if r >= len(distinct):
                    assert w.tokens == () and w.leaf == -1
                elif x * p.cols < (p.l if w.phase == "up" else p.O):
                    assert w.leaf == distinct[r] and w.tokens
            else:
                assert w.tree == p.T and (w.tokens == () or len(w.tokens) == len(rows))


@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_partial_sums_meet_in_a_fixed_order(shape):
    """The finish adds the up projection's ranges of D in order; the
    combine adds each tree's ranges of l in order, the trees in order, then
    the master leaf, over every (token, output column) once.  One tree
    without a master and l whole: no combine (the down projection writes
    y); D whole: no finish (the up projection writes h)."""
    _, B, _, T, _, l, O, mw, _, _ = shape
    p = plan_of(shape)
    work = fdk.work(p, routing(shape, "random"))
    finish = [w for w in work if w.phase == "finish"]
    if p.splits_up == 1:
        assert not finish and p.finish_grid == 0
    else:
        assert {w.order for w in finish} == {tuple(range(p.splits_up))}
        for c0 in range(0, B, p.chunk):
            n = T * min(p.chunk, B - c0) * l + min(p.chunk, B - c0) * mw
            assert partition([w.cols for w in finish if w.chunk == c0], n)
    combine = [w for w in work if w.phase == "combine"]
    assert p.direct == (T == 1 and not mw and p.splits_down == 1)
    if p.direct:
        assert not combine and p.combine_grid == ()
        return
    slots = list(range(T + (mw > 0)))
    assert {w.order for w in combine} == {
        tuple((u, q) for u in slots for q in range(p.splits_down))}
    for b in range(B):
        assert partition([w.cols for w in combine if w.tokens == (b,)], O)


@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_shared_memory_fits_and_the_workspace_is_the_plans(shape):
    _, B, _, T, _, l, O, mw, dtype, dual = shape
    p = plan_of(shape)
    assert max(p.smem_up, p.smem_down) + fdk.STATIC_SMEM <= fdk.SMEM_LIMIT
    assert 2 <= min(p.stages_up, p.stages_down) <= max(p.stages_up, p.stages_down) <= fdk.MAX_STAGES
    b0 = min(B, p.chunk)
    win = fdk.STAGE_K * utils.cdiv(b0, fdk.WINDOW) * 1024
    box = p.k_step * 128
    assert p.smem_up == fdk.RING_ALIGN + p.stages_up * (p.ops * box + win)
    assert p.smem_down == fdk.RING_ALIGN + p.stages_down * (box + win)
    lay = fdk.workspace_layout(T, b0, l, O, mw, p.ops, p.elem, p.splits_up,
                               p.splits_down, p.direct)
    assert lay["total"] == p.workspace
    ranges = p.splits_up if p.splits_up > 1 else 0
    sizes = [("part_up", ranges * T * b0 * p.ops * l * 4),
             ("part_m", ranges * b0 * p.ops * mw * 4),
             ("h", T * b0 * l * p.elem), ("hm", b0 * mw * p.elem),
             ("part_down", 0 if p.direct else p.splits_down * (T + (mw > 0)) * b0 * O * 4)]
    ends = [lay[k] + n for k, n in sizes]
    starts = [lay[k] for k, _ in sizes]
    assert all(s % 256 == 0 for s in starts)
    assert all(e <= s for e, s in zip(ends, starts[1:])) and ends[-1] == lay["total"]
    assert p.rmax == min(b0, 2 ** p.depth)
    assert p.route_grid == (b0, T)


def test_paths_by_what_a_tensor_map_can_describe():
    """Full-width shapes take the TMA path in both dtypes; rows off 16 bytes
    (D 20, l 4, mw 5) or a base off 16 bytes take the element-wise path."""
    assert {plan_of(s).path for s in SITES + BATCHES} == {"tma"}
    for s in SITES + BATCHES:
        assert plan_of(s, aligned=False).path == "elementwise"
    for s in RAGGED:
        _, _, D, _, _, l, _, mw, dtype, _ = s
        vec = 16 // (torch.finfo(dtype).bits // 8)
        assert plan_of(s).path == ("tma" if not (D % vec or l % vec or mw % vec)
                                   else "elementwise")
    # D = 20 is a whole 16 bytes in float32, not in bf16
    by = {s[0]: plan_of(s).path for s in RAGGED}
    assert by["ragged D=20 l=4 gelu float32"] == "tma"
    assert by["ragged D=20 l=4 gelu bfloat16"] == "elementwise"


def test_chunks_and_accumulators_by_batch():
    """A chunk holds 64 tokens in bf16 and 32 in float32; a larger batch
    runs the phases chunk by chunk, every token routed in its own chunk."""
    assert plan_of(MAIN).chunk == 64 and plan_of(SITES[-1]).chunk == 32
    for dt, B, chunks in ((BF16, 64, 1), (BF16, 100, 2), (F32, 64, 2), (F32, 33, 2)):
        p = fdk.plan(B, 6144, 1, 4, 1024, 6144, 0, dt)
        work = fdk.work(p, np.zeros((B, 1), dtype=np.int64))
        assert sorted({w.chunk for w in work}) == list(range(0, B, p.chunk))
        assert len({w.chunk for w in work}) == chunks
        route = sorted(w.tokens[0] for w in work if w.phase == "route")
        assert route == list(range(B))


def test_plans_at_the_sites_the_redesign_names():
    """The main path streams each routed leaf's up tiles over all of D and
    writes h and y directly (route, up, down: three launches); where few
    leaves would leave SMs idle (one token), D is split and a finish runs;
    a forest (olmoe, jamba) combines its trees' slots."""
    main = plan_of(MAIN)
    assert main.splits_up == 1 and main.direct and main.finish_grid == 0
    assert main.up_grid == (16, 1, 8) and main.down_grid == (96, 1, 8)
    one = plan_of(BATCHES[0])
    assert one.B == 1 and one.splits_up > 1 and one.finish_grid > 0
    by = {s[0]: plan_of(s) for s in SITES}
    assert not by["olmoe T8"].direct and by["olmoe T8"].combine_grid[1] == 8
    assert not by["internlm2 master"].direct
    with pytest.raises(ValueError):
        fdk.plan(0, 6144, 1, 4, 1024, 6144, 0)
