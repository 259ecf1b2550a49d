"""Wrappers of the CUDA grouped leaf GEMMs (``csrc/leaf_gemm.cu``), which
replace the Pallas TPU kernels ``repro/kernels/leaf_gemm/kernel.py::
grouped_matmul`` and ``::grouped_matmul_dual``: a ragged grouped GEMM over
capacity-padded per-leaf token buffers whose empty token tiles are skipped.
CPU tensors run the plain versions in ``ref.py``.

``plan`` chooses, from the shapes alone, the path a call takes (the TMA
kernel, the masked ``cp.async`` kernel or, in float32, the CUDA-core
kernels' wide or narrow form), its tile, its split of D and its grid; the C
entry point launches that plan.
Each kernel counts its launches by path in ``Kernel.paths``."""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence

import torch

from repro_torch import utils
from repro_torch.kernels import common
from repro_torch.kernels.leaf_gemm import ref as R

P, I = common.P, common.I

GMM = common.register(common.Kernel(
    "grouped_matmul", "leaf_gemm.cu", "grouped_matmul",
    [P, P, P, P, P] + [I] * 12 + [P],
    replaces="src/repro/kernels/leaf_gemm/kernel.py:80"))
GMM_DUAL = common.register(common.Kernel(
    "grouped_matmul_dual", "leaf_gemm.cu", "grouped_matmul_dual",
    [P, P, P, P, P, P] + [I] * 11 + [P],
    replaces="src/repro/kernels/leaf_gemm/kernel.py:144"))

#: path codes the C entry points take
PATH_CODES = {"cuda_cores": 0, "masked": 1, "tma": 2}
H100_SMS = common.H100_SMS
#: D's step in the bf16 kernels (one 128-byte row of x)
K_STEP = 64
#: the TMA kernel's column tiles by form (dual?) and row tile
TMA_COLS = {False: {128: (64, 128, 256), 256: (64, 128)},
            True: {128: (64, 128), 256: (64,)}}
#: the masked kernel's tile (128 rows by 256 or 128 columns)
MASKED_COLS = {False: 256, True: 128}
#: float32: the step along D (32 floats, one 128-byte row of x), the wide
#: form's tile (128 rows by 128 output columns, or 64 of the dual form's g
#: beside the same 64 of u), the widest N the narrow form takes and its most
#: threads a block
F32_K_STEP = 32
F32_ROWS, F32_COLS = 128, {False: 128, True: 64}
NARROW_MAX, F32_THREADS = 32, 256
#: float32: the ring's stages, the floats from one row of x to the next in a
#: stage (a 16-byte pad), and the H100's most dynamic shared memory a block
#: (227 KB)
F32_STAGES, F32_X_ROW, SMEM_MAX = 3, 36, 232448
#: the wide form's short row tile (two blocks an SM), taken where C fits it,
#: where D is at most WIDE_SHORT_D (a step or two: latency, not products,
#: bounds the block), or where D is at most WIDE_MID_D and 128-row tiles
#: would still give WIDE_WAVES waves of blocks
WIDE_SHORT_ROWS, WIDE_SHORT_D, WIDE_MID_D, WIDE_WAVES = 64, 64, 1024, 4
#: the narrow form's fewest rows a tile, and its fewest steps of D at which
#: it splits D rather than shortening its row tile
NARROW_MIN_ROWS, NARROW_SPLIT_STEPS = 32, 16
#: float32: the most leaves the wide dual form deals by load (more keep
#: their index order)
MAX_SORTED_LEAVES = 256
#: the fewest steps of D a bf16 split range keeps (below it the second
#: pass costs more than the split gains on the H100)
MIN_SPLIT_STEPS = 4


class Plan(NamedTuple):
    path: str     # "tma", "masked" or "cuda_cores"
    rows: int     # token rows of a row tile
    cols: int     # output columns of a tile (the narrow float32 form's:
                  # columns a thread; its tile holds all N)
    splits: int   # ranges of D summed by a second pass in a fixed order
    units: int    # work items: (leaf, column tile, range of D) on the TMA
                  # path, else blocks (leaf, row tile, column tile, range)
    grid: int     # blocks launched by the first pass


@functools.lru_cache(maxsize=4096)
def plan(E: int, C: int, D: int, H: int, dtype: torch.dtype = torch.bfloat16,
         dual: bool = False, aligned: bool = True, sms: int = H100_SMS) -> Plan:
    """The launch of one grouped GEMM call x (E, C, D) @ w (E, D, H).

    float32 takes the CUDA-core kernels (``f32_form``).  N > 32: the wide
    form, one block per (leaf, 128 or 64 rows, 128 output columns, or 64
    of the dual form's g and u): 64 rows (two blocks an SM) where C, D or
    the waves of 128-row blocks say so (``WIDE_SHORT_ROWS``), since a long
    D streams each weight panel once for up to 128 rows where a 64-row tile
    holding a few live rows would stream it again for little work.  N <=
    32: the narrow form, one block per (leaf, R rows, all N columns) of G R
    / ``narrow_rt(N)`` threads (G = N / ``narrow_cols(N)`` column groups; R
    the largest power of two that keeps them within ``F32_THREADS`` and the
    ring within ``SMEM_MAX``, and no longer than C's power of two); its
    ``cols`` is the columns a thread, ``narrow_cols(N)``, which the kernel
    takes from the plan.
    Where D is short (fewer than ``NARROW_SPLIT_STEPS`` steps) R halves,
    down to ``NARROW_MIN_ROWS``, while the blocks are fewer than half the
    SMs; where it is long, D is split instead.  Either form splits D up to
    ``sms // blocks`` ways where the blocks are fewer than the SMs.

    bf16 takes the TMA kernel when a tensor map can describe x and w (D and
    H multiples of 8, i.e. 16-byte rows, and ``aligned``: every base on 16
    bytes), else the masked kernel.  The TMA kernel's row tile holds the
    whole capacity up to 256 (128 or 256 rows); one block an SM walks its
    units (leaf, column tile, range of D).  Where there are fewer units
    than SMs, D may be split: up to ``sms // units`` ways, at least
    ``MIN_SPLIT_STEPS`` steps a range, the partials summed by a second
    pass.  It takes the column tile and split that keep the busiest SM's
    bytes least (its weights in full, x at a quarter since it comes from
    L2, and the partials' f32 write and read spread over the card), the
    larger tile and the fewer ranges on a tie."""
    if E < 1 or C < 1 or D < 1 or H < 1:
        raise ValueError(f"grouped GEMM plan needs positive sizes, got E={E} "
                         f"C={C} D={D} H={H}")
    cdiv = utils.cdiv
    if dtype == torch.float32:
        nk, split = cdiv(D, F32_K_STEP), True
        if f32_form(H) == "wide":
            cols = F32_COLS[dual]
            short = (C <= WIDE_SHORT_ROWS or D <= WIDE_SHORT_D or (
                D <= WIDE_MID_D and E * cdiv(C, F32_ROWS) * cdiv(H, cols) >= WIDE_WAVES * sms))
            rows = WIDE_SHORT_ROWS if short else F32_ROWS
        else:                                     # no row tile past C's power of two
            rows = min(narrow_rows(H), max(narrow_rt(H), 1 << (C - 1).bit_length()))
            cols, split = narrow_cols(H), nk >= NARROW_SPLIT_STEPS
            while f32_smem(rows, cols, H, dual) > SMEM_MAX:
                rows //= 2
            while not split and rows > NARROW_MIN_ROWS and E * cdiv(C, rows) < sms // 2:
                rows //= 2
        blocks = E * cdiv(C, rows) * cdiv(H, f32_tile_cols(cols, H))
        splits = _splits(blocks, nk, sms) if split else 1
        return Plan("cuda_cores", rows, cols, splits, blocks * splits,
                    blocks * splits)
    if not (aligned and D % 8 == 0 and H % 8 == 0):
        cols = MASKED_COLS[dual]
        blocks = cdiv(H, cols) * cdiv(C, 128) * E
        return Plan("masked", 128, cols, 1, blocks, blocks)
    rows = 128 if C <= 128 else 256
    nk = cdiv(D, K_STEP)
    ops = 2 if dual else 1
    tile_rows = utils.round_up(min(C, rows), 64)
    best = None
    for cols in TMA_COLS[dual][rows]:
        units = E * cdiv(H, cols)
        step = ops * cols + tile_rows // 4          # a k-step's bytes / 128
        for splits in range(1, _splits(units, nk // MIN_SPLIT_STEPS, sms) + 1):
            cost = cdiv(units * splits, sms) * nk * step / splits
            if splits > 1:                          # f32 partials out and back
                cost += splits * ops * E * tile_rows * H / (16 * sms)
            key = (cost, -cols, splits)
            if best is None or key < best[0]:
                best = (key, cols, units * splits, splits)
    _, cols, units, splits = best
    return Plan("tma", rows, cols, splits, units, min(units, sms))


def _splits(units: int, steps: int, sms: int) -> int:
    return 1 if units >= sms else max(1, min(steps, sms // units))


def f32_form(H: int) -> str:
    """The float32 form a call with N = H output columns takes."""
    return "narrow" if H <= NARROW_MAX else "wide"


def f32_tile_cols(cols: int, H: int) -> int:
    """A float32 block's output columns: all N in the narrow form (whose
    plan names the columns a thread), else the plan's ``cols``."""
    return H if f32_form(H) == "narrow" else cols


def f32_smem(rows: int, cols: int, H: int, dual: bool) -> int:
    """The bytes of a float32 block's ring: per stage, ``rows`` rows of x
    and a step's rows of the weights (the wide form's 128 columns, or the
    narrow form's N columns an operand)."""
    ops = 2 if dual else 1
    w = F32_COLS[False] if f32_form(H) == "wide" else ops * H
    return F32_STAGES * (rows * F32_X_ROW + F32_K_STEP * w) * 4


def narrow_cols(H: int) -> int:
    """The narrow form's columns a thread: the largest of 8, 4, 2 and 1
    that divides N, so that no thread computes a column past N."""
    return next(c for c in (8, 4, 2, 1) if H % c == 0)


def narrow_rt(H: int) -> int:
    """The narrow form's rows a thread: 1 where one column group covers N,
    else 4 (each load of the weight panel then feeds 4 rows)."""
    return 1 if narrow_cols(H) == H else 4


def narrow_rows(H: int) -> int:
    """The narrow form's longest row tile: the largest power of two R with
    (N / ``narrow_cols``) R / ``narrow_rt`` <= ``F32_THREADS`` threads."""
    groups = H // narrow_cols(H)
    return 1 << (F32_THREADS * narrow_rt(H) // groups).bit_length() - 1


def work(p: Plan, E: int, C: int, D: int, H: int,
         group_sizes: Optional[Sequence[int]] = None) -> list[tuple]:
    """What each block of plan ``p`` computes, in the kernels' own order:
    (block, leaf, row range, column range, D range) a tile, on the TMA path
    a block taking units block, block + grid, ... and each unit's row tiles
    in turn.  Holds the rows a tile could cover, live or not (a dead row
    tile writes zeros, or nothing under a split).  The float32 wide dual
    form (64 output columns a tile) with one row tile a leaf deals the
    leaves to the blocks most live 32-row slices first, ties by index, as
    the kernel reads ``group_sizes`` on the device; without them ``leaf``
    is there the leaf's slot in that order."""
    cdiv = utils.cdiv
    if p.path == "tma":
        step, tiles = K_STEP, cdiv(H, p.cols)
        nk = cdiv(D, step)
        out = []
        for b in range(p.grid):
            for u in range(b, p.units, p.grid):
                split, t, e = u % p.splits, u // p.splits % tiles, u // (p.splits * tiles)
                kb, ke = split * nk // p.splits, (split + 1) * nk // p.splits
                for r0 in range(0, C, p.rows):
                    out.append((b, e, (r0, min(C, r0 + p.rows)),
                                (t * p.cols, min(H, (t + 1) * p.cols)),
                                (kb * step, min(D, ke * step))))
        return out
    step = F32_K_STEP if p.path == "cuda_cores" else D
    cols = f32_tile_cols(p.cols, H) if p.path == "cuda_cores" else p.cols
    nk = cdiv(D, step)
    order = list(range(E))
    if (group_sizes is not None and p.path == "cuda_cores" and f32_form(H) == "wide"
            and p.cols == F32_COLS[True] and C <= p.rows and E <= MAX_SORTED_LEAVES):
        slices = [cdiv(min(int(g), C), 32) for g in group_sizes]
        order.sort(key=lambda e: (-slices[e], e))
    out = []
    ht, ct = cdiv(H, cols), cdiv(C, p.rows)
    for z in range(E * p.splits):
        e, split = order[z % E], z // E
        kb, ke = split * nk // p.splits, (split + 1) * nk // p.splits
        for y in range(ct):
            for x in range(ht):
                b = (z * ct + y) * ht + x
                out.append((b, e, (y * p.rows, min(C, (y + 1) * p.rows)),
                            (x * cols, min(H, (x + 1) * cols)),
                            (kb * step, min(D, ke * step))))
    return out


def grouped_matmul(x: torch.Tensor, w: torch.Tensor,
                   group_sizes: torch.Tensor, *, act: str = "none"
                   ) -> torch.Tensor:
    """x (E, C, D) @ w (E, D, H) -> act(.) (E, C, H), skipping token tiles
    at or past ``group_sizes`` (E,) int32; act in none/relu/gelu/silu."""
    common.forward_only("grouped_matmul", x, w)
    if act not in R.ACTS:
        raise ValueError(f"unknown act {act!r}; have {sorted(R.ACTS)}")
    if x.device.type == "cpu":
        return R.grouped_matmul_ref(x, w, group_sizes, act=act)
    return _launch(GMM, x, (w,), group_sizes, (common.ACT_CODES[act],))


def grouped_matmul_dual(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                        group_sizes: torch.Tensor) -> torch.Tensor:
    """SwiGLU up: silu(x @ wg) * (x @ wu), grouped per leaf: -> (E, C, H)."""
    common.forward_only("grouped_matmul_dual", x, wg, wu)
    if x.device.type == "cpu":
        return R.grouped_matmul_dual_ref(x, wg, wu, group_sizes)
    return _launch(GMM_DUAL, x, (wg, wu), group_sizes, ())


def launch_plan(x: torch.Tensor, ws) -> Plan:
    """The plan a launch on x (E, C, D) and the weights ``ws`` takes
    (positional arguments: the cheapest cache lookup on the launch path)."""
    E, C, D = x.shape
    bases = x.data_ptr() | ws[0].data_ptr() | ws[-1].data_ptr()
    return plan(E, C, D, ws[0].shape[2], x.dtype, len(ws) == 2, bases % 16 == 0,
                common.sm_count(x.get_device()))


def _launch(kernel, x, ws, group_sizes, act_code):
    """The CUDA branch: operand checks, output and partials allocation,
    the launch, its count by path."""
    E, C, D = x.shape
    H = ws[0].shape[2]
    common.check(x, "x")
    for i, w in enumerate(ws):
        common.check(w, f"w{i}", like=x, shape=(E, D, H))
    common.check(group_sizes, "group_sizes", like=x, dtype=torch.int32,
                 shape=(E,))
    dtype = common.dtype_code(x)
    y = torch.empty((E, C, H), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    p = launch_plan(x, ws)
    part: Optional[torch.Tensor] = None
    if p.splits > 1:
        part = torch.empty((p.splits, len(ws), E, C, H), dtype=torch.float32,
                           device=x.device)
    kernel.launch(x.data_ptr(), *(w.data_ptr() for w in ws),
                  group_sizes.data_ptr(), y.data_ptr(), common.ptr(part),
                  E, C, D, H, *act_code, dtype, PATH_CODES[p.path], p.rows,
                  p.cols, p.splits, p.grid, *common.stream_of(x))
    kernel.paths[p.path] = kernel.paths.get(p.path, 0) + 1
    return y
