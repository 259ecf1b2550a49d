"""Wrappers of the CUDA grouped leaf GEMMs (``csrc/leaf_gemm.cu``), which
replace the Pallas TPU kernels ``repro/kernels/leaf_gemm/kernel.py::
grouped_matmul`` and ``::grouped_matmul_dual``: a ragged grouped GEMM over
capacity-padded per-leaf token buffers whose empty token tiles are skipped.
CPU tensors run the plain versions in ``ref.py``.

``plan`` chooses, from the shapes alone, the path a call takes (the TMA
kernel, the masked ``cp.async`` kernel or the float32 CUDA-core kernel), its
tile, its split of D and its grid; the C entry point launches that plan.
Each kernel counts its launches by path in ``Kernel.paths``."""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

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
#: SMs of an H100 SXM, what ``plan`` assumes without a card
H100_SMS = 132
#: D's step in the bf16 kernels (one 128-byte row of x)
K_STEP = 64
#: the TMA kernel's column tiles by form (dual?) and row tile
TMA_COLS = {False: {128: (64, 128, 256), 256: (64, 128)},
            True: {128: (64, 128), 256: (64,)}}
#: the masked kernel's tile (128 rows by 256 or 128 columns), the float32
#: kernel's (64 x 64) and its step along D
MASKED_COLS = {False: 256, True: 128}
F32_TILE, F32_K_STEP = 64, 16
#: the fewest steps of D a bf16 split range keeps (below it the second
#: pass costs more than the split gains on the H100)
MIN_SPLIT_STEPS = 4


class Plan(NamedTuple):
    path: str     # "tma", "masked" or "cuda_cores"
    rows: int     # token rows of a row tile
    cols: int     # output columns of a tile
    splits: int   # ranges of D summed by a second pass in a fixed order
    units: int    # work items: (leaf, column tile, range of D) on the TMA
                  # path, else blocks (leaf, row tile, column tile, range)
    grid: int     # blocks launched by the first pass


@functools.lru_cache(maxsize=4096)
def plan(E: int, C: int, D: int, H: int, dtype: torch.dtype = torch.bfloat16,
         dual: bool = False, aligned: bool = True, sms: int = H100_SMS) -> Plan:
    """The launch of one grouped GEMM call x (E, C, D) @ w (E, D, H).

    float32 takes the CUDA-core kernel, one block per (leaf, 64 rows, 64
    columns).  bf16 takes the TMA kernel when a tensor map can describe x
    and w (D and H multiples of 8, i.e. 16-byte rows, and ``aligned``: every
    base on 16 bytes), else the masked kernel.  The TMA kernel's row tile
    holds the whole capacity up to 256 (128 or 256 rows); one block an SM
    walks its units (leaf, column tile, range of D).  Where there are fewer
    units (or float32 blocks) than SMs, D may be split: up to ``sms //
    units`` ways, at most one range a step of D (and on the TMA path at
    least ``MIN_SPLIT_STEPS`` steps a range), the partials summed by a
    second pass.  float32 splits as far as that allows; the TMA path takes
    the column tile and split that keep the busiest SM's bytes least (its
    weights in full, x at a quarter since it comes from L2, and the
    partials' f32 write and read spread over the card), the larger tile
    and the fewer ranges on a tie."""
    if E < 1 or C < 1 or D < 1 or H < 1:
        raise ValueError(f"grouped GEMM plan needs positive sizes, got E={E} "
                         f"C={C} D={D} H={H}")
    cdiv = utils.cdiv
    if dtype == torch.float32:
        blocks = cdiv(H, F32_TILE) * cdiv(C, F32_TILE) * E
        splits = _splits(blocks, cdiv(D, F32_K_STEP), sms)
        return Plan("cuda_cores", F32_TILE, F32_TILE, splits, blocks * splits,
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


def work(p: Plan, E: int, C: int, D: int, H: int) -> list[tuple]:
    """What each block of plan ``p`` computes, in the kernels' own order:
    (block, leaf, row range, column range, D range) a tile, on the TMA path
    a block taking units block, block + grid, ... and each unit's row tiles
    in turn.  Holds the rows a tile could cover, live or not (a dead row
    tile writes zeros, or nothing under a split)."""
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
    nk = cdiv(D, step)
    out = []
    ht, ct = cdiv(H, p.cols), cdiv(C, p.rows)
    for z in range(E * p.splits):
        e, split = z % E, z // E
        kb, ke = split * nk // p.splits, (split + 1) * nk // p.splits
        for y in range(ct):
            for x in range(ht):
                b = (z * ct + y) * ht + x
                out.append((b, e, (y * p.rows, min(C, (y + 1) * p.rows)),
                            (x * p.cols, min(H, (x + 1) * p.cols)),
                            (kb * step, min(D, ke * step))))
    return out


@functools.lru_cache(maxsize=None)
def _sms(device: int) -> int:
    if device < 0:                # a CPU tensor only reaches here in tests
        return H100_SMS
    return torch.cuda.get_device_properties(device).multi_processor_count


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
                _sms(x.get_device()))


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
