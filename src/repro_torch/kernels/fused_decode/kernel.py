"""Wrapper of the CUDA fused decode kernels (``csrc/fused_decode.cu``), which
replace the Pallas TPU megakernel ``repro/kernels/fused_decode/kernel.py::
fused_forest_decode``: tree routing, each routed leaf's MLP, the forest
combine and the optional master leaf.  CPU tensors run the plain version in
``ref.py``.

``plan`` chooses, from the shapes alone, the path a call takes (TMA copies,
or element-wise copies where a tensor map cannot describe a row), the
tokens a chunk, the splits of D and of l, the ring stages, the grids and
the workspace; the C entry point launches its phases (route, up, a finish
where D is split, down, and a combine with more than one slot or l split)
on the caller's stream.  ``work`` lists
what each block of a plan does on a given routing.  Launches are counted by
path in ``KERNEL.paths``.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch

from repro_torch import utils
from repro_torch.kernels import common
from repro_torch.kernels.fused_decode import ref as R

P, I = common.P, common.I

KERNEL = common.register(common.Kernel(
    "fused_forest_decode", "fused_decode.cu", "fused_forest_decode",
    [P] * 12 + [I] * 18 + [P],
    replaces="src/repro/kernels/fused_decode/kernel.py:175"))

#: path codes the C entry point takes
PATH_CODES = {"elementwise": 0, "tma": 1}
H100_SMS = common.H100_SMS
#: a block's shared memory on the H100 (227 KB)
SMEM_LIMIT = 232448
#: a stream block's static shared memory: a full and an empty mbarrier for
#: each of up to MAX_STAGES stages, its token list, two ints
MAX_STAGES = 8
STATIC_SMEM = 2 * 8 * MAX_STAGES + 64 * 4 + 2 * 4
#: a stream block's ring: where a projection has no more units than the
#: card has SMs (one block an SM), else where several blocks share an SM
RING_ALONE, RING_SHARED = 140 * 1024, 72 * 1024
#: alignment slack of the ring's base (1024-byte swizzle atoms)
RING_ALIGN = 1024
#: the most ranges of k a projection splits into, and the fewest steps of k
#: a range keeps
MAX_SPLITS, MIN_SPLIT_STEPS = 32, 2
#: the split's cost model, from the H100 (the fused decode kernels' column
#: tiles): the rate the card's memory sustains for them, the rate one block
#: streams alone, what a block's start and end cost its SM (finding its leaf,
#: its stores) and what a finish or combine pass costs, in us
HBM_RATE, BLOCK_RATE = 2.9e12, 55e9
UNIT_US, PASS_US = 0.5, 2.5
#: token rows of an activation window (one 1024-byte swizzle atom)
WINDOW = 8
#: 128-byte rows of k (of the activations) a ring stage holds
STAGE_K = 2
#: threads of a finish or combine block
COMBINE_THREADS = 256


class Plan(NamedTuple):
    path: str             # "tma" or "elementwise"
    B: int
    D: int
    T: int
    depth: int
    l: int
    O: int
    mw: int               # master leaf width, 0 without one
    ops: int              # matrices of the up projection (2: the SwiGLU pair)
    elem: int             # bytes of an element
    chunk: int            # tokens of one pass of the phases
    cols: int             # a weight tile's columns (128 bytes)
    k_step: int           # rows of k a ring stage holds
    splits_up: int        # ranges of D a column tile of l is split into
    splits_down: int      # ranges of l a column tile of O is split into
    rmax: int             # distinct-leaf ranks a tree's blocks cover
    up_grid: tuple        # (column tiles, splits, trees x rmax + master)
    down_grid: tuple
    stages_up: int
    stages_down: int
    smem_up: int          # dynamic shared memory of a block, bytes
    smem_down: int
    direct: bool          # one slot and one range of l: the down projection writes y
    route_grid: tuple     # (tokens, trees) of the largest chunk
    finish_grid: int      # blocks of the finish (h from the up partials), 0 without a split
    combine_grid: tuple   # (column chunks of O, tokens); () when direct
    workspace: int        # bytes (``workspace_layout``)


def expected_leaves(E: int, tokens: int) -> float:
    """Distinct leaves of a tree that ``tokens`` uniformly routed tokens reach."""
    return E * (1.0 - (1.0 - 1.0 / E) ** tokens)


def _splits(pairs: float, tiles: int, nk: int, step_bytes: int, sms: int,
            pass_us: float) -> int:
    """The split of k for ``pairs`` x ``tiles`` (leaf, column tile) units of
    ``nk`` steps that ends soonest: the larger of all bytes over the
    memory's rate and the busiest SM's bytes over one block's rate, plus
    ``UNIT_US`` a unit on the busiest SM and, split, ``pass_us`` for the
    pass that sums the ranges; the fewer splits on a tie."""
    best = None
    for s in range(1, min(MAX_SPLITS, nk) + 1):
        if s > 1 and nk // s < MIN_SPLIT_STEPS:
            break
        units = math.ceil(pairs * tiles * s)
        busiest = math.ceil(units / sms)
        unit_bytes = utils.cdiv(nk, s) * step_bytes
        cost = (max(pairs * tiles * nk * step_bytes / HBM_RATE,
                    busiest * unit_bytes / BLOCK_RATE) * 1e6
                + busiest * UNIT_US + (pass_us if s > 1 else 0.0))
        if best is None or cost < best[0] - 1e-9:
            best = (cost, s)
    return best[1]


def _stages(stage: int, units: float, sms: int, steps: int) -> int:
    """Stages of a ring: as many as its budget holds (``RING_ALONE`` where
    the units expected fit one an SM, else ``RING_SHARED``) and a block has
    steps of k to fill, at least two."""
    ring = RING_ALONE if units <= sms else RING_SHARED
    return max(2, min(MAX_STAGES, ring // stage, steps))


def workspace_layout(T: int, b0: int, l: int, O: int, mw: int, ops: int, elem: int,
                     splits_up: int, splits_down: int, direct: bool) -> dict:
    """Offsets (and ``total`` bytes) of the workspace of a call whose largest
    chunk holds b0 tokens, each on 256 bytes: with D split, the up
    projection's f32 partial sums (splits_up, T, b0, ops, l) and the
    master's (splits_up, b0, ops, mw), h (T, b0, l) and hm (b0, mw) in the
    element type, then, unless the down
    projection writes y itself, its f32 partial sums (splits_down, T +
    master, b0, O)."""
    a256 = lambda n: utils.round_up(n, 256)
    ranges = splits_up if splits_up > 1 else 0      # one range: h directly
    part_m = a256(ranges * T * b0 * ops * l * 4)
    h = a256(part_m + ranges * b0 * ops * mw * 4)
    hm = a256(h + T * b0 * l * elem)
    part_down = a256(hm + b0 * mw * elem)
    total = part_down + (0 if direct else splits_down * (T + (mw > 0)) * b0 * O * 4)
    return dict(part_up=0, part_m=part_m, h=h, hm=hm, part_down=part_down, total=total)


@functools.lru_cache(maxsize=4096)
def plan(B: int, D: int, T: int, depth: int, l: int, O: int, mw: int,
         dtype: torch.dtype = torch.bfloat16, dual: bool = True,
         aligned: bool = True, sms: int = H100_SMS) -> Plan:
    """The launch of one fused decode call: x (B, D) through T trees of
    depth ``depth`` (leaves of width l into O outputs; ``dual``: the SwiGLU
    pair up) and a master leaf of width ``mw`` (0 without one).

    The TMA path takes D, l, O and mw multiples of 16 bytes and
    ``aligned`` bases; anything else the element-wise path.  A chunk holds
    at most 64 tokens (bf16; 32 in float32), a weight tile 128 bytes of
    columns, a ring stage ``STAGE_K`` 128-byte rows of k.  A projection's
    blocks run over (column tile, range of k, tree x rank up to min(chunk,
    E), then the master); the split of D (up) and of l (down) is the one
    ``_splits`` expects to end soonest when each tree routes the chunk
    uniformly.  D whole: the up projection writes h and no finish runs; one
    tree, no master leaf and l whole: the down projection writes y and no
    combine runs."""
    if min(B, D, T, depth, l, O) < 1 or mw < 0 or depth > 12:
        raise ValueError(f"fused decode plan needs positive sizes, got B={B} D={D} "
                         f"T={T} depth={depth} l={l} O={O} mw={mw}")
    cdiv = utils.cdiv
    elem = torch.finfo(dtype).bits // 8
    vec = 16 // elem
    path = "tma" if aligned and all(n % vec == 0 for n in (D, l, O, mw)) else "elementwise"
    chunk = 64 if elem == 2 else 32
    cols = 128 // elem
    k_step = STAGE_K * cols
    box = k_step * 128                             # one weight box: k_step rows of k
    E, ops, master = 2 ** depth, 2 if dual else 1, int(mw > 0)
    b0 = min(B, chunk)
    rmax = min(b0, E)
    pairs = T * expected_leaves(E, b0)
    win = STAGE_K * cdiv(b0, WINDOW) * WINDOW * 128   # a stage's activation windows
    up_pairs = pairs + master * cdiv(mw, cols) / cdiv(l, cols)
    splits_up = _splits(up_pairs, cdiv(l, cols), cdiv(D, k_step), ops * box + win, sms,
                        PASS_US)
    splits_down = _splits(pairs + master, cdiv(O, cols), cdiv(l, k_step), box + win, sms,
                          PASS_US if T == 1 and not master else 0.0)
    direct = T == 1 and not master and splits_down == 1
    stage_up, stage_down = ops * box + win, box + win
    stages_up = _stages(stage_up, up_pairs * cdiv(l, cols) * splits_up, sms,
                        cdiv(cdiv(D, k_step), splits_up))
    stages_down = _stages(stage_down, (pairs + master) * cdiv(O, cols) * splits_down, sms,
                          cdiv(max(cdiv(l, k_step), cdiv(mw, k_step)), splits_down))
    smem_up = RING_ALIGN + stages_up * stage_up
    smem_down = RING_ALIGN + stages_down * stage_down
    z = T * rmax + master
    return Plan(path, B, D, T, depth, l, O, mw, ops, elem, chunk, cols, k_step, splits_up,
                splits_down, rmax, (cdiv(max(l, mw), cols), splits_up, z),
                (cdiv(O, cols), splits_down, z), stages_up, stages_down, smem_up, smem_down,
                direct,
                (b0, T), cdiv(T * b0 * l + b0 * mw, COMBINE_THREADS) if splits_up > 1 else 0,
                () if direct else (cdiv(O, COMBINE_THREADS * (4 if O % 4 == 0 else 1)), b0),
                workspace_layout(T, b0, l, O, mw, ops, elem, splits_up, splits_down,
                                 direct)["total"])


class Work(NamedTuple):
    phase: str        # "route", "up", "finish", "down" or "combine"
    chunk: int        # the chunk's first token
    block: tuple      # the block's grid coordinates
    tree: int         # the tree (T: the master leaf; -1 in finish and combine)
    leaf: int         # the routed leaf (-1: the master, finish and combine)
    tokens: tuple     # the tokens it computes, in order
    cols: tuple       # (begin, end): columns of l or mw (up), of O (down,
                      # combine); in the finish, of the flattened (tree,
                      # token, column) h then hm
    ks: tuple         # (begin, end) of k it streams: of D (up), of l or mw (down)
    order: tuple      # the partial sums it adds, in order: splits (finish),
                      # (slot, split) pairs (combine)


def leaves_of(rows: list, t: int) -> list[int]:
    """Tree t's distinct routed leaves of a chunk's rows, ascending: the
    order of its units."""
    return sorted({r[t] for r in rows})


def work(p: Plan, leaf_idx) -> list[Work]:
    """What each block of plan ``p`` does on a routing ``leaf_idx`` (B, T)
    (what the route phase writes), chunk by chunk and phase by phase.  A
    projection's block (x, y, z) takes column tile x over range y of k for
    pair z: tree z // rmax's (z % rmax)-th smallest routed leaf, or the
    master leaf at z = T x rmax; a block whose tile lies past its leaf's
    width, or whose rank lies at or past its tree's distinct leaves, does
    nothing (no tokens)."""
    rows = [list(map(int, r)) for r in (leaf_idx.tolist() if hasattr(leaf_idx, "tolist")
                                        else leaf_idx)]
    if len(rows) != p.B or any(len(r) != p.T for r in rows):
        raise ValueError(f"leaf_idx must be ({p.B}, {p.T})")
    cdiv = utils.cdiv
    out = []
    for c0 in range(0, p.B, p.chunk):
        bc = min(p.chunk, p.B - c0)
        chunk = rows[c0:c0 + bc]
        for t in range(p.T):
            for b in range(bc):
                out.append(Work("route", c0, (b, t), t, chunk[b][t], (c0 + b,), (), (0, p.D), ()))
        leaves = [leaves_of(chunk, t) for t in range(p.T)]
        for phase, grid, K, Km, M, Mm in (("up", p.up_grid, p.D, p.D, p.l, p.mw),
                                          ("down", p.down_grid, p.l, p.mw, p.O, p.O)):
            tiles, splits, zs = grid
            for z in range(zs):
                if z >= p.T * p.rmax:
                    t, e, toks, k_len, width = p.T, -1, tuple(range(c0, c0 + bc)), Km, Mm
                else:
                    t, r = divmod(z, p.rmax)
                    e = leaves[t][r] if r < len(leaves[t]) else -1
                    toks = tuple(c0 + b for b in range(bc) if chunk[b][t] == e) if e >= 0 else ()
                    k_len, width = K, M
                nk = cdiv(k_len, p.k_step)
                for y in range(splits):
                    kb, ke = y * nk // splits, (y + 1) * nk // splits
                    for x in range(tiles):
                        if x * p.cols >= width or not toks:
                            out.append(Work(phase, c0, (x, y, z), t, -1, (), (), (), ()))
                            continue
                        out.append(Work(phase, c0, (x, y, z), t, e, toks,
                                        (x * p.cols, min(width, (x + 1) * p.cols)),
                                        (min(k_len, kb * p.k_step), min(k_len, ke * p.k_step)),
                                        ()))
            if phase == "up" and p.splits_up > 1:
                n = p.T * bc * p.l + bc * p.mw
                for x in range(cdiv(n, COMBINE_THREADS)):
                    out.append(Work("finish", c0, (x,), -1, -1, (),
                                    (x * COMBINE_THREADS, min(n, (x + 1) * COMBINE_THREADS)), (),
                                    tuple(range(p.splits_up))))
        if not p.direct:
            order = tuple((u, q) for u in range(p.T + (p.mw > 0)) for q in range(p.splits_down))
            per = COMBINE_THREADS * (4 if p.O % 4 == 0 else 1)
            for b in range(bc):
                for x in range(p.combine_grid[0]):
                    out.append(Work("combine", c0, (x, b), -1, -1, (c0 + b,),
                                    (x * per, min(p.O, (x + 1) * per)), (), order))
    return out


def fused_forest_decode(x: torch.Tensor, nw: torch.Tensor, nb: torch.Tensor,
                        leaf_w: tuple, *, depth: int, act: str = "gelu",
                        master_w: Optional[tuple] = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Route + each routed leaf's MLP + forest combine, one call.

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


def launch_plan(x: torch.Tensor, nw: torch.Tensor, leaf_w: tuple, depth: int,
                master_w: Optional[tuple]) -> Plan:
    """The plan a launch on these operands takes."""
    ws = (x, nw, *leaf_w, *(master_w or ()))
    bases = 0
    for t in ws:
        bases |= t.data_ptr()
    mw = master_w[0].shape[1] if master_w is not None else 0
    return plan(x.shape[0], x.shape[1], nw.shape[0], depth, leaf_w[0].shape[3],
                leaf_w[-1].shape[3], mw, x.dtype, len(leaf_w) == 3, bases % 16 == 0,
                common.sm_count(x.get_device()))


def _launch(x, nw, nb, leaf_w, depth, act, master_w):
    """The CUDA branch: operand checks, output and workspace allocation,
    the launch, its count by path."""
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
    p = launch_plan(x, nw, leaf_w, depth, master_w)
    # h, the master's h and, with more than one slot, the f32 slots; no fill
    ws = torch.empty(p.workspace, dtype=torch.uint8, device=x.device)
    ptr = common.ptr
    KERNEL.launch(ptr(x), ptr(nw), ptr(nb), ptr(up), ptr(up3), ptr(leaf_w[-1]),
                  ptr(m_up), ptr(m_up3), ptr(m_down), ptr(y), ptr(leaf_idx), ptr(ws),
                  B, D, T, depth, E, l, O, mw, common.ACT_CODES[act],
                  common.dtype_code(x), PATH_CODES[p.path], p.chunk, p.splits_up,
                  p.splits_down, p.rmax, p.stages_up, p.stages_down,
                  *common.stream_of(x))
    KERNEL.paths[p.path] = KERNEL.paths.get(p.path, 0) + 1
    return y, leaf_idx
