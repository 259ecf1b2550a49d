"""Smoke run of the PyTorch/CUDA port on one GPU: the quickest proof that
the port still builds, agrees with its plain versions and serves.

    python3 chip_smoke.py

Phases (any failure raises, and the exit code is non-zero):

1. device   — a CUDA card must be present; prints its name and power limit.
2. build    — nvcc builds every kernel in src/repro_torch/kernels/csrc/.
3. kernels  — each kernel against its plain PyTorch version at the
              internlm2-20b FFF main-path shapes (D = 6144, depth 4, 16
              leaves of width 1024; decode batch 8; prefill 8 x 128 tokens;
              the gathered kernels at the 32-token verify slab, 6144 -> 1024
              and 1024 -> 6144, every activation, random, one-leaf and
              distinct-leaf routings), in float32 (TF32 off; tolerance
              1e-4) and bfloat16 (5e-2).  Leaf indices must match exactly
              except on near-ties (deciding logit |l| < 1e-3 in float32),
              which are counted; outputs are compared on tokens whose
              indices agree.  Times each kernel, its plain version and,
              where one PyTorch call computes the same function, that call
              (library_ms), with CUDA events.  The gathered kernels are also
              held at the per-leaf token counts where their per-pass cap of
              32 tokens a leaf shows (one leaf holding 0, 1, 31, 32, 33 and
              all 64 tokens of a 64-token slab, and a 33-token slab), and
              timed on the one-leaf and distinct routings beside a read-rate
              yardstick (torch.sum over the same weight bytes).  Every
              gathered and fused decode case is called twice and must come
              out bit-identical (no atomics in either sum).
              The grouped kernels and the router are also held and timed
              at a 256-token admission slab (lines of their own; the table
              stays at 1024).  Each kernel's time (ms) is its device time:
              CUDA events around replays of a CUDA graph of 20 calls, so
              the wrapper's host cost is left out; the loop of 20 launches
              that earlier tables used is logged beside it.  Each router
              row also logs torch.addmm of its logits and zero_() of its
              output, timed both ways.
   ragged   — the same kernels at the CPU tests' small unaligned sizes,
              which exercise their masked edge paths, the gathered
              kernels' guard for leaf indices outside [0, E) and their
              per-leaf token-count edges, and the
              grouped kernels at their tile edges: group sizes 0, 1, 63,
              64, 65, 127 and 128 in one call, capacity 256, and D and H
              off the bf16 kernel's k-step and column tile.
   router   — the router at depths 1-8, D = 6144, 20 and 24, B = 1, 31,
              33, 65, 256 and 1031, an unaligned x, all-left and all-right
              routings; both dtypes, every case twice and bit-identical.
4. serve    — internlm2-20b FFF at full width (bf16) with 8 of its 48
              layers, random weights from a seeded CUDA generator: batch 8,
              prompt 128, 16 greedy decode steps through
              repro_torch.launch.serve.serve (the fixed-batch loop); asserts
              each kernel's launch count on that run and that no site fell
              back to the reference, and reports how many prefill tokens
              overflowed a leaf's capacity (and took the dense repair).
   profile  — a warm prefill and warm decode steps of that model under
              torch.profiler: device busy share and the top kernels.
5. engine   — the same model and weights through the continuous-batching
              engine (repro_torch.launch.serve.serve_engine): 8 slots,
              speculative decoding with spec_k 3 (a 32-token verify slab)
              and the self:1 draft, fcfs, 16 Markov-source requests of
              16-128 prompt tokens and 32 new tokens each, monolithic then
              chunked (16-token chunks) admission.  Asserts the launch
              counts of each run (both gathered kernels once per layer per
              verify round, the fused decode kernel once per draft step,
              the grouped kernels once per layer per admission slab), the
              fixed dispatch shapes, and that the reference never ran.
   engine profile — three warm speculative rounds under torch.profiler.
6. parity   — the same width with 2 layers in float32: 8 greedy tokens from
              the kernel backends must equal those of the reference backend;
              then the engine (plain and speculative, monolithic and
              chunked) must give every request lm.generate's greedy tokens,
              except where a deciding margin (a node logit or the top-2
              logit gap) is under 1e-3.
7. grouped  — the capacity-bounded grouped backends.  The grouped GEMMs at
              the JAX grouped path's capacities (C = 8, 16, 136 and 264,
              group sizes 0, 1, C-1 and C in one call) against their plain
              versions at full width in both dtypes, timed beside the C =
              128 table row.  The 8-layer bf16 model served through the
              engine with fff_backend="grouped" (the engine phase's 16
              requests, spec_k 3), once with the default policy ("drop", cf
              2.0) and once with "exact_dense" at cf 0.5: asserts the
              grouped kernels' launch counts (one call each per layer per
              dispatch, no other kernel), that the reference never ran, and
              overflow with repairs at cf 0.5; logs the overflow means and
              each run's device-busy share over one profiled spec round.
              Then float32 at 2 layers: lm.generate through grouped
              ("exact_dense", cf 0.5) and one-process grouped_ep must give
              the reference backend's greedy tokens, and so must the engine
              on grouped ("exact_dense", cf 0.5), except at near-ties.
8. train    — the training path (repro_torch.launch.train, lm.loss_fn, the
              train backends, plain PyTorch under autograd: the JAX package
              trains through einsums, no Pallas kernel).  First the card
              against the CPU: FFF_CONFIG.reduced() in float32, one seeded
              param tree on both, loss, metrics and every gradient within
              1e-3 under train/reference and train/grouped, each with remat
              "none" and "full" (whose recompute runs in autograd's own
              thread on the card).  Then internlm2-20b FFF at full width,
              bf16, remat "full", 4 of 48 layers: 20 steps of
              launch.train.train, batch 8 x seq 128, lr 3e-4; every loss
              finite, every gradient finite and nonzero at step 0, no
              kernel launched, the mean loss of the last 5 steps at least
              TRAIN_MARGIN below step 0's; logs the step time p50 (CUDA
              events), peak memory, hardening, balance and the decisive
              fraction before and after, and profiles one warm step (the
              update of step 16 and the loss and gradient of step 17).  Last, 2 layers in float32 trained
              3 steps, then served: lm.generate (batch 4, prompt 32, 8
              greedy tokens) through the kernel backends (router, grouped
              GEMMs, fused decode; their launches asserted) must equal the
              reference backend's tokens, except where a row met a deciding
              margin under 1e-3.
9. ckpt     — checkpoint/restart training (repro_torch.checkpoint, the fault
              supervisor): internlm2-20b FFF at full width, bf16, remat
              "full", 1 of 48 layers (1.53B parameters; ~15 GB a checkpoint,
              so the phase fails unless the temporary directory's disk holds
              two).  (b) 6 uninterrupted steps of launch.train.train; (c) the
              same 6 steps under the supervisor (a checkpoint every 3 steps,
              async, keep 2, a failure injected at step 4): it ends at step
              6 with 1 restart, its losses and final parameters bit-identical
              to (b)'s; (a) a blocking save_tree and restore_tree of (c)'s
              final {params, opt}, bit-identical; (d) the step-6 checkpoint
              restored into a fresh model and served (batch 8, prompt 128, 8
              greedy tokens) through the kernels: the in-memory model's
              tokens.  Prints the free disk, the checkpoint bytes, the
              snapshot time on the caller's thread and the background write
              and restore times, each with its rate.  Then the command line
              on the card (--reduced), each run its own process: killed with
              SIGKILL after step 4 and run again, it resumes at step 3, and
              its step-5 line and step-6 checkpoint are the uninterrupted
              run's; and the data Prefetcher's card path.
10. dense   — the paper's FF baseline: internlm2-20b native (dense SwiGLU,
              d_ff 16384) at full width, bf16, 8 layers (4.26B parameters,
              as the serve phase): the fixed-batch loop (batch 8, prompt 128,
              16 decode steps; no kernel launches), then one warm prefill
              and one warm decode step of it and of the 8-layer FFF model,
              profiled, with the FFN sites' device time (the kernels inside
              the 8 sites' device-side ranges) side by side; then
              the reduced native LM's loss and gradients on the card against
              the CPU (1e-3).

Prints the kernel table as one JSON line (launches from the monolithic
engine run), the card's name and power limit, and, last,
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}   # dense, no TF32
TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}   # tests/conftest.py "kernel"
NEAR_TIE = 1e-3

# main-path shapes: internlm2-20b FFF at full width
D, DEPTH, E, L_W, O = 6144, 4, 16, 1024, 6144
N_NODES = 2 ** DEPTH - 1
DECODE_B, PREFILL_B, PREFILL_S, SLAB_B = 8, 8, 128, 256
SERVE_LAYERS, GEN, PARITY_LAYERS, PARITY_B, PARITY_S, PARITY_STEPS = 8, 16, 2, 4, 32, 8
# the engine: 8 slots x (spec_k 3 + 1) = the 32-token verify slab
SLOTS, SPEC_K, ENGINE_REQS, ENGINE_PROMPT, ENGINE_MIN_PROMPT, ENGINE_GEN = 8, 3, 16, 128, 16, 32
ENGINE_CHUNK, DRAFT_LAYERS = 16, 1
VERIFY_B = SLOTS * (SPEC_K + 1)
ACTS = ("none", "relu", "gelu", "silu")
# tokens on one leaf of a 64-token slab around the gathered kernels' per-pass
# cap of 32 tokens a leaf (csrc/fused_fff.cu kMaxTok)
LEAF_EDGES, EDGE_B = (0, 1, 31, 32, 33, 64), 64
# the capacities of the JAX grouped path (multiples of 8, not of 128)
GROUPED_CAPS = (8, 16, 136, 264)
# the train phase: full width, 4 layers, the JAX driver's defaults; the loss
# must fall by TRAIN_MARGIN (nats, last 5 steps' mean against step 0)
TRAIN_LAYERS, TRAIN_STEPS, TRAIN_B, TRAIN_S, TRAIN_LR, TRAIN_MARGIN = 4, 20, 8, 128, 3e-4, 1.0
TRAIN_SERVE_LAYERS, TRAIN_SERVE_STEPS = 2, 3
# the ckpt phase: full width, 1 of 48 layers (bf16 params and float32 moments,
# ~10 bytes a parameter: ~15 GB a checkpoint, CKPT_KEEP of them on disk); a
# failure injected at CKPT_FAIL_AT; the restored model serves CKPT_GEN tokens
CKPT_LAYERS, CKPT_STEPS, CKPT_EVERY, CKPT_FAIL_AT, CKPT_KEEP, CKPT_GEN = 1, 6, 3, 4, 2, 8


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Device time per call: CUDA events around replays of a CUDA graph that
    holds ``reps`` calls.  A loop of launches (``time_ms``) times the host
    instead once a call's Python, ctypes and launch cost exceeds the
    kernel's run, as it does for the router."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (reps * replays)


def bound(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def margins(x, nw, nb, depth):
    """Per token: the leaf the float32 plain descent reaches and the
    smallest |deciding logit| on its path."""
    xf = x.float()
    idx = torch.zeros(x.shape[0], dtype=torch.long, device=x.device)
    margin = torch.full((x.shape[0],), float("inf"), device=x.device)
    for m in range(depth):
        g = (2 ** m - 1) + idx
        logit = (xf * nw[g].float()).sum(-1) + nb[g].float()
        margin = torch.minimum(margin, logit.abs())
        idx = 2 * idx + (logit >= 0).long()
    return idx, margin


def compare_idx(name, got, want, margin):
    """Exact leaf indices except near-ties; returns the agreeing mask, the
    number of near-tie disagreements and the largest index difference off
    near-ties (0, or this raises)."""
    agree = got.long() == want.long()
    bad = ~agree & (margin >= NEAR_TIE)
    if bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} tokens routed "
                             f"differently away from any near-tie")
    diff = (got.long() - want.long()).abs()[margin >= NEAR_TIE]
    return agree, int((~agree).sum()), float(diff.max()) if diff.numel() else 0.0


def twice(name, fn):
    """fn() called twice: the two outputs must be equal bit for bit."""
    first, again = fn(), fn()
    for a, b in zip(first if isinstance(first, tuple) else (first,),
                    again if isinstance(again, tuple) else (again,)):
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: two calls on one input differ")
    return first


def edge_routing(gen, n, leaf=5, B=EDGE_B, num_leaves=E):
    """B int32 leaf indices in [0, num_leaves), exactly n of them `leaf`."""
    dev = torch.device("cuda")
    idx = torch.randint(0, num_leaves - 1, (B,), generator=gen, device=dev,
                        dtype=torch.int32)
    idx[idx >= leaf] += 1
    idx[torch.randperm(B, generator=gen, device=dev)[:n]] = leaf
    return idx


def compare(name, got, want, dtype, rows=None):
    if rows is not None:
        got, want = got[rows], want[rows]
    g, w = got.float(), want.float()
    tol = TOL[dtype]
    err = (g - w).abs()
    if not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{name}: non-finite kernel output")
    if bool((err > tol + tol * w.abs()).any()):
        raise AssertionError(f"{name} [{dtype}]: max |err| {float(err.max()):.3e}"
                             f" exceeds rtol=atol={tol}")
    return float(err.max())


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    if not (SRC / "repro_torch").is_dir():
        raise SystemExit(f"chip_smoke: {SRC / 'repro_torch'} not found; run "
                         f"from a checkout of the repository")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(f"[device] {name} | torch {torch.__version__} cuda {torch.version.cuda}"
        f" | TF32 off for float32 matmuls and convolutions")
    return name, smi


def phase_build(common) -> None:
    t0 = time.perf_counter()
    took = common.build_all()
    log(f"[build] {len(took)} libraries built in {time.perf_counter() - t0:.1f}s "
        + " ".join(f"{k}={v:.1f}s" for k, v in took.items()))


def router_row(label, x, nw, nb, depth=DEPTH) -> dict:
    """The router on one input: leaf indices against the float32 plain
    descent, two calls bit-identical, device and loop times, the plain
    version, the bound; and on a line of its own two yardsticks, timed the
    same ways: ``torch.addmm`` of the logits alone (no single PyTorch call
    computes the descent, so the row has no library time) and ``zero_()`` of
    the (B,) int32 output, the smallest launch."""
    from repro_torch.kernels.tree_router import kernel as trk, ref as trr
    B, d = x.shape
    N = nw.shape[0]
    sz = x.element_size()
    got = trk.tree_router(x, nw, nb, depth=depth)
    if not torch.equal(got, trk.tree_router(x, nw, nb, depth=depth)):
        raise AssertionError(f"{label}: two calls on one input differ")
    want, margin = margins(x, nw, nb, depth)
    _, ties, err = compare_idx(label, got, want, margin)
    call = lambda: trk.tree_router(x, nw, nb, depth=depth)
    b, by = bound(B * d * sz + N * (d + 1) * sz + B * 4, 2 * B * N * d, x.dtype)
    out = torch.empty(B, dtype=torch.int32, device=x.device)
    logits = lambda: torch.addmm(nb, x, nw.T)
    log(f"[kernels] {label} yardsticks {str(x.dtype):15s} torch.addmm logits "
        f"{device_ms(logits):.4f} ms (loop {time_ms(logits):.4f}); zero_ of the "
        f"output {device_ms(out.zero_):.4f} ms (loop {time_ms(out.zero_):.4f})")
    return dict(max_abs_err=err, ms=device_ms(call), loop_ms=time_ms(call),
                plain_ms=time_ms(lambda: trr.tree_router_ref(x, nw, nb, depth=depth)),
                bound_ms=b, bound_by=by, library_ms=None, near_ties=ties)


def phase_kernels(gen) -> dict:
    from repro_torch.kernels.fused_decode import kernel as fdk, ref as fdr
    from repro_torch.kernels.leaf_gemm import kernel as gk, ref as gr

    dev = torch.device("cuda")
    rows = {}

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    for dtype in (torch.float32, torch.bfloat16):
        sz = 2 if dtype == torch.bfloat16 else 4
        # -- tree_router: prefill routing, 1024 tokens x 15 nodes x 6144
        B = PREFILL_B * PREFILL_S
        x = randn(B, D, dtype=dtype)
        nw = randn(N_NODES, D, scale=D ** -0.5, dtype=dtype)
        nb = randn(N_NODES, scale=0.1, dtype=dtype)
        rows[("tree_router", dtype)] = router_row("tree_router", x, nw, nb)

        # -- grouped GEMMs: 1024 routed tokens in 16 capacity-128 groups
        C = max(128, math.ceil(2 * math.ceil(B / E) / 128) * 128)   # leaf_gemm capacity
        leaf = torch.randint(0, E, (B,), generator=gen, device=dev)
        gs = torch.bincount(leaf, minlength=E).clamp(max=C).to(torch.int32)
        mask = (torch.arange(C, device=dev)[None, :] < gs[:, None])[..., None]
        xg = randn(E, C, D, dtype=dtype) * mask
        wg = randn(E, D, L_W, scale=D ** -0.5, dtype=dtype)
        wu = randn(E, D, L_W, scale=D ** -0.5, dtype=dtype)
        wd = randn(E, L_W, O, scale=L_W ** -0.5, dtype=dtype)
        tokens = int(gs.sum())
        live = int((gs > 0).sum())
        h = gk.grouped_matmul_dual(xg, wg, wu, gs)
        err = compare("grouped_matmul_dual", h, gr.grouped_matmul_dual_ref(xg, wg, wu, gs), dtype)
        call = lambda: gk.grouped_matmul_dual(xg, wg, wu, gs)
        plain = time_ms(lambda: gr.grouped_matmul_dual_ref(xg, wg, wu, gs))
        b, by = bound(live * 2 * D * L_W * sz + tokens * D * sz + E * C * L_W * sz,
                      2 * 2 * tokens * D * L_W, dtype)
        rows[("grouped_matmul_dual", dtype)] = dict(
            max_abs_err=err, ms=device_ms(call), loop_ms=time_ms(call), plain_ms=plain,
            bound_ms=b, bound_by=by, library_ms=None)

        y = gk.grouped_matmul(h, wd, gs)
        err = compare("grouped_matmul", y, gr.grouped_matmul_ref(h, wd, gs), dtype)
        call = lambda: gk.grouped_matmul(h, wd, gs)
        plain = time_ms(lambda: gr.grouped_matmul_ref(h, wd, gs))
        lib = device_ms(lambda: torch.bmm(h, wd))
        b, by = bound(live * L_W * O * sz + tokens * L_W * sz + E * C * O * sz,
                      2 * tokens * L_W * O, dtype)
        rows[("grouped_matmul", dtype)] = dict(
            max_abs_err=err, ms=device_ms(call), loop_ms=time_ms(call), plain_ms=plain,
            bound_ms=b, bound_by=by, library_ms=lib)
        del xg, h, y
        grouped_slab(dtype, wg, wu, wd)
        router_slab(dtype, nw, nb)

        # -- fused forest decode: batch 8, one tree of 16 SwiGLU leaves
        xd = randn(DECODE_B, D, dtype=dtype)
        nwf, nbf = nw[None], nb[None]
        leaves = (wg[None], wu[None], wd[None])
        y, idx = twice("fused_forest_decode", lambda: fdk.fused_forest_decode(
            xd, nwf, nbf, leaves, depth=DEPTH, act="swiglu"))
        y_ref, idx_ref = fdr.fused_decode_ref(xd, nwf, nbf, leaves, depth=DEPTH, act="swiglu")
        _, margin = margins(xd, nw, nb, DEPTH)
        agree, ties, _ = compare_idx("fused_forest_decode", idx[:, 0], idx_ref[:, 0], margin)
        err = compare("fused_forest_decode", y, y_ref, dtype, rows=agree)
        call = lambda: fdk.fused_forest_decode(xd, nwf, nbf, leaves, depth=DEPTH,
                                               act="swiglu")
        plain = time_ms(lambda: fdr.fused_decode_ref(xd, nwf, nbf, leaves,
                                                     depth=DEPTH, act="swiglu"))
        distinct = int(torch.unique(idx).numel())
        b, by = bound(distinct * 3 * D * L_W * sz + N_NODES * D * sz
                      + DECODE_B * (D + O) * sz,
                      2 * DECODE_B * (N_NODES * D + 3 * D * L_W), dtype)
        rows[("fused_forest_decode", dtype)] = dict(
            max_abs_err=err, ms=device_ms(call), loop_ms=time_ms(call), plain_ms=plain,
            bound_ms=b, bound_by=by, library_ms=None, near_ties=ties,
            distinct_leaves=distinct)
        del wg, wu, wd, leaves
        torch.cuda.empty_cache()
    log_rows(rows)
    return rows


def grouped_slab(dtype, wg, wu, wd, tokens=SLAB_B) -> None:
    """Both grouped kernels at an engine admission slab of 256 tokens in
    the main path's capacity-128 groups (~16 tokens a leaf, so every block
    has one live 64-row half): agreement and times, logged beside the
    table's 1024-token rows.  Its own generator leaves the table's inputs
    as they were."""
    from repro_torch.kernels.leaf_gemm import kernel as gk, ref as gr
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    sz = 2 if dtype == torch.bfloat16 else 4
    C = 128
    leaf = torch.randint(0, E, (tokens,), generator=gen, device=dev)
    gs = torch.bincount(leaf, minlength=E).clamp(max=C).to(torch.int32)
    mask = (torch.arange(C, device=dev)[None, :] < gs[:, None])[..., None]
    xg = (torch.randn((E, C, D), generator=gen, device=dev) * mask).to(dtype)
    live, n = int((gs > 0).sum()), int(gs.sum())
    h = gk.grouped_matmul_dual(xg, wg, wu, gs)
    err_d = compare("grouped_matmul_dual @256", h, gr.grouped_matmul_dual_ref(xg, wg, wu, gs), dtype)
    err = compare("grouped_matmul @256", gk.grouped_matmul(h, wd, gs),
                  gr.grouped_matmul_ref(h, wd, gs), dtype)
    ms_d = device_ms(lambda: gk.grouped_matmul_dual(xg, wg, wu, gs))
    ms = device_ms(lambda: gk.grouped_matmul(h, wd, gs))
    lib = device_ms(lambda: torch.bmm(h, wd))
    b_d, _ = bound(live * 2 * D * L_W * sz + n * D * sz + E * C * L_W * sz,
                   2 * 2 * n * D * L_W, dtype)
    b, _ = bound(live * L_W * O * sz + n * L_W * sz + E * C * O * sz,
                 2 * n * L_W * O, dtype)
    log(f"[kernels] grouped @{tokens} tokens {str(dtype):15s} (group sizes "
        f"{min(gs.tolist())}-{max(gs.tolist())}): grouped_matmul_dual {ms_d:.4f} ms"
        f" (bound {b_d:.4f}, kernel/bound {ms_d / b_d:.2f}, max|err| {err_d:.3e});"
        f" grouped_matmul {ms:.4f} ms (bound {b:.4f}, kernel/bound {ms / b:.2f},"
        f" max|err| {err:.3e}); torch.bmm {lib:.4f} ms")


def router_slab(dtype, nw, nb, tokens=SLAB_B) -> None:
    """The router at an engine admission slab of 256 tokens (4 token tiles,
    32 blocks), logged beside the grouped slab line; its own generator
    leaves the table's inputs as they were."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((tokens, D), generator=gen, device="cuda").to(dtype)
    r = router_row(f"tree_router@{tokens}", x, nw, nb)
    log(f"[kernels] tree_router @{tokens} tokens {str(dtype):15s} {r['ms']:.4f} ms "
        f"(loop {r['loop_ms']:.4f}; bound {r['bound_ms']:.4f}, kernel/bound "
        f"{r['ms'] / r['bound_ms']:.2f}; plain {r['plain_ms']:.4f}; near-ties "
        f"{r['near_ties']})")


def phase_gathered(gen) -> dict:
    """The verify slab's kernels: the gathered leaf matmuls at 32 tokens,
    6144 -> 1024 (the SwiGLU up-projection, and gathered_matmul with every
    activation) and 1024 -> 6144 (the down-projection), E = 16, under a
    random routing, every token on one leaf, 16 tokens on 16 distinct
    leaves, a 64-token slab with 0, 1, 31, 32, 33 or 64 tokens on one leaf
    and a 33-token slab, each call twice and bit-identical; the table rows
    are timed on the random routing, whose bound counts each distinct
    routed leaf once, and the one-leaf and distinct routings and a
    read-rate yardstick are logged beside them; and the tree router at 32
    tokens (a row of its own, "tree_router@32", beside the prefill-shape
    row)."""
    from repro_torch.kernels.fused_fff import kernel as fk, ref as fr

    dev = torch.device("cuda")
    rows = {}

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    for dtype in (torch.float32, torch.bfloat16):
        sz = 2 if dtype == torch.bfloat16 else 4
        x = randn(VERIFY_B, D, dtype=dtype)
        nw = randn(N_NODES, D, scale=D ** -0.5, dtype=dtype)
        nb = randn(N_NODES, scale=0.1, dtype=dtype)
        rows[("tree_router@32", dtype)] = router_row("tree_router@32", x, nw, nb)
        wg = randn(E, D, L_W, scale=D ** -0.5, dtype=dtype)
        wu = randn(E, D, L_W, scale=D ** -0.5, dtype=dtype)
        wd = randn(E, L_W, O, scale=L_W ** -0.5, dtype=dtype)
        i32 = dict(device=dev, dtype=torch.int32)
        routings = {
            "random": torch.randint(0, E, (VERIFY_B,), generator=gen, **i32),
            "one leaf": torch.full((VERIFY_B,), 5, **i32),
            "distinct": torch.randperm(E, generator=gen, device=dev).to(torch.int32)}
        # the count edges draw from a generator of their own, which leaves
        # the next dtype's table inputs as they were
        egen = torch.Generator(device=dev).manual_seed(5)
        xe = (torch.randn((EDGE_B, D), generator=egen, device=dev)).to(dtype)
        for n in LEAF_EDGES:
            routings[f"{n} of {EDGE_B} on one leaf"] = edge_routing(egen, n)
        routings["33 tokens"] = torch.randint(0, E, (33,), generator=egen, **i32)
        times = {}
        for rname, idx in routings.items():
            xb = (x if idx.numel() <= VERIFY_B else xe)[:idx.numel()]
            h = twice(f"gathered_matmul_dual ({rname})",
                      lambda: fk.gathered_matmul_dual(xb, wg, wu, idx))
            compare(f"gathered_matmul_dual ({rname})", h,
                    fr.gathered_matmul_dual_ref(xb, wg, wu, idx), dtype)
            for act in ACTS:
                compare(f"gathered_matmul {act} 6144->1024 ({rname})",
                        twice(f"gathered_matmul {act} ({rname})",
                              lambda: fk.gathered_matmul(xb, wg, idx, act=act)),
                        fr.gathered_matmul_ref(xb, wg, idx, act=act), dtype)
            compare(f"gathered_matmul 1024->6144 ({rname})",
                    twice(f"gathered_matmul 1024->6144 ({rname})",
                          lambda: fk.gathered_matmul(h, wd, idx)),
                    fr.gathered_matmul_ref(h, wd, idx), dtype)
            if rname in ("one leaf", "distinct"):
                times[rname] = (device_ms(lambda: fk.gathered_matmul_dual(xb, wg, wu, idx)),
                                device_ms(lambda: fk.gathered_matmul(h, wd, idx)))
        idx = routings["random"]
        distinct = int(torch.unique(idx).numel())
        h = fk.gathered_matmul_dual(x, wg, wu, idx)
        err = compare("gathered_matmul_dual", h,
                      fr.gathered_matmul_dual_ref(x, wg, wu, idx), dtype)
        call = lambda: fk.gathered_matmul_dual(x, wg, wu, idx)
        plain = time_ms(lambda: fr.gathered_matmul_dual_ref(x, wg, wu, idx))
        b, by = bound(distinct * 2 * D * L_W * sz + VERIFY_B * (D + L_W) * sz
                      + VERIFY_B * 4, 2 * 2 * VERIFY_B * D * L_W, dtype)
        rows[("gathered_matmul_dual", dtype)] = dict(
            max_abs_err=err, ms=device_ms(call), loop_ms=time_ms(call), plain_ms=plain,
            bound_ms=b, bound_by=by, library_ms=None, distinct_leaves=distinct)
        y = fk.gathered_matmul(h, wd, idx)
        err = compare("gathered_matmul", y, fr.gathered_matmul_ref(h, wd, idx), dtype)
        call = lambda: fk.gathered_matmul(h, wd, idx)
        plain = time_ms(lambda: fr.gathered_matmul_ref(h, wd, idx))
        b, by = bound(distinct * L_W * O * sz + VERIFY_B * (L_W + O) * sz
                      + VERIFY_B * 4, 2 * VERIFY_B * L_W * O, dtype)
        rows[("gathered_matmul", dtype)] = dict(
            max_abs_err=err, ms=device_ms(call), loop_ms=time_ms(call), plain_ms=plain,
            bound_ms=b, bound_by=by, library_ms=None, distinct_leaves=distinct)
        # read-rate yardstick: one library read of the same weight bytes (the
        # first `distinct` leaves); no single PyTorch call computes a
        # gathered matmul, so this is no library_ms
        flat_g, flat_u = wg[:distinct].reshape(-1), wu[:distinct].reshape(-1)
        flat_d = wd[:distinct].reshape(-1)
        read_d = device_ms(lambda: (flat_g.sum(), flat_u.sum()))
        read = device_ms(flat_d.sum)
        dual_b, down_b = 2 * flat_g.numel() * sz, flat_d.numel() * sz
        log(f"[kernels] gathered {str(dtype):15s} device ms by routing: dual random "
            f"{rows[('gathered_matmul_dual', dtype)]['ms']:.4f} / one leaf "
            f"{times['one leaf'][0]:.4f} / distinct {times['distinct'][0]:.4f}; down "
            f"{rows[('gathered_matmul', dtype)]['ms']:.4f} / {times['one leaf'][1]:.4f} / "
            f"{times['distinct'][1]:.4f}; read-rate yardstick torch.sum over the "
            f"{distinct} routed leaves' bytes: wg+wu {dual_b / 1e6:.1f} MB {read_d:.4f} ms "
            f"({dual_b / read_d / 1e9:.2f} TB/s; dual kernel "
            f"{dual_b / rows[('gathered_matmul_dual', dtype)]['ms'] / 1e9:.2f}), wd "
            f"{down_b / 1e6:.1f} MB {read:.4f} ms ({down_b / read / 1e9:.2f} TB/s; down "
            f"kernel {down_b / rows[('gathered_matmul', dtype)]['ms'] / 1e9:.2f})")
        del wg, wu, wd, flat_g, flat_u, flat_d
        torch.cuda.empty_cache()
    log_rows(rows)
    log(f"[kernels] gathered kernels agree in {len(routings)} routings x "
        f"{len(ACTS) + 2} products per dtype, each called twice with "
        f"bit-identical outputs")
    return rows


def log_rows(rows) -> None:
    for (name, dtype), r in rows.items():
        log(f"[kernels] {name:20s} {str(dtype):15s} max|err| {r['max_abs_err']:.3e}"
            f"  kernel {r['ms']:.4f} ms (loop {r['loop_ms']:.4f})  plain "
            f"{r['plain_ms']:.4f} ms  bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}, kernel/bound "
            f"{r['ms'] / r['bound_ms']:.2f})  library "
            + (f"{r['library_ms']:.4f} ms" if r["library_ms"] is not None else "n/a")
            + (f"  near-ties {r['near_ties']}" if "near_ties" in r else "")
            + (f"  distinct leaves {r['distinct_leaves']}" if "distinct_leaves" in r else ""))


def gathered_pair(label, x, w, w2, idx, act, dtype):
    """Both gathered kernels on one input against their plain versions,
    each called twice with bit-identical outputs."""
    from repro_torch.kernels.fused_fff import kernel as fk, ref as fr
    y = twice(f"gathered_matmul {label}", lambda: fk.gathered_matmul(x, w, idx, act=act))
    compare(f"gathered_matmul {label}", y, fr.gathered_matmul_ref(x, w, idx, act=act), dtype)
    y2 = twice(f"gathered_matmul_dual {label}", lambda: fk.gathered_matmul_dual(x, w, w2, idx))
    compare(f"gathered_matmul_dual {label}", y2, fr.gathered_matmul_dual_ref(x, w, w2, idx), dtype)
    return y, y2


def phase_ragged(gen) -> None:
    """The kernels' masked and element-wise paths, at the CPU tests' small
    sizes (which the full-width shapes never reach): odd batches, D = 20
    and 24, leaf widths 4 and 8, a two-tree forest, the master leaf, every
    activation."""
    from repro_torch.kernels.fused_decode import kernel as fdk, ref as fdr
    from repro_torch.kernels.fused_fff import kernel as fk, ref as fr
    from repro_torch.kernels.leaf_gemm import kernel as gk, ref as gr
    from repro_torch.kernels.tree_router import kernel as trk

    dev = torch.device("cuda")
    checked = 0

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    # D = 20 takes the element-wise paths; D = 24 (a multiple of 8) the
    # 16-byte ones wherever the other widths allow
    for d, dtype in [(d, t) for d in (20, 24)
                     for t in (torch.float32, torch.bfloat16)]:
        for B, depth in ((1, 1), (7, 2), (37, 4)):
            N = 2 ** depth - 1
            x = randn(B, d, dtype=dtype)
            nw, nb = randn(N, d, scale=d ** -0.5, dtype=dtype), randn(N, scale=0.1, dtype=dtype)
            want, margin = margins(x, nw, nb, depth)
            compare_idx("tree_router (ragged)", trk.tree_router(x, nw, nb, depth=depth),
                        want, margin)
            checked += 1
        for H, act in ((4, "gelu"), (8, "relu"), (8, "silu")):
            E, C = 3, 16
            gs = torch.tensor([0, 5, 16], dtype=torch.int32, device=dev)
            mask = (torch.arange(C, device=dev)[None, :] < gs[:, None])[..., None]
            x = randn(E, C, d, dtype=dtype) * mask
            w, w2 = (randn(E, d, H, scale=d ** -0.5, dtype=dtype) for _ in range(2))
            compare("grouped_matmul (ragged)", gk.grouped_matmul(x, w, gs, act=act),
                    gr.grouped_matmul_ref(x, w, gs, act=act), dtype)
            compare("grouped_matmul_dual (ragged)", gk.grouped_matmul_dual(x, w, w2, gs),
                    gr.grouped_matmul_dual_ref(x, w, w2, gs), dtype)
            checked += 2
        for act, leaf, master in (("gelu", 4, False), ("swiglu", 8, True),
                                  ("relu", 8, True)):
            T, depth, B = 2, 3, 7
            N, E = 2 ** depth - 1, 2 ** depth
            x = randn(B, d, dtype=dtype)
            nw, nb = randn(T, N, d, scale=d ** -0.5, dtype=dtype), randn(T, N, scale=0.1, dtype=dtype)
            n_up = 2 if act == "swiglu" else 1
            leaves = tuple(randn(T, E, d, leaf, scale=d ** -0.5, dtype=dtype)
                           for _ in range(n_up)) + (randn(T, E, leaf, d, scale=leaf ** -0.5, dtype=dtype),)
            mw = 5
            mst = (tuple(randn(d, mw, scale=d ** -0.5, dtype=dtype) for _ in range(n_up))
                   + (randn(mw, d, scale=mw ** -0.5, dtype=dtype),)) if master else None
            y, idx = twice("fused_forest_decode (ragged)", lambda: fdk.fused_forest_decode(
                x, nw, nb, leaves, depth=depth, act=act, master_w=mst))
            y_ref, idx_ref = fdr.fused_decode_ref(x, nw, nb, leaves, depth=depth, act=act, master_w=mst)
            agree = torch.ones(B, dtype=torch.bool, device=dev)
            for t in range(T):
                _, margin = margins(x, nw[t], nb[t], depth)
                a, _, _ = compare_idx("fused_forest_decode (ragged)", idx[:, t], idx_ref[:, t], margin)
                agree &= a
            compare("fused_forest_decode (ragged)", y, y_ref, dtype, rows=agree)
            checked += 1
        # gathered: H = 8 takes the 16-byte loads in both dtypes, 12 in
        # float32 only, 13 in neither; B = 7 routes two tokens outside
        # [0, E), whose rows must come out zero
        for B, H, act in ((1, 8, "gelu"), (7, 12, "relu"), (31, 13, "silu")):
            E = 3
            x = randn(B, d, dtype=dtype)
            w, w2 = (randn(E, d, H, scale=d ** -0.5, dtype=dtype) for _ in range(2))
            idx = torch.randint(0, E, (B,), generator=gen, device=dev, dtype=torch.int32)
            if B == 7:
                idx[0], idx[-1] = -1, E
            y, y2 = gathered_pair("(ragged)", x, w, w2, idx, act, dtype)
            if B == 7 and (float(y[[0, -1]].abs().max()) != 0.0
                           or float(y2[[0, -1]].abs().max()) != 0.0):
                raise AssertionError("gathered kernels: an index outside [0, E) "
                                     "did not give a zero row")
            checked += 2
        # the per-leaf token counts at the per-pass cap: 64 tokens with 0,
        # 1, 31, 32, 33 or 64 of them on one leaf, and a 33-token slab; H = 8
        # (16-byte loads in both dtypes) and 13 (element-wise)
        for H in (8, 13):
            w, w2 = (randn(4, d, H, scale=d ** -0.5, dtype=dtype) for _ in range(2))
            cases = [(f"{n} on one leaf", edge_routing(gen, n, leaf=2, num_leaves=4))
                     for n in LEAF_EDGES]
            cases.append(("33 tokens", torch.randint(0, 4, (33,), generator=gen, device=dev,
                                                     dtype=torch.int32)))
            for label, idx in cases:
                gathered_pair(f"(ragged, {label}, H {H})", randn(idx.numel(), d, dtype=dtype),
                              w, w2, idx, "gelu", dtype)
                checked += 2
    checked += grouped_edges(gen)
    torch.cuda.synchronize()
    log(f"[ragged] {checked} small kernel cases agree with their plain "
        f"versions (fp32 and bf16)")


def phase_router(gen) -> None:
    """The router wherever its design branches: every depth 1-8 (one 8-node
    tile per warp up to depth 4, up to 8 tiles at depths 5-7, 16 at depth
    8), D = 6144 and the CPU tests' 20 (element-wise copies) and 24
    (16-byte copies), B = 1, 31, 33, 65, 256 and 1031 (partial 64-token
    tiles, one and several clusters), an x one element off its alignment
    (element-wise copies at full width), and all-left and all-right
    routings (zero node weights, bias -1 or +1); both dtypes, each case
    called twice and bit-identical (the cluster reduction runs in a fixed
    order)."""
    from repro_torch.kernels.tree_router import kernel as trk
    dev = torch.device("cuda")
    checked = ties = 0

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def check(label, x, nw, nb, depth):
        got = trk.tree_router(x, nw, nb, depth=depth)
        if not torch.equal(got, trk.tree_router(x, nw, nb, depth=depth)):
            raise AssertionError(f"{label}: two calls on one input differ")
        want, margin = margins(x, nw, nb, depth)
        return got, compare_idx(label, got, want, margin)[1]

    for dtype in (torch.float32, torch.bfloat16):
        for depth in range(1, 9):
            N = 2 ** depth - 1
            for d in (D, 20, 24):
                nw = randn(N, d, scale=d ** -0.5, dtype=dtype)
                nb = randn(N, scale=0.1, dtype=dtype)
                for B in (1, 31, 33, 65, 256, 1031):
                    _, t = check(f"tree_router (depth {depth}, D {d}, B {B}, {dtype})",
                                 randn(B, d, dtype=dtype), nw, nb, depth)
                    ties += t
                    checked += 1
        for depth in (4, 8):
            N = 2 ** depth - 1
            nw = randn(N, D, scale=D ** -0.5, dtype=dtype)
            nb = randn(N, scale=0.1, dtype=dtype)
            x = randn(33 * D + 1, dtype=dtype)[1:].view(33, D)
            _, t = check(f"tree_router (unaligned x, depth {depth}, {dtype})", x, nw, nb, depth)
            ties += t
            x = randn(1031, D, dtype=dtype)
            for bias, leaf in ((-1.0, 0), (1.0, 2 ** depth - 1)):
                nw = torch.zeros(N, D, dtype=dtype, device=dev)
                nb = torch.full((N,), bias, dtype=dtype, device=dev)
                got, _ = check(f"tree_router (bias {bias}, depth {depth}, {dtype})",
                               x, nw, nb, depth)
                if not bool((got == leaf).all()):
                    raise AssertionError(f"tree_router: zero weights and bias {bias} "
                                         f"must send every token to leaf {leaf}")
            checked += 3
    torch.cuda.synchronize()
    log(f"[router] {checked} router cases agree with the plain descent ({ties} "
        f"near-tie differences), each called twice with bit-identical outputs")


def grouped_edges(gen) -> int:
    """The grouped kernels at their tile edges: group sizes 0, 1, 63, 64,
    65, 127 and 128 in one call at capacity 128 (empty, partial and full
    64-row halves), capacity 256 (two row blocks), and widths off the
    bf16 kernel's 64-deep k-steps and 128- (dual) or 256-column (down)
    tiles, every activation, both dtypes.  Returns the cases checked."""
    from repro_torch.kernels.leaf_gemm import kernel as gk, ref as gr
    dev = torch.device("cuda")
    checked = 0
    cases = [(128, [0, 1, 63, 64, 65, 127, 128], 256, 1024),   # tile-aligned
             (128, [0, 1, 63, 64, 65, 127, 128], 136, 200),    # D, H off the tiles
             (256, [0, 100, 200, 256], 192, 328)]              # two row blocks
    for dtype in (torch.float32, torch.bfloat16):
        for C, sizes, d, H in cases:
            gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
            E_ = gs.numel()
            mask = (torch.arange(C, device=dev)[None, :] < gs[:, None])[..., None]
            x = (torch.randn((E_, C, d), generator=gen, device=dev) * mask).to(dtype)
            w, w2 = ((torch.randn((E_, d, H), generator=gen, device=dev) * d ** -0.5).to(dtype)
                     for _ in range(2))
            tag = f"C={C} D={d} H={H}"
            y2 = gk.grouped_matmul_dual(x, w, w2, gs)
            compare(f"grouped_matmul_dual (edges {tag})", y2,
                    gr.grouped_matmul_dual_ref(x, w, w2, gs), dtype)
            for act in ACTS:
                y = gk.grouped_matmul(x, w, gs, act=act)
                compare(f"grouped_matmul {act} (edges {tag})", y,
                        gr.grouped_matmul_ref(x, w, gs, act=act), dtype)
            rows_past = ~mask[..., 0]
            if float(y2[rows_past].abs().max()) != 0.0 or float(y[rows_past].abs().max()) != 0.0:
                raise AssertionError(f"grouped kernels ({tag}): a row past its "
                                     f"group's size is not zero")
            checked += 1 + len(ACTS)
    return checked


@contextlib.contextmanager
def no_reference(api):
    """Fails the run if the reference backend ran inside the context."""
    calls = []
    ref_fn = api.get_backend("infer", "reference")
    api.register_backend("infer", "reference",
                         lambda *a: (calls.append(1), ref_fn(*a))[1])
    try:
        yield
    finally:
        api.register_backend("infer", "reference", ref_fn)
    if calls:
        raise AssertionError(f"the reference backend ran {len(calls)} times "
                             f"on the kernel path")


def phase_serve(common, api, serve_mod, cfg, params) -> dict:
    from repro_torch.models import lm
    from repro_torch.kernels.leaf_gemm import ops as gemm_ops
    scatter = gemm_ops.scatter_to_groups
    layouts = []

    def recording_scatter(x, leaf_idx, num_leaves, capacity):
        # keeps each prefill layer's kept mask (a device tensor: no sync)
        out = scatter(x, leaf_idx, num_leaves, capacity)
        layouts.append(out.kept)
        return out

    gemm_ops.scatter_to_groups = recording_scatter
    try:
        with no_reference(api):
            common.reset_launch_counts()
            res = serve_mod.serve(cfg, batch=PREFILL_B, prompt_len=PREFILL_S,
                                  gen=GEN, device="cuda", params=params)
            counts = common.launch_counts()
    finally:
        gemm_ops.scatter_to_groups = scatter
    want = {"fused_forest_decode": cfg.n_layers * GEN,
            "tree_router": cfg.n_layers, "grouped_matmul_dual": cfg.n_layers,
            "grouped_matmul": cfg.n_layers, "gathered_matmul": 0,
            "gathered_matmul_dual": 0}
    if counts != want:
        raise AssertionError(f"launch counts {counts} != expected {want}")
    toks = res.tokens
    if tuple(toks.shape) != (PREFILL_B, GEN + 1) or not bool(
            ((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError(f"bad generated tokens {tuple(toks.shape)}")
    dropped = [int((~k).sum()) for k in layouts]
    log(f"[serve] prefill tokens over their leaf's capacity (dense repair): "
        f"{sum(dropped)} of {sum(k.numel() for k in layouts)} over "
        f"{len(layouts)} layers, per layer {dropped}")
    log(f"[serve] prefill {res.prefill_s * 1e3:.2f} ms; decode p50 "
        f"{res.steady.p50_ms:.2f} ms p90 {res.steady.p90_ms:.2f} ms; "
        f"{res.tokens_per_s:.1f} tok/s; launches {counts} (as expected); "
        f"reference backend never ran")
    phase_profile(cfg, params, lm)
    return counts


def profile_report(label, prof, wall_s, steps) -> None:
    averages = prof.key_averages()
    # kernels, memsets, copies; not the device span a scheduled profiler's
    # step annotation (ProfilerStep#) reports over them
    events = [e for e in averages if str(e.device_type).endswith("CUDA")
              and not e.key.startswith("ProfilerStep")]
    dev = lambda e: getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0))
    busy_us = sum(dev(e) for e in events)
    mm_us = sum(dev(e) for e in events if any(
        n in e.key.lower() for n in ("gemm", "nvjet", "xmma", "cutlass", "matmul")))
    launches = sum(e.count for e in averages if e.key.startswith(
        ("cudaLaunchKernel", "cuLaunchKernel")))
    # each blocking copy (.cpu(), float(t), a pageable upload) syncs the host
    syncs = sum(e.count for e in averages if e.key == "cudaStreamSynchronize")
    d2h = sum(e.count for e in events if e.key.startswith("Memcpy DtoH"))
    top = sorted(events, key=dev, reverse=True)[:8]
    log(f"[profile] {label}: {wall_s / steps * 1e3:.2f} ms per step (host "
        f"clock, profiler on); device busy {busy_us / 1e3 / steps:.2f} ms "
        f"per step = {busy_us / 1e6 / wall_s:.1%} of the window; "
        f"{launches / steps:.0f} kernel launches, {syncs / steps:.0f} stream "
        f"syncs and {d2h / steps:.0f} device-to-host copies per step; matmul "
        f"kernels {mm_us / 1e3 / steps:.2f} ms, the rest "
        f"{(busy_us - mm_us) / 1e3 / steps:.2f} ms per step")
    router = [e for e in events if "tree_router" in e.key]
    for e in top + [e for e in router if e not in top]:
        log(f"[profile]   {dev(e) / 1e3 / steps:8.3f} ms/step  {e.count // steps:4d}"
            f" calls/step  {e.key[:90]}")


def phase_profile(cfg, params, lm) -> None:
    """Where a warm prefill and a warm decode step spend their time:
    host-clock step time, device busy share (kernel time over the window)
    and the kernels with the most device time, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    # a seeded prompt: its overflow repairs, launches and syncs repeat from run to run
    prompt = torch.randint(0, cfg.vocab_size, (PREFILL_B, PREFILL_S), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(4),
                           dtype=torch.int32)
    max_len = PREFILL_S + GEN + 1

    def prefill():
        caches = lm.init_caches(cfg, PREFILL_B, max_len, device="cuda")
        out = lm.prefill(params, cfg, {"tokens": prompt}, caches)
        torch.cuda.synchronize()
        return out

    with torch.inference_mode():
        prefill()                                   # warm
        t0 = time.perf_counter()
        for _ in range(3):
            logits, caches = prefill()
        log(f"[profile] warm prefill {PREFILL_B}x{PREFILL_S}: "
            f"{(time.perf_counter() - t0) / 3 * 1e3:.2f} ms (host clock, mean of 3)")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            logits, caches = prefill()
            wall = time.perf_counter() - t0
        profile_report("prefill", prof, wall, 1)
        tok = logits.argmax(-1)[:, None].to(torch.int32)
        steps = 4
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(steps):
                logits, caches = lm.decode_step(params, cfg, tok, caches, PREFILL_S + i)
                tok = logits.argmax(-1)[:, None].to(torch.int32)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        profile_report("decode", prof, wall, steps)


def phase_parity(api, fff, lm, FFF_CONFIG) -> None:
    cfg = dataclasses.replace(FFF_CONFIG, n_layers=PARITY_LAYERS,
                              param_dtype=torch.float32,
                              accum_dtype=torch.float32)
    params = lm.init(cfg, seed=1, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(2)
    prompt = torch.randint(0, cfg.vocab_size, (PARITY_B, PARITY_S),
                           generator=gen, device="cuda", dtype=torch.int32)
    max_len = PARITY_S + PARITY_STEPS + 1
    with torch.inference_mode():
        kern = lm.generate(params, cfg, prompt, PARITY_STEPS, max_len)
        ref_fn = api.get_backend("infer", "reference")
        smallest = [math.inf]

        def recording_reference(p, c, x, spec):
            # the smallest deciding |node logit| the reference sees
            xf = x.reshape(-1, x.shape[-1]).to(c.accum_dtype)
            logits = fff._node_logits_all(p, c, xf)[:, 0]
            idx = torch.zeros(xf.shape[0], dtype=torch.long, device=x.device)
            off = 0
            for m in range(c.depth):
                cur = logits[:, off:off + 2 ** m].gather(1, idx[:, None])[:, 0]
                smallest[0] = min(smallest[0], float(cur.abs().min()))
                idx = 2 * idx + (cur >= 0).long()
                off += 2 ** m
            return ref_fn(p, c, x, spec)

        api.register_backend("infer", "reference", recording_reference)
        try:
            with api.overrides(backend="reference", mode="infer"):
                ref = lm.generate(params, cfg, prompt, PARITY_STEPS, max_len)
        finally:
            api.register_backend("infer", "reference", ref_fn)
    if not torch.equal(kern, ref):
        raise AssertionError(
            f"greedy tokens differ between the kernel and reference backends "
            f"(smallest deciding |node logit| on the path: {smallest[0]:.3e}):"
            f"\nkernel    {kern[:, PARITY_S:].tolist()}"
            f"\nreference {ref[:, PARITY_S:].tolist()}")
    log(f"[parity] {cfg.n_layers} layers fp32, batch {PARITY_B} x prompt "
        f"{PARITY_S}: {PARITY_STEPS} greedy tokens identical (kernel vs "
        f"reference); smallest deciding |node logit| {smallest[0]:.3e}")


def phase_engine(common, api, serve_mod, cfg, params) -> dict:
    """The continuous-batching engine with speculative decoding at full
    width: monolithic, then chunked admission, each run's launch counts
    reset just before it and read just after.  Returns the monolithic
    run's counts."""
    from repro_torch.serving.engine import EngineConfig
    reqs = serve_mod.build_requests(cfg.vocab_size, ENGINE_REQS, ENGINE_PROMPT,
                                    ENGINE_GEN, seed=0,
                                    min_prompt_len=ENGINE_MIN_PROMPT)
    n_layers = cfg.n_layers
    out = {}
    for mode, chunk in (("monolithic", 0), ("chunked", ENGINE_CHUNK)):
        ecfg = EngineConfig(num_slots=SLOTS, max_len=ENGINE_PROMPT + ENGINE_GEN + 1,
                            max_prompt_len=ENGINE_PROMPT, prefill_chunk=chunk,
                            spec_k=SPEC_K, draft_config=f"self:{DRAFT_LAYERS}",
                            scheduler="fcfs", seed=0, device="cuda")
        log(f"[engine] {mode}: {cfg.arch_id} FFF full width, {n_layers} layers "
            f"{cfg.param_dtype}, {SLOTS} slots, spec_k {SPEC_K}, draft "
            f"self:{DRAFT_LAYERS}, {len(reqs)} requests, prompts "
            f"{min(len(r.prompt) for r in reqs)}-{max(len(r.prompt) for r in reqs)}"
            f" tokens, {ENGINE_GEN} new tokens each")
        with no_reference(api):
            common.reset_launch_counts()
            run = serve_mod.serve_engine(cfg, ecfg, reqs, params=params)
            counts = common.launch_counts()
        m = run.metrics
        rounds = m.n_steps
        slabs = m.n_chunks if chunk else m.n_prefills
        # a verify round: every target layer once through the gathered
        # kernels (and the router); a draft step: the fused decode kernel
        # per draft layer; an admission slab (> 32 tokens): the grouped
        # kernels and the router per target and draft layer
        want = {"gathered_matmul": n_layers * rounds,
                "gathered_matmul_dual": n_layers * rounds,
                "fused_forest_decode": DRAFT_LAYERS * (SPEC_K + 1) * rounds,
                "grouped_matmul": (n_layers + DRAFT_LAYERS) * slabs,
                "grouped_matmul_dual": (n_layers + DRAFT_LAYERS) * slabs,
                "tree_router": n_layers * rounds + (n_layers + DRAFT_LAYERS) * slabs}
        if counts != want:
            raise AssertionError(f"[engine] {mode}: launch counts {counts} != "
                                 f"expected {want}")
        shapes = run.shapes
        want_shapes = {"draft": {(SLOTS, 1)}, "verify": {(SLOTS, SPEC_K + 1)}}
        if chunk:
            want_shapes["chunk"] = {(SLOTS, chunk)}
        else:
            want_shapes.update({k: {(SLOTS, int(k.split("_")[1]))}
                                for k in shapes if k.startswith("prefill_")})
        if shapes != want_shapes:
            raise AssertionError(f"[engine] {mode}: dispatch shapes {shapes} "
                                 f"!= {want_shapes}")
        bad = [r.rid for r in run.results
               if len(r.tokens) != ENGINE_GEN or r.finish_reason != "length"
               or not ((r.tokens >= 0) & (r.tokens < cfg.vocab_size)).all()]
        if len(run.results) != len(reqs) or bad:
            raise AssertionError(f"[engine] {mode}: bad results for rids {bad}")
        log(f"[engine] {mode}: TTFT p50 {m.ttft.p50_ms:.2f} ms p90 "
            f"{m.ttft.p90_ms:.2f} ms; per-token p50 {m.per_token.p50_ms:.2f} ms "
            f"p90 {m.per_token.p90_ms:.2f} ms; {m.throughput_tok_s:.1f} tok/s; "
            f"{rounds} spec rounds (p50 {m.decode_step.p50_ms:.2f} ms), {slabs} "
            f"admission slabs; spec acceptance {m.spec_acceptance:.3f} "
            f"({m.accepted_tokens}/{m.draft_tokens}; random weights: says "
            f"nothing of a trained model's acceptance); launches {counts} (as "
            f"expected: each gathered kernel {n_layers} per verify round); "
            f"dispatch shapes {sorted((k, sorted(v)) for k, v in shapes.items())}")
        out[mode] = counts
    phase_engine_profile(cfg, params)
    return out["monolithic"]


def phase_engine_profile(cfg, params, steps=3, label="", **ecfg_kw) -> None:
    """Where a warm speculative round's time goes: a warm engine with every
    slot live and no admission pending, ``steps`` rounds under
    torch.profiler; ``ecfg_kw`` adds engine knobs (the grouped phase's
    backend and policy)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.engine import ContinuousBatchingEngine, EngineConfig
    from repro_torch.serving.request import Request
    ecfg = EngineConfig(num_slots=SLOTS, max_len=ENGINE_PROMPT + ENGINE_GEN + 1,
                        max_prompt_len=ENGINE_PROMPT, spec_k=SPEC_K,
                        draft_config=f"self:{DRAFT_LAYERS}", max_prefills_per_step=SLOTS,
                        device="cuda", **ecfg_kw)
    eng = ContinuousBatchingEngine(params, cfg, ecfg)
    gen = torch.Generator().manual_seed(3)
    for i in range(SLOTS):
        eng.submit(Request(rid=i, prompt=torch.randint(
            0, cfg.vocab_size, (ENGINE_PROMPT,), generator=gen).numpy(),
            max_new_tokens=ENGINE_GEN))
    eng.step()                       # admit every slot, then one warm round
    eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if eng.n_steps != steps + 2 or eng.queue:
        raise AssertionError("[engine profile] the window was not spec rounds alone")
    profile_report(f"spec round (4 draft steps + 32-token verify){label}", prof,
                   wall, steps)


def phase_engine_parity(api, fff, lm, serve_mod, FFF_CONFIG) -> None:
    """The engine, plain and speculative, monolithic and chunked, against
    lm.generate request by request (fp32, full width, 2 layers).  A token
    may differ only where the generate run met a deciding margin under
    NEAR_TIE: a node logit, or the gap between the two largest logits."""
    from repro_torch.serving.engine import ContinuousBatchingEngine, EngineConfig
    cfg = dataclasses.replace(FFF_CONFIG, n_layers=PARITY_LAYERS,
                              param_dtype=torch.float32,
                              accum_dtype=torch.float32)
    params = lm.init(cfg, seed=1, device="cuda")
    slots, prompt, steps = 4, 32, 8
    reqs = serve_mod.build_requests(cfg.vocab_size, 8, prompt, steps, seed=2,
                                    min_prompt_len=8)
    max_len = prompt + steps + 1
    want, margin = generate_with_margins(api, fff, lm, cfg, params, reqs, steps, max_len)
    ties = 0
    for spec_k in (0, SPEC_K):
        for chunk in (0, 16):
            ecfg = EngineConfig(num_slots=slots, max_len=max_len,
                                max_prompt_len=prompt, prefill_chunk=chunk,
                                spec_k=spec_k, device="cuda")
            results, _ = ContinuousBatchingEngine(params, cfg, ecfg).run(reqs)
            ties += near_tie_check(f"[engine parity] spec_k {spec_k} chunk {chunk}",
                                   {r.rid: r.tokens for r in results}, want, margin)
    log(f"[engine parity] {cfg.n_layers} layers fp32, {slots} slots, {len(reqs)} "
        f"requests x {steps} greedy tokens: the plain and speculative (spec_k "
        f"{SPEC_K}, a {slots * (SPEC_K + 1)}-token verify slab) engines, "
        f"monolithic and chunked, equal lm.generate for every request "
        f"({ties} near-tie differences allowed); smallest deciding margin "
        f"{min(margin.values()):.3e}")
    del params
    torch.cuda.empty_cache()


def near_tie_check(label, got, want, margin) -> int:
    """Greedy tokens per request against ``want``: a request may differ only
    where the run that made ``want`` met a deciding margin under NEAR_TIE.
    Returns how many differed."""
    ties = 0
    for rid, toks in got.items():
        if (toks == want[rid]).all():
            continue
        if margin[rid] >= NEAR_TIE:
            raise AssertionError(
                f"{label} rid {rid}: {toks.tolist()} != {want[rid].tolist()} "
                f"with no deciding margin under {NEAR_TIE} (smallest "
                f"{margin[rid]:.3e})")
        ties += 1
    return ties


def generate_with_margins(api, fff, lm, cfg, params, reqs, steps, max_len,
                          **overrides):
    """lm.generate's greedy tokens for each request alone (under
    ``api.overrides(**overrides)`` when given), and the smallest deciding
    margin each met: a node logit on a routed path, or the gap between the
    two largest logits."""
    smallest = {}
    apply_fn, head_fn = api.apply, lm._head

    def recording_apply(p, c, x, spec=api.ExecutionSpec()):
        xf = x.reshape(-1, x.shape[-1]).to(c.accum_dtype)
        logits = fff._node_logits_all(p, c, xf)[:, 0]
        idx = torch.zeros(xf.shape[0], dtype=torch.long, device=x.device)
        off = 0
        for m in range(c.depth):
            cur = logits[:, off:off + 2 ** m].gather(1, idx[:, None])[:, 0]
            smallest["now"] = min(smallest["now"], float(cur.abs().min()))
            idx = 2 * idx + (cur >= 0).long()
            off += 2 ** m
        return apply_fn(p, c, x, spec)

    def recording_head(p, c, x):
        out = head_fn(p, c, x)
        top2 = out.topk(2, dim=-1).values
        smallest["now"] = min(smallest["now"], float((top2[..., 0] - top2[..., 1]).min()))
        return out

    want, margin = {}, {}
    api.apply, lm._head = recording_apply, recording_head
    try:
        with torch.inference_mode(), (api.overrides(**overrides) if overrides
                                      else contextlib.nullcontext()):
            for r in reqs:
                smallest["now"] = math.inf
                out = lm.generate(params, cfg, torch.from_numpy(r.prompt)[None].cuda(),
                                  steps, max_len)
                want[r.rid] = out[0, len(r.prompt):].cpu().numpy()
                margin[r.rid] = smallest["now"]
    finally:
        api.apply, lm._head = apply_fn, head_fn
    return want, margin


def grouped_capacities(rows) -> None:
    """Both grouped kernels at the JAX grouped path's capacities, full width,
    both dtypes: C = 8, 16, 136 and 264 with group sizes 0, 1, C-1 and C
    (four leaves each) in one call, against their plain versions, rows past
    a group's size zero; device times and bounds logged beside the table's C
    = 128 row.  Its own generator leaves the earlier phases' inputs as they
    were."""
    from repro_torch.kernels.leaf_gemm import kernel as gk, ref as gr
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    for dtype in (torch.float32, torch.bfloat16):
        sz = 2 if dtype == torch.bfloat16 else 4
        wg = randn(E, D, L_W, scale=D ** -0.5, dtype=dtype)
        wu = randn(E, D, L_W, scale=D ** -0.5, dtype=dtype)
        wd = randn(E, L_W, O, scale=L_W ** -0.5, dtype=dtype)
        table = (rows[("grouped_matmul_dual", dtype)]["ms"],
                 rows[("grouped_matmul", dtype)]["ms"])
        for C in GROUPED_CAPS:
            gs = torch.tensor([0, 1, C - 1, C] * (E // 4), dtype=torch.int32, device=dev)
            mask = (torch.arange(C, device=dev)[None, :] < gs[:, None])[..., None]
            xg = randn(E, C, D, dtype=dtype) * mask
            h = gk.grouped_matmul_dual(xg, wg, wu, gs)
            err_d = compare(f"grouped_matmul_dual (C={C})", h,
                            gr.grouped_matmul_dual_ref(xg, wg, wu, gs), dtype)
            y = gk.grouped_matmul(h, wd, gs)
            err = compare(f"grouped_matmul (C={C})", y, gr.grouped_matmul_ref(h, wd, gs), dtype)
            past = ~mask[..., 0]
            if float(h[past].abs().max()) != 0.0 or float(y[past].abs().max()) != 0.0:
                raise AssertionError(f"grouped kernels (C={C}): a row past its "
                                     f"group's size is not zero")
            live, n = int((gs > 0).sum()), int(gs.sum())
            b_d, _ = bound(live * 2 * D * L_W * sz + n * D * sz + E * C * L_W * sz,
                           2 * 2 * n * D * L_W, dtype)
            b, by = bound(live * L_W * O * sz + n * L_W * sz + E * C * O * sz,
                          2 * n * L_W * O, dtype)
            ms_d = device_ms(lambda: gk.grouped_matmul_dual(xg, wg, wu, gs))
            ms = device_ms(lambda: gk.grouped_matmul(h, wd, gs))
            log(f"[grouped] C={C:3d} {str(dtype):15s} ({n} tokens in {live} live "
                f"leaves): grouped_matmul_dual {ms_d:.4f} ms (bound {b_d:.4f}, "
                f"kernel/bound {ms_d / b_d:.2f}, max|err| {err_d:.3e}); grouped_matmul "
                f"{ms:.4f} ms (bound {b:.4f} {by}, kernel/bound {ms / b:.2f}, max|err| "
                f"{err:.3e}); table row C=128: {table[0]:.4f} / {table[1]:.4f} ms")
        del wg, wu, wd
        torch.cuda.empty_cache()


def phase_grouped_serving(common, api, serve_mod, cfg, params) -> None:
    """The full-width bf16 model served through the engine on the grouped
    backend: the engine phase's requests, monolithic admission, spec_k 3,
    with the default policy ("drop", cf 2.0) and with "exact_dense" at cf
    0.5; each run's launch counts reset just before it and read just after,
    then one profiled spec round of a warm engine with the same knobs."""
    from repro_torch.serving.engine import EngineConfig
    reqs = serve_mod.build_requests(cfg.vocab_size, ENGINE_REQS, ENGINE_PROMPT,
                                    ENGINE_GEN, seed=0,
                                    min_prompt_len=ENGINE_MIN_PROMPT)
    n_layers = cfg.n_layers
    for label, kw in (("drop, cf 2.0 (the defaults)", {}),
                      ("exact_dense, cf 0.5", dict(overflow_policy="exact_dense",
                                                   capacity_factor=0.5))):
        ecfg = EngineConfig(num_slots=SLOTS, max_len=ENGINE_PROMPT + ENGINE_GEN + 1,
                            max_prompt_len=ENGINE_PROMPT, spec_k=SPEC_K,
                            draft_config=f"self:{DRAFT_LAYERS}", scheduler="fcfs",
                            seed=0, device="cuda", fff_backend="grouped", **kw)
        with no_reference(api):
            common.reset_launch_counts()
            run = serve_mod.serve_engine(cfg, ecfg, reqs, params=params)
            counts = common.launch_counts()
        m = run.metrics
        rounds, slabs = m.n_steps, m.n_prefills
        # every FFF dispatch on the grouped backend, one call of each kernel
        # per layer: the verify slab and the admission slabs through the
        # target's layers and the draft's, each draft step through the draft's
        per_kernel = (n_layers * (rounds + slabs)
                      + DRAFT_LAYERS * ((SPEC_K + 1) * rounds + slabs))
        want = {k: 0 for k in counts}
        want["grouped_matmul"] = want["grouped_matmul_dual"] = per_kernel
        if counts != want:
            raise AssertionError(f"[grouped] {label}: launch counts {counts} != "
                                 f"expected {want}")
        bad = [r.rid for r in run.results
               if len(r.tokens) != ENGINE_GEN or r.finish_reason != "length"
               or not ((r.tokens >= 0) & (r.tokens < cfg.vocab_size)).all()]
        if len(run.results) != len(reqs) or bad:
            raise AssertionError(f"[grouped] {label}: bad results for rids {bad}")
        if kw and not (m.overflow_fraction_mean > 0 and m.overflow_repairs > 0):
            raise AssertionError(f"[grouped] {label}: no overflow repaired "
                                 f"(overflow mean {m.overflow_fraction_mean})")
        log(f"[grouped] engine, {label}: overflow mean {m.overflow_fraction_mean:.4f}"
            f" (decode-side {m.overflow_decode_mean:.4f}), ~{m.overflow_repairs} "
            f"slots repaired; TTFT p50 {m.ttft.p50_ms:.2f} ms; per-token p50 "
            f"{m.per_token.p50_ms:.2f} ms; {m.throughput_tok_s:.1f} tok/s; {rounds} "
            f"spec rounds (p50 {m.decode_step.p50_ms:.2f} ms), {slabs} admission "
            f"slabs; launches {counts} (as expected: each grouped kernel once per "
            f"layer per dispatch); reference backend never ran")
        phase_engine_profile(cfg, params, steps=1, label=f", grouped {label}",
                             fff_backend="grouped", **kw)


def phase_grouped_parity(api, fff, lm, serve_mod, FFF_CONFIG) -> None:
    """float32, full width, 2 layers: lm.generate through grouped
    ("exact_dense", cf 0.5) and through one-process grouped_ep (its default
    "exact_dense", cf 1.25), and the engine on grouped ("exact_dense", cf
    0.5, plain and speculative), all against the reference backend's
    lm.generate, request by request, except at near-ties."""
    from repro_torch.serving.engine import ContinuousBatchingEngine, EngineConfig
    cfg = dataclasses.replace(FFF_CONFIG, n_layers=PARITY_LAYERS,
                              param_dtype=torch.float32,
                              accum_dtype=torch.float32)
    params = lm.init(cfg, seed=1, device="cuda")
    slots, prompt, steps = 4, 32, 8
    reqs = serve_mod.build_requests(cfg.vocab_size, 8, prompt, steps, seed=2,
                                    min_prompt_len=8)
    max_len = prompt + steps + 1
    want, margin = generate_with_margins(api, fff, lm, cfg, params, reqs, steps,
                                         max_len, backend="reference", mode="infer")
    exact = dict(capacity_factor=0.5, overflow_policy="exact_dense")
    ties = {}
    for label, kw in (("grouped exact_dense cf 0.5", dict(backend="grouped", **exact)),
                      ("grouped_ep", dict(backend="grouped_ep"))):
        got, _ = generate_with_margins(api, fff, lm, cfg, params, reqs, steps,
                                       max_len, mode="infer", **kw)
        ties[label] = near_tie_check(f"[grouped parity] lm.generate {label}", got,
                                     want, margin)
    for spec_k in (0, SPEC_K):
        ecfg = EngineConfig(num_slots=slots, max_len=max_len, max_prompt_len=prompt,
                            spec_k=spec_k, fff_backend="grouped", device="cuda",
                            **exact)
        results, m = ContinuousBatchingEngine(params, cfg, ecfg).run(reqs)
        label = f"engine spec_k {spec_k}"
        ties[label] = near_tie_check(f"[grouped parity] {label}",
                                     {r.rid: r.tokens for r in results}, want, margin)
        ties[label + " overflow"] = m.overflow_fraction_mean
    log(f"[grouped parity] {cfg.n_layers} layers fp32, {len(reqs)} requests x "
        f"{steps} greedy tokens: lm.generate on grouped (exact_dense, cf 0.5) and "
        f"on grouped_ep (one process, exact_dense, cf 1.25), and the engine on "
        f"grouped (exact_dense, cf 0.5; plain and spec_k {SPEC_K}), equal the "
        f"reference backend's lm.generate for every request; near-tie "
        f"differences and engine overflow means {ties}; smallest deciding margin "
        f"{min(margin.values()):.3e}")
    del params
    torch.cuda.empty_cache()


def train_card_vs_cpu(api, lm, base_cfg, backends=("reference", "grouped"),
                      label="train") -> None:
    """base_cfg.reduced() in float32: loss, metrics and every gradient of
    lm.loss_fn on the card against the port's own CPU result (1e-3), under
    each train backend (they steer FFF sites only), remat none and full."""
    from repro_torch import optim, utils
    from repro_torch.data import tokens as tokens_lib
    cfg = base_cfg.reduced()
    cpu = lm.init(cfg, seed=3, device="cpu")
    card = utils.tree_map(lambda p: p.to("cuda"), cpu)
    batch = tokens_lib.MarkovTokenSource(cfg.vocab_size, seed=3).batch(4, 32, seed=3)
    worst = {}
    for backend in backends:
        for remat in ("none", "full"):
            c = dataclasses.replace(cfg, remat=remat)
            vg = optim.value_and_grad(lambda p, b: lm.loss_fn(p, c, b))
            with api.overrides(backend=backend, mode="train"):
                (_, want_m), want_g = vg(cpu, batch)
                (_, got_m), got_g = vg(card, batch)
            pairs = [(f"metric {k}", got_m[k], want_m[k]) for k in want_m]
            pairs += [(f"grad {i}", g, w) for i, (g, w) in enumerate(
                zip(utils.tree_leaves(got_g), utils.tree_leaves(want_g)))]
            err = 0.0
            for name, g, w in pairs:
                g, w = g.float().cpu(), w.float()
                e = (g - w).abs()
                if not bool(torch.isfinite(g).all()) or bool((e > 1e-3 + 1e-3 * w.abs()).any()):
                    raise AssertionError(f"[{label}] card vs CPU, {backend} remat {remat}: "
                                         f"{name} max |err| {float(e.max()):.3e} "
                                         f"exceeds rtol=atol=1e-3")
                err = max(err, float(e.max()))
            worst[f"{backend}/{remat}"] = err
    log(f"[{label}] card vs CPU, {cfg.arch_id} {cfg.period[0].ffn.kind} reduced fp32 "
        f"({lm.param_count(cpu)} params): loss, metrics and every gradient within "
        f"1e-3 under {', '.join('train/' + b for b in backends)}, remat none and "
        f"full; max |err| "
        f"{', '.join(f'{k} {v:.2e}' for k, v in worst.items())}")


def decisive_fractions(api, fff, lm, cfg, params, batch) -> list:
    """Per layer, the fraction of decisive node decisions (entropy < 0.10)
    of one training forward on ``batch``."""
    fracs, apply_fn = [], api.apply

    def recording_apply(p, c, x, spec=api.ExecutionSpec()):
        y, out = apply_fn(p, c, x, spec)
        fracs.append(float(fff.decisive_fraction(out.node_probs)))
        return y, out

    api.apply = recording_apply
    try:
        with torch.no_grad():
            lm.loss_fn(params, cfg, batch)
    finally:
        api.apply = apply_fn
    return fracs


def train_full_width(common, api, fff, lm, FFF_CONFIG) -> None:
    """internlm2-20b FFF, full width, bf16, remat "full", TRAIN_LAYERS layers:
    TRAIN_STEPS steps of launch.train.train from seeded weights."""
    from torch.profiler import ProfilerActivity, profile, schedule
    from repro_torch import utils
    from repro_torch.data import tokens as tokens_lib
    from repro_torch.launch import train as train_mod
    cfg = dataclasses.replace(FFF_CONFIG, n_layers=TRAIN_LAYERS)
    params = lm.init(cfg, seed=0, device="cuda")
    probe = tokens_lib.MarkovTokenSource(cfg.vocab_size, seed=0).batch(
        TRAIN_B, TRAIN_S, seed=0)
    before = decisive_fractions(api, fff, lm, cfg, params, probe)
    bad_grads = []
    # the profiler's steps end at each inspect call: its active step runs
    # from the gradient of step W to that of step W + 1
    W = TRAIN_STEPS - 4
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   schedule=schedule(wait=W, warmup=1, active=1, repeat=1))
    marks = {}

    def inspect(i, grads, metrics):
        if i == 0:
            for k, g in enumerate(utils.tree_leaves(grads)):
                if g is None or not bool(torch.isfinite(g).all()) or not bool(g.any()):
                    bad_grads.append(k)
        if i in (W, W + 1):
            torch.cuda.synchronize()
            marks[i] = time.perf_counter()
        prof.step()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    common.reset_launch_counts()
    prof.start()
    try:
        res = train_mod.train(cfg, steps=TRAIN_STEPS, batch=TRAIN_B, seq=TRAIN_S,
                              lr=TRAIN_LR, seed=0, device="cuda", params=params,
                              inspect=inspect, log=lambda line: log(f"[train]   {line}"))
    finally:
        prof.stop()
    counts = common.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    del params
    if any(counts.values()):
        raise AssertionError(f"[train] kernels launched during training: {counts}")
    if bad_grads:
        raise AssertionError(f"[train] step 0: {len(bad_grads)} parameters with a "
                             f"non-finite or all-zero gradient (leaves {bad_grads})")
    losses = res.losses
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"[train] non-finite loss: {losses}")
    tail = sum(losses[-5:]) / 5
    if not tail < losses[0] - TRAIN_MARGIN:
        raise AssertionError(f"[train] loss fell from {losses[0]:.4f} to a last-5 "
                             f"mean of {tail:.4f}, not by {TRAIN_MARGIN}")
    after = decisive_fractions(api, fff, lm, cfg, res.params, probe)
    ms = sorted(res.step_ms)
    last = res.metrics[-1]
    log(f"[train] {cfg.arch_id} FFF full width, {cfg.n_layers} of 48 layers, "
        f"{lm.param_count(res.params) / 1e9:.2f}B params {cfg.param_dtype}, remat "
        f"{cfg.remat}, batch {TRAIN_B} x seq {TRAIN_S}, {TRAIN_STEPS} steps, lr "
        f"{TRAIN_LR}: loss {losses[0]:.4f} -> last-5 mean {tail:.4f} (drop "
        f"{losses[0] - tail:.4f}, margin {TRAIN_MARGIN}); ce {res.metrics[0]['ce']:.4f}"
        f" -> {last['ce']:.4f}; hardening {res.metrics[0]['hardening']:.4f} -> "
        f"{last['hardening']:.4f}; balance {last['balance']:.4f}; step time p50 "
        f"{ms[len(ms) // 2]:.2f} ms (min {ms[0]:.2f}, max {ms[-1]:.2f}; CUDA "
        f"events, loss + gradient + update); peak memory {peak / 2**30:.2f} GiB "
        f"(max_memory_allocated); decisive fraction per layer "
        f"{[round(f, 4) for f in before]} -> {[round(f, 4) for f in after]}; "
        f"every gradient finite and nonzero at step 0; kernel launches {counts}")
    profile_report(f"train step (update {W}, loss and gradient {W + 1})", prof,
                   marks[W + 1] - marks[W], 1)
    del res
    torch.cuda.empty_cache()


def generate_batch_with_margins(api, fff, lm, cfg, params, prompt, steps, max_len,
                                **overrides):
    """lm.generate on the whole batch (under ``api.overrides(**overrides)``
    when given), and per row the smallest deciding margin it met: a node
    logit on a routed path, or the gap between the two largest logits."""
    B = prompt.shape[0]
    row_min = torch.full((B,), math.inf, device="cuda")
    apply_fn, head_fn = api.apply, lm._head

    def recording_apply(p, c, x, spec=api.ExecutionSpec()):
        xf = x.reshape(B, -1, x.shape[-1]).to(c.accum_dtype)
        logits = fff._node_logits_all(p, c, xf.reshape(-1, x.shape[-1]))[:, 0]
        idx = torch.zeros(logits.shape[0], dtype=torch.long, device=x.device)
        off = 0
        for m in range(c.depth):
            cur = logits[:, off:off + 2 ** m].gather(1, idx[:, None])[:, 0]
            row_min.copy_(torch.minimum(row_min, cur.abs().reshape(B, -1).amin(1)))
            idx = 2 * idx + (cur >= 0).long()
            off += 2 ** m
        return apply_fn(p, c, x, spec)

    def recording_head(p, c, x):
        out = head_fn(p, c, x)
        top2 = out.topk(2, dim=-1).values
        gap = (top2[..., 0] - top2[..., 1]).reshape(B, -1).amin(1)
        row_min.copy_(torch.minimum(row_min, gap))
        return out

    api.apply, lm._head = recording_apply, recording_head
    try:
        with torch.inference_mode(), (api.overrides(**overrides) if overrides
                                      else contextlib.nullcontext()):
            out = lm.generate(params, cfg, prompt, steps, max_len)
    finally:
        api.apply, lm._head = apply_fn, head_fn
    return out[:, prompt.shape[1]:], row_min.tolist()


def train_then_serve(common, api, fff, lm, FFF_CONFIG) -> None:
    """float32, full width, TRAIN_SERVE_LAYERS layers trained
    TRAIN_SERVE_STEPS steps, then served through the kernel backends and the
    reference backend: greedy tokens equal off near-ties."""
    from repro_torch.launch import train as train_mod
    cfg = dataclasses.replace(FFF_CONFIG, n_layers=TRAIN_SERVE_LAYERS,
                              param_dtype=torch.float32, accum_dtype=torch.float32)
    res = train_mod.train(cfg, steps=TRAIN_SERVE_STEPS, batch=TRAIN_B, seq=TRAIN_S,
                          lr=TRAIN_LR, seed=1, device="cuda",
                          log=lambda line: log(f"[train]   {line}"))
    params = res.params
    gen = torch.Generator(device="cuda").manual_seed(4)
    prompt = torch.randint(0, cfg.vocab_size, (PARITY_B, PARITY_S), generator=gen,
                           device="cuda", dtype=torch.int32)
    max_len = PARITY_S + PARITY_STEPS + 1
    common.reset_launch_counts()
    kern, _ = generate_batch_with_margins(api, fff, lm, cfg, params, prompt,
                                          PARITY_STEPS, max_len)
    counts = common.launch_counts()
    used = ("tree_router", "grouped_matmul", "grouped_matmul_dual", "fused_forest_decode")
    if not all(counts[k] > 0 for k in used):
        raise AssertionError(f"[train] serving the trained model: kernel launches {counts}")
    ref, margin = generate_batch_with_margins(api, fff, lm, cfg, params, prompt,
                                              PARITY_STEPS, max_len,
                                              backend="reference", mode="infer")
    ties = 0
    for b in range(PARITY_B):
        if torch.equal(kern[b], ref[b]):
            continue
        if margin[b] >= NEAR_TIE:
            raise AssertionError(
                f"[train] trained model, row {b}: kernel tokens {kern[b].tolist()} != "
                f"reference {ref[b].tolist()} with no deciding margin under "
                f"{NEAR_TIE} (smallest {margin[b]:.3e})")
        ties += 1
    log(f"[train] {cfg.n_layers} layers fp32 trained {TRAIN_SERVE_STEPS} steps (loss "
        f"{res.losses[0]:.4f} -> {res.losses[-1]:.4f}), then batch {PARITY_B} x "
        f"prompt {PARITY_S}, {PARITY_STEPS} greedy tokens: kernel backends equal the "
        f"reference backend ({ties} near-tie rows); kernel launches {counts}; "
        f"smallest deciding margin per row {[f'{m:.3e}' for m in margin]}")
    del params, res
    torch.cuda.empty_cache()


def phase_train(common, api, fff, lm, FFF_CONFIG) -> None:
    train_card_vs_cpu(api, lm, FFF_CONFIG)
    train_full_width(common, api, fff, lm, FFF_CONFIG)
    train_then_serve(common, api, fff, lm, FFF_CONFIG)


# ---------------------------------------------------------------------------
# checkpoint/restart training, and the dense FF baseline
# ---------------------------------------------------------------------------

def trees_equal(a, b, utils) -> bool:
    """Every leaf torch.equal (tensors) or equal (ints), in one structure."""
    la, lb = utils.tree_leaves(a), utils.tree_leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x, y) if isinstance(y, torch.Tensor) else x == y
        for x, y in zip(la, lb))


def dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def rate(nbytes: int, seconds: float) -> str:
    return f"{seconds:.2f} s at {nbytes / seconds / 1e9:.2f} GB/s"


def ckpt_supervised(common, cfg, root: Path):
    """(b) CKPT_STEPS uninterrupted steps; (c) the same steps under the
    supervisor (async manager, a checkpoint every CKPT_EVERY, keep
    CKPT_KEEP) with a failure injected at step CKPT_FAIL_AT: the same
    losses and final parameters, bit for bit.  Returns (c)'s result."""
    from repro_torch import checkpoint, utils
    from repro_torch.launch import train as train_mod
    kw = dict(steps=CKPT_STEPS, batch=TRAIN_B, seq=TRAIN_S, lr=TRAIN_LR, seed=0,
              device="cuda")
    common.reset_launch_counts()
    plain = train_mod.train(cfg, log=lambda line: log(f"[ckpt]   (b) {line}"), **kw)
    tripped = []

    def fail_once(i):
        if i == CKPT_FAIL_AT and not tripped:
            tripped.append(i)
            log(f"[ckpt]   (c) injected failure at step {i}")
            return True
        return False

    sup = train_mod.train(cfg, ckpt_dir=str(root / "c"), ckpt_every=CKPT_EVERY,
                          keep=CKPT_KEEP, failure_hook=fail_once,
                          log=lambda line: log(f"[ckpt]   (c) {line}"), **kw)
    counts = common.launch_counts()
    steps = checkpoint.CheckpointManager(str(root / "c")).steps()
    if (sup.end, sup.restarts, steps) != (CKPT_STEPS, 1, [CKPT_EVERY, CKPT_STEPS]):
        raise AssertionError(f"[ckpt] (c) ended at step {sup.end} with "
                             f"{sup.restarts} restarts, checkpoints {steps}")
    if any(counts.values()):
        raise AssertionError(f"[ckpt] kernels launched during training: {counts}")
    if sup.losses != plain.losses:
        raise AssertionError(f"[ckpt] (c) losses {sup.losses} != (b)'s {plain.losses}")
    if not trees_equal(sup.params, plain.params, utils):
        raise AssertionError("[ckpt] (c) final parameters differ from (b)'s")
    t = sup.ckpt_timings
    nbytes = dir_bytes(root / "c" / f"step_{CKPT_STEPS}")
    log(f"[ckpt] (b) {CKPT_STEPS} uninterrupted steps, losses "
        f"{[round(x, 4) for x in plain.losses]}; (c) under the supervisor, "
        f"checkpoints every {CKPT_EVERY} (async, keep {CKPT_KEEP}), failure at "
        f"step {CKPT_FAIL_AT}: ended at step {sup.end}, restarts {sup.restarts}, "
        f"checkpoints {steps}; losses and final parameters bit-identical to (b)'s; "
        f"kernel launches {counts}")
    log(f"[ckpt] checkpoint bytes {nbytes} ({nbytes / 1e9:.2f} GB) at step {CKPT_STEPS}")
    log(f"[ckpt] snapshot on the caller's thread {t['snapshot_s'] * 1e3:.1f} ms "
        f"({nbytes / t['snapshot_s'] / 1e9:.2f} GB/s; step {CKPT_STEPS}, device to host)")
    log(f"[ckpt] background write {rate(nbytes, t['write_s'])} (serialize + commit, "
        f"step {CKPT_STEPS}); restore {rate(nbytes, t['restore_s'])} (step "
        f"{CKPT_EVERY}, after the failure)")
    return sup


def ckpt_round_trip(trained, root: Path) -> None:
    """(a) a blocking save_tree and restore_tree of (c)'s final {params,
    opt}: every leaf bit-identical, on the card in its dtype, the AdamW
    step intact.  It takes the room of (c)'s step-3 checkpoint."""
    from repro_torch import checkpoint, utils
    shutil.rmtree(root / "c" / f"step_{CKPT_EVERY}")
    state = {"params": trained.params, "opt": trained.opt_state}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpoint.save_tree(str(root / "a"), state, step=CKPT_STEPS)
    save_s = time.perf_counter() - t0
    nbytes = dir_bytes(root / "a")
    t0 = time.perf_counter()
    got, step, _ = checkpoint.restore_tree(str(root / "a"), state)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    placed = all((g.device, g.dtype) == (w.device, w.dtype)
                 for g, w in zip(utils.tree_leaves(got), utils.tree_leaves(state))
                 if isinstance(w, torch.Tensor))
    adam = got["opt"].step
    if not (placed and trees_equal(got, state, utils)) or step != CKPT_STEPS or \
            type(adam) is not int or adam != CKPT_STEPS:
        raise AssertionError(f"[ckpt] (a) round trip: placed {placed}, step {step}, "
                             f"AdamW step {adam!r}")
    log(f"[ckpt] (a) blocking save_tree + restore_tree of (c)'s final {{params, opt}}: "
        f"{len(utils.tree_leaves(state))} leaves bit-identical (torch.equal), on cuda "
        f"in their dtypes, AdamW step {adam} (int); {nbytes} bytes; save_tree "
        f"{rate(nbytes, save_s)}, restore_tree {rate(nbytes, restore_s)} (host clock)")
    del got
    shutil.rmtree(root / "a")


def ckpt_serve_restored(common, lm, serve_mod, cfg, root: Path, trained) -> None:
    """(d) the newest checkpoint restored into a fresh model on the card,
    served through the kernels: the in-memory model's tokens."""
    from repro_torch import checkpoint
    fresh = {"params": lm.init(cfg, seed=1, device="cuda")}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got, step, _ = checkpoint.restore_tree(str(root / "c" / f"step_{CKPT_STEPS}"), fresh)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    del fresh
    runs = {}
    for name, params in (("restored", got["params"]), ("in memory", trained)):
        common.reset_launch_counts()
        res = serve_mod.serve(cfg, batch=PREFILL_B, prompt_len=PREFILL_S, gen=CKPT_GEN,
                              device="cuda", params=params)
        runs[name] = (res.tokens, common.launch_counts())
    (toks, counts), (want, _) = runs["restored"], runs["in memory"]
    used = ("tree_router", "grouped_matmul", "grouped_matmul_dual", "fused_forest_decode")
    if not all(counts[k] > 0 for k in used):
        raise AssertionError(f"[ckpt] (d) serving the restored model: launches {counts}")
    if step != CKPT_STEPS or not torch.equal(toks, want):
        raise AssertionError(f"[ckpt] (d) restored step {step}: tokens "
                             f"{toks.tolist()} != in-memory {want.tolist()}")
    log(f"[ckpt] (d) step {step} restored into a fresh model on the card "
        f"({restore_s:.2f} s, params only) and served, batch {PREFILL_B} x prompt "
        f"{PREFILL_S}, {CKPT_GEN} greedy tokens: the in-memory model's tokens; "
        f"kernel launches {counts}")


#: the training command line, held once it has printed the line that starts
#: with argv[1] (its next step never starts) until it is killed
HELD_CLI = """
import sys, threading
from repro_torch.launch import train
hold = sys.argv[1]

class Held:
    def __init__(self, out):
        self.out, self.line = out, ""
    def write(self, s):
        self.out.write(s)
        self.out.flush()
        *done, self.line = (self.line + s).split("\\n")
        if any(line.startswith(hold) for line in done):
            threading.Event().wait()
        return len(s)
    def flush(self):
        self.out.flush()

sys.stdout = Held(sys.stdout)
train.main(sys.argv[2:])
"""


def same_checkpoint(a: Path, b: Path) -> bool:
    """The same manifest and the same arrays, bit for bit."""
    import numpy as np
    ma, mb = (json.loads((d / "manifest.json").read_text()) for d in (a, b))
    if ma != mb:
        return False
    for shard in ma["shards"]:
        with np.load(a / shard) as za, np.load(b / shard) as zb:
            if za.files != zb.files or not all(
                    za[k].dtype == zb[k].dtype and np.array_equal(za[k], zb[k])
                    for k in za.files):
                return False
    return True


def ckpt_cli_resume() -> None:
    """The command line on the card, each run in its own process:
    ``python -m repro_torch.launch.train --reduced --steps 6 --ckpt-every 3
    --ckpt-dir D`` killed with SIGKILL after step 4 (held once it printed
    its step-4 line, killed when the step-3 checkpoint has committed), then
    run again: it resumes at step 3, and its step-5 line and step-6
    checkpoint are an uninterrupted run's.  Then the Prefetcher's card path
    against shard_batch."""
    import os
    import signal
    import tempfile
    from repro_torch.data import pipeline
    from repro_torch.data import tokens as tokens_lib
    d = Path(tempfile.mkdtemp(prefix="ckpt_cli_"))
    env = dict(os.environ, PYTHONPATH=str(SRC))
    args = ["--reduced", "--steps", "6", "--batch", "2", "--seq", "16", "--ckpt-every", "3"]
    cli = [sys.executable, "-m", "repro_torch.launch.train", *args]
    no_ms = lambda line: line.rsplit(None, 1)[0]

    def run(ckpt_dir):
        out = subprocess.run(cli + ["--ckpt-dir", str(ckpt_dir)], env=env, cwd=ROOT,
                             capture_output=True, text=True, timeout=600)
        if out.returncode:
            raise AssertionError(f"[ckpt] CLI exit {out.returncode}: {out.stderr[-2000:]}")
        return out.stdout.strip().splitlines()

    try:
        full = run(d / "full")
        child = subprocess.Popen([sys.executable, "-c", HELD_CLI, "step    4 ", *args,
                                  "--ckpt-dir", str(d / "killed")], env=env, cwd=ROOT,
                                 stdout=subprocess.PIPE, text=True)
        try:
            seen = ""
            for line in child.stdout:
                if line.startswith("step    4 "):
                    seen = line
                    break
            deadline = time.monotonic() + 300
            while seen and not (d / "killed" / "step_3" / "manifest.json").exists():
                if child.poll() is not None or time.monotonic() > deadline:
                    break
                time.sleep(0.01)
            child.send_signal(signal.SIGKILL)
            rc = child.wait(timeout=60)
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()
            child.stdout.close()
        left = sorted(p.name for p in (d / "killed").iterdir())
        if not seen or rc != -signal.SIGKILL or left != ["step_3"]:
            raise AssertionError(f"[ckpt] CLI kill: step-4 line {seen!r}, exit {rc}, "
                                 f"directory {left}")
        res = run(d / "killed")
        if (res[1] != f"resuming from step 3 ({d / 'killed'})"
                or [int(x.split()[1]) for x in res[2:5]] != [3, 4, 5]
                or no_ms(res[4]) != no_ms(full[6])
                or res[-1] != "done at step 6 (restarts=0)"
                or not same_checkpoint(d / "killed" / "step_6", d / "full" / "step_6")):
            raise AssertionError(f"[ckpt] CLI resumed: {res}; uninterrupted: {full}")
        log(f"[ckpt] CLI on the card (--reduced --steps 6 --ckpt-every 3, each run "
            f"its own process): SIGKILL after step 4 (exit {rc}), run again: "
            f"resumed at step 3; step 5 {no_ms(res[4])!r}, the uninterrupted "
            f"run's; step-6 checkpoints bit-identical")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    src = tokens_lib.MarkovTokenSource(1000, seed=0)
    pf = pipeline.Prefetcher(lambda i: src.batch(TRAIN_B, TRAIN_S, seed=i), device="cuda")
    try:
        for i in range(3):
            got, want = next(pf), pipeline.shard_batch(src.batch(TRAIN_B, TRAIN_S, seed=i))
            if got.keys() != want.keys() or not all(
                    got[k].is_cuda and torch.equal(got[k], want[k]) for k in want):
                raise AssertionError(f"[ckpt] Prefetcher batch {i} != shard_batch's")
    finally:
        pf.close()
    log("[ckpt] Prefetcher on the card (pinned, side-stream copies): 3 batches "
        "equal shard_batch's")


def phase_ckpt(common, lm, serve_mod, FFF_CONFIG) -> None:
    import tempfile
    cfg = dataclasses.replace(FFF_CONFIG, n_layers=CKPT_LAYERS)
    root = Path(tempfile.mkdtemp(prefix="ckpt_smoke_"))
    try:
        free = shutil.disk_usage(root).free
        params = lm.init(cfg, seed=0, device="cuda")
        n = lm.param_count(params)
        del params
        # bf16 params (2 bytes) and float32 moments (8) a parameter, CKPT_KEEP kept
        need = CKPT_KEEP * n * (torch.finfo(cfg.param_dtype).bits // 8 + 8)
        log(f"[ckpt] {cfg.arch_id} FFF full width, {cfg.n_layers} of 48 layers, "
            f"{n / 1e9:.2f}B params {cfg.param_dtype}, remat {cfg.remat}; free disk "
            f"{free} bytes ({free / 1e9:.2f} GB) at {root} before the phase "
            f"(shutil.disk_usage); needs {need / 1e9:.2f} GB")
        if free < need:
            raise AssertionError(f"[ckpt] the disk holds {free / 1e9:.2f} GB free at "
                                 f"{root}; the phase needs {need / 1e9:.2f} GB")
        sup = ckpt_supervised(common, cfg, root)
        torch.cuda.empty_cache()
        ckpt_round_trip(sup, root)
        torch.cuda.empty_cache()
        ckpt_serve_restored(common, lm, serve_mod, cfg, root, sup.params)
        del sup
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    ckpt_cli_resume()


def ffn_site_times(lm, mlp, cfg, params) -> dict:
    """One warm prefill (PREFILL_B x PREFILL_S) and one warm decode step of
    ``cfg`` under torch.profiler, every FFN site inside a
    record_function("ffn_site") range.  Per phase: (device busy ms, FFN
    sites' device ms: the kernels that start inside the ranges' device-side
    spans).  Raises unless every layer's site ran inside its range."""
    from torch.profiler import ProfilerActivity, profile, record_function
    forward, sites = mlp.forward, []

    def timed(*a, **kw):
        sites.append(1)
        with record_function("ffn_site"):
            return forward(*a, **kw)

    prompt = torch.randint(0, cfg.vocab_size, (PREFILL_B, PREFILL_S), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(4),
                           dtype=torch.int32)

    def prefill():
        caches = lm.init_caches(cfg, PREFILL_B, PREFILL_S + 2, device="cuda")
        return lm.prefill(params, cfg, {"tokens": prompt}, caches)

    on_card = lambda e: str(e.device_type).endswith("CUDA")
    out = {}
    mlp.forward = timed
    try:
        with torch.inference_mode():
            logits, caches = prefill()                       # warm both
            tok = logits.argmax(-1)[:, None].to(torch.int32)
            lm.decode_step(params, cfg, tok, caches, PREFILL_S)
            _, caches = prefill()
            torch.cuda.synchronize()
            for phase, fn in (("prefill", prefill), ("decode", lambda: lm.decode_step(
                    params, cfg, tok, caches, PREFILL_S))):
                sites.clear()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    fn()
                    torch.cuda.synchronize()
                evs = prof.events()
                ranges = [(e.time_range.start, e.time_range.end) for e in evs
                          if on_card(e) and e.name == "ffn_site"]
                work = [(e.time_range.start, e.time_range.end) for e in evs
                        if on_card(e) and e.name != "ffn_site"]
                if not len(sites) == len(ranges) == cfg.n_layers:
                    raise AssertionError(f"[dense] {phase}: {len(sites)} FFN sites ran, "
                                         f"{len(ranges)} device-side ranges, "
                                         f"{cfg.n_layers} layers")
                inside = sum(t1 - t0 for t0, t1 in work
                             if any(r0 <= t0 < r1 for r0, r1 in ranges))
                out[phase] = (sum(t1 - t0 for t0, t1 in work) / 1e3, inside / 1e3)
    finally:
        mlp.forward = forward
    return out


def phase_dense(common, api, lm, serve_mod, FFF_CONFIG, CONFIG) -> None:
    """internlm2-20b native (dense SwiGLU, d_ff 16384) at full width, bf16,
    SERVE_LAYERS layers: the serve phase's fixed-batch loop (no kernel), then
    the FFN sites' device time against FFF's in a warm prefill and decode
    step; then the dense LM's loss and gradients on the card against the CPU."""
    from repro_torch.nn import mlp
    dense_cfg = dataclasses.replace(CONFIG, n_layers=SERVE_LAYERS)
    fff_cfg = dataclasses.replace(FFF_CONFIG, n_layers=SERVE_LAYERS)
    params = lm.init(dense_cfg, seed=0, device="cuda")
    spec = dense_cfg.period[0].ffn
    log(f"[dense] {dense_cfg.arch_id} native ({spec.kind} {spec.activation}, d_ff "
        f"{spec.d_ff}) full width, {dense_cfg.n_layers} of 48 layers, "
        f"{lm.param_count(params) / 1e9:.2f}B params {dense_cfg.param_dtype}")
    common.reset_launch_counts()
    res = serve_mod.serve(dense_cfg, batch=PREFILL_B, prompt_len=PREFILL_S, gen=GEN,
                          device="cuda", params=params)
    counts = common.launch_counts()
    toks = res.tokens
    if any(counts.values()) or tuple(toks.shape) != (PREFILL_B, GEN + 1) or not bool(
            ((toks >= 0) & (toks < dense_cfg.vocab_size)).all()):
        raise AssertionError(f"[dense] serve: launches {counts}, tokens {tuple(toks.shape)}")
    log(f"[dense] serve batch {PREFILL_B} x prompt {PREFILL_S}, {GEN} decode steps: "
        f"prefill {res.prefill_s * 1e3:.2f} ms (first call); decode p50 "
        f"{res.steady.p50_ms:.2f} ms p90 {res.steady.p90_ms:.2f} ms; "
        f"{res.tokens_per_s:.1f} tok/s; kernel launches {counts} (none: dense)")
    times = {"dense": ffn_site_times(lm, mlp, dense_cfg, params)}
    del params, res
    torch.cuda.empty_cache()
    params = lm.init(fff_cfg, seed=0, device="cuda")
    times["fff"] = ffn_site_times(lm, mlp, fff_cfg, params)
    del params
    torch.cuda.empty_cache()
    for phase, what in (("prefill", f"{PREFILL_B}x{PREFILL_S} tokens"),
                        ("decode", f"one step, batch {PREFILL_B}")):
        d, f = times["dense"][phase], times["fff"][phase]
        for name, (busy, inside) in (("dense FF", d), ("FFF", f)):
            log(f"[dense] warm {phase} ({what}), {name}: FFN sites {inside:.3f} ms "
                f"device time (kernels inside the {SERVE_LAYERS} sites' device-side "
                f"spans); device busy {busy:.3f} ms")
        log(f"[dense] warm {phase}: FFN sites' device time dense/FFF "
            f"{d[1] / max(f[1], 1e-9):.2f}x")
    train_card_vs_cpu(api, lm, CONFIG, backends=("reference",), label="dense")


def main() -> int:
    name, smi = phase_device()
    sys.path.insert(0, str(SRC))
    from repro_torch.configs.internlm2_20b import CONFIG, FFF_CONFIG
    from repro_torch.core import api, fff
    from repro_torch.kernels import common
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import lm

    phase_build(common)
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.inference_mode():
        rows = phase_kernels(gen)
        rows.update(phase_gathered(gen))
        phase_ragged(gen)
        phase_router(gen)
    cfg = dataclasses.replace(FFF_CONFIG, n_layers=SERVE_LAYERS)
    t0 = time.perf_counter()
    params = lm.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"[serve] {cfg.arch_id} FFF full width, {cfg.n_layers} of 48 layers, "
        f"{lm.param_count(params) / 1e9:.2f}B params {cfg.param_dtype}, "
        f"init {time.perf_counter() - t0:.1f}s")
    phase_serve(common, api, serve_mod, cfg, params)
    counts = phase_engine(common, api, serve_mod, cfg, params)
    phase_parity(api, fff, lm, FFF_CONFIG)
    phase_engine_parity(api, fff, lm, serve_mod, FFF_CONFIG)
    with torch.inference_mode():
        grouped_capacities(rows)
    phase_grouped_serving(common, api, serve_mod, cfg, params)
    del params
    torch.cuda.empty_cache()
    phase_grouped_parity(api, fff, lm, serve_mod, FFF_CONFIG)
    phase_train(common, api, fff, lm, FFF_CONFIG)
    phase_ckpt(common, lm, serve_mod, FFF_CONFIG)
    phase_dense(common, api, lm, serve_mod, FFF_CONFIG, CONFIG)

    table = []
    for kname, k in common.KERNELS.items():
        r = rows[(kname, torch.bfloat16)]
        table.append({"name": kname, "route": "cuda",
                      "source": f"src/repro_torch/kernels/csrc/{k.source}",
                      "replaces": k.replaces, "launches": counts[kname],
                      "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                      "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                      "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
