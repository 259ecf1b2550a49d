"""Smoke run of the PyTorch/CUDA port on one GPU: the quickest proof that
the port still builds, agrees with its plain versions and serves.

    python3 chip_smoke.py

Phases (any failure raises, and the exit code is non-zero):

1. device   — a CUDA card must be present; prints its name and power limit.
2. build    — nvcc builds every kernel in src/repro_torch/kernels/csrc/.
3. kernels  — each kernel against its plain PyTorch version at the
              internlm2-20b FFF main-path shapes (D = 6144, depth 4, 16
              leaves of width 1024; decode batch 8; prefill 8 x 128 tokens),
              in float32 (TF32 off; tolerance 1e-4) and bfloat16 (5e-2).
              Leaf indices must match exactly except on near-ties (deciding
              logit |l| < 1e-3 in float32), which are counted; outputs are
              compared on tokens whose indices agree.  Times each kernel,
              its plain version and, where one PyTorch call computes the
              same function, that call (library_ms), with CUDA events.
   ragged   — the same kernels at the CPU tests' small unaligned sizes,
              which exercise their masked edge paths.
4. serve    — internlm2-20b FFF at full width (bf16) with 8 of its 48
              layers, random weights from a seeded CUDA generator: batch 8,
              prompt 128, 16 greedy decode steps through
              repro_torch.launch.serve.serve; asserts each kernel's launch
              count on that run and that no site fell back to the reference,
              and reports how many prefill tokens overflowed a leaf's
              capacity (and took the dense repair).
   profile  — a warm prefill and warm decode steps of that model under
              torch.profiler: device busy share and the top kernels.
5. parity   — the same width with 2 layers in float32: 8 greedy tokens from
              the kernel backends must equal those of the reference backend.

Prints the kernel table as one JSON line, the card's name and power limit,
and, last, {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import dataclasses
import json
import math
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
DECODE_B, PREFILL_B, PREFILL_S = 8, 8, 128
SERVE_LAYERS, GEN, PARITY_LAYERS, PARITY_B, PARITY_S, PARITY_STEPS = 8, 16, 2, 4, 32, 8


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


def phase_kernels(gen) -> dict:
    from repro_torch.kernels.fused_decode import kernel as fdk, ref as fdr
    from repro_torch.kernels.leaf_gemm import kernel as gk, ref as gr
    from repro_torch.kernels.tree_router import kernel as trk, ref as trr

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
        got = trk.tree_router(x, nw, nb, depth=DEPTH)
        want, margin = margins(x, nw, nb, DEPTH)
        _, ties, err = compare_idx("tree_router", got, want, margin)
        ms = time_ms(lambda: trk.tree_router(x, nw, nb, depth=DEPTH))
        plain = time_ms(lambda: trr.tree_router_ref(x, nw, nb, depth=DEPTH))
        b, by = bound(B * D * sz + N_NODES * D * sz + N_NODES * sz + B * 4,
                      2 * B * N_NODES * D, dtype)
        rows[("tree_router", dtype)] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                            bound_ms=b, bound_by=by, library_ms=None,
                                            near_ties=ties)

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
        ms = time_ms(lambda: gk.grouped_matmul_dual(xg, wg, wu, gs))
        plain = time_ms(lambda: gr.grouped_matmul_dual_ref(xg, wg, wu, gs))
        b, by = bound(live * 2 * D * L_W * sz + tokens * D * sz + E * C * L_W * sz,
                      2 * 2 * tokens * D * L_W, dtype)
        rows[("grouped_matmul_dual", dtype)] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
            library_ms=None)

        y = gk.grouped_matmul(h, wd, gs)
        err = compare("grouped_matmul", y, gr.grouped_matmul_ref(h, wd, gs), dtype)
        ms = time_ms(lambda: gk.grouped_matmul(h, wd, gs))
        plain = time_ms(lambda: gr.grouped_matmul_ref(h, wd, gs))
        lib = time_ms(lambda: torch.bmm(h, wd))
        b, by = bound(live * L_W * O * sz + tokens * L_W * sz + E * C * O * sz,
                      2 * tokens * L_W * O, dtype)
        rows[("grouped_matmul", dtype)] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
            library_ms=lib)
        del xg, h, y

        # -- fused forest decode: batch 8, one tree of 16 SwiGLU leaves
        xd = randn(DECODE_B, D, dtype=dtype)
        nwf, nbf = nw[None], nb[None]
        leaves = (wg[None], wu[None], wd[None])
        y, idx = fdk.fused_forest_decode(xd, nwf, nbf, leaves, depth=DEPTH, act="swiglu")
        y_ref, idx_ref = fdr.fused_decode_ref(xd, nwf, nbf, leaves, depth=DEPTH, act="swiglu")
        _, margin = margins(xd, nw, nb, DEPTH)
        agree, ties, _ = compare_idx("fused_forest_decode", idx[:, 0], idx_ref[:, 0], margin)
        err = compare("fused_forest_decode", y, y_ref, dtype, rows=agree)
        ms = time_ms(lambda: fdk.fused_forest_decode(xd, nwf, nbf, leaves,
                                                     depth=DEPTH, act="swiglu"))
        plain = time_ms(lambda: fdr.fused_decode_ref(xd, nwf, nbf, leaves,
                                                     depth=DEPTH, act="swiglu"))
        distinct = int(torch.unique(idx).numel())
        b, by = bound(distinct * 3 * D * L_W * sz + N_NODES * D * sz
                      + DECODE_B * (D + O) * sz,
                      2 * DECODE_B * (N_NODES * D + 3 * D * L_W), dtype)
        rows[("fused_forest_decode", dtype)] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
            library_ms=None, near_ties=ties, distinct_leaves=distinct)
        del wg, wu, wd, leaves
        torch.cuda.empty_cache()
    for (name, dtype), r in rows.items():
        log(f"[kernels] {name:20s} {str(dtype):15s} max|err| {r['max_abs_err']:.3e}"
            f"  kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})  library "
            + (f"{r['library_ms']:.4f} ms" if r["library_ms"] is not None else "n/a")
            + (f"  near-ties {r['near_ties']}" if "near_ties" in r else "")
            + (f"  distinct leaves {r['distinct_leaves']}" if "distinct_leaves" in r else ""))
    return rows


def phase_ragged(gen) -> None:
    """The kernels' masked and element-wise paths, at the CPU tests' small
    sizes (which the full-width shapes never reach): odd batches, D = 20
    and 24, leaf widths 4 and 8, a two-tree forest, the master leaf, every
    activation."""
    from repro_torch.kernels.fused_decode import kernel as fdk, ref as fdr
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
            y, idx = fdk.fused_forest_decode(x, nw, nb, leaves, depth=depth, act=act, master_w=mst)
            y_ref, idx_ref = fdr.fused_decode_ref(x, nw, nb, leaves, depth=depth, act=act, master_w=mst)
            agree = torch.ones(B, dtype=torch.bool, device=dev)
            for t in range(T):
                _, margin = margins(x, nw[t], nb[t], depth)
                a, _, _ = compare_idx("fused_forest_decode (ragged)", idx[:, t], idx_ref[:, t], margin)
                agree &= a
            compare("fused_forest_decode (ragged)", y, y_ref, dtype, rows=agree)
            checked += 1
    torch.cuda.synchronize()
    log(f"[ragged] {checked} small kernel cases agree with their plain "
        f"versions (fp32 and bf16)")


def phase_serve(common, api, serve_mod, FFF_CONFIG) -> dict:
    cfg = dataclasses.replace(FFF_CONFIG, n_layers=SERVE_LAYERS)
    from repro_torch.models import lm
    t0 = time.perf_counter()
    params = lm.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"[serve] {cfg.arch_id} FFF full width, {cfg.n_layers} of 48 layers, "
        f"{lm.param_count(params) / 1e9:.2f}B params {cfg.param_dtype}, "
        f"init {time.perf_counter() - t0:.1f}s")
    reference_calls = []
    ref_fn = api.get_backend("infer", "reference")

    def counting_reference(*a):
        reference_calls.append(1)
        return ref_fn(*a)

    from repro_torch.kernels.leaf_gemm import ops as gemm_ops
    scatter = gemm_ops.scatter_to_groups
    layouts = []

    def recording_scatter(x, leaf_idx, num_leaves, capacity):
        # keeps each prefill layer's kept mask (a device tensor: no sync)
        out = scatter(x, leaf_idx, num_leaves, capacity)
        layouts.append(out.kept)
        return out

    api.register_backend("infer", "reference", counting_reference)
    gemm_ops.scatter_to_groups = recording_scatter
    common.reset_launch_counts()
    try:
        res = serve_mod.serve(cfg, batch=PREFILL_B, prompt_len=PREFILL_S,
                              gen=GEN, device="cuda", params=params)
    finally:
        api.register_backend("infer", "reference", ref_fn)
        gemm_ops.scatter_to_groups = scatter
    counts = common.launch_counts()
    want = {"fused_forest_decode": cfg.n_layers * GEN,
            "tree_router": cfg.n_layers, "grouped_matmul_dual": cfg.n_layers,
            "grouped_matmul": cfg.n_layers}
    if counts != want:
        raise AssertionError(f"launch counts {counts} != expected {want}")
    if reference_calls:
        raise AssertionError(f"the reference backend ran {len(reference_calls)}"
                             f" times on the kernel path")
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
    phase_profile(cfg, params, lm, res.tokens)
    del params
    torch.cuda.empty_cache()
    return counts


def phase_profile(cfg, params, lm, tokens) -> None:
    """Where a warm prefill and a warm decode step spend their time:
    host-clock step time, device busy share (kernel time over the window)
    and the kernels with the most device time, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    prompt = torch.randint(0, cfg.vocab_size, (PREFILL_B, PREFILL_S),
                           device="cuda", dtype=torch.int32)
    max_len = PREFILL_S + GEN + 1

    def prefill():
        caches = lm.init_caches(cfg, PREFILL_B, max_len, device="cuda")
        out = lm.prefill(params, cfg, {"tokens": prompt}, caches)
        torch.cuda.synchronize()
        return out

    def report(label, prof, wall_s, steps):
        averages = prof.key_averages()
        events = [e for e in averages
                  if str(e.device_type).endswith("CUDA")]   # kernels, memsets, copies
        dev = lambda e: getattr(e, "self_device_time_total",
                                getattr(e, "self_cuda_time_total", 0))
        busy_us = sum(dev(e) for e in events)
        launches = sum(e.count for e in averages if e.key.startswith(
            ("cudaLaunchKernel", "cuLaunchKernel")))
        top = sorted(events, key=dev, reverse=True)[:8]
        log(f"[profile] {label}: {wall_s / steps * 1e3:.2f} ms per step (host "
            f"clock, profiler on); device busy {busy_us / 1e3 / steps:.2f} ms "
            f"per step = {busy_us / 1e6 / wall_s:.1%} of the window; "
            f"{launches / steps:.0f} kernel launches per step")
        for e in top:
            log(f"[profile]   {dev(e) / 1e3 / steps:8.3f} ms/step  {e.count // steps:4d}"
                f" calls/step  {e.key[:90]}")

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
        report("prefill", prof, wall, 1)
        tok = logits.argmax(-1)[:, None].to(torch.int32)
        steps = 4
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(steps):
                logits, caches = lm.decode_step(params, cfg, tok, caches, PREFILL_S + i)
                tok = logits.argmax(-1)[:, None].to(torch.int32)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        report("decode", prof, wall, steps)


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


def main() -> int:
    name, smi = phase_device()
    sys.path.insert(0, str(SRC))
    from repro_torch.configs.internlm2_20b import FFF_CONFIG
    from repro_torch.core import api, fff
    from repro_torch.kernels import common
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import lm

    phase_build(common)
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.inference_mode():
        rows = phase_kernels(gen)
        phase_ragged(gen)
    counts = phase_serve(common, api, serve_mod, FFF_CONFIG)
    phase_parity(api, fff, lm, FFF_CONFIG)

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
