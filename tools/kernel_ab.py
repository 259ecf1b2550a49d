"""Same-card A/B of the leaf matmul kernels (gathered and grouped), the
fused decode kernel and the router: this checkout's kernels against
another checkout's (for example a parent commit unpacked with ``git
archive``), each side through its own wrappers.

    python3 tools/kernel_ab.py BASELINE_CHECKOUT

Runs four measuring processes one after another, baseline, this, this,
baseline; each builds its checkout's kernels (``common.build_all``) and, on
inputs drawn from fixed seeds, times device time per call (``chip_smoke.
device_ms``: CUDA events around replays of a CUDA graph of 20 calls, so the
wrapper's own launches, such as a scratch fill, count) at the internlm2-20b
shapes in both dtypes:

- ``gathered_matmul_dual`` (32 x 6144 -> 1024) and ``gathered_matmul``
  (1024 -> 6144), E = 16, on three routings of the 32-token verify slab:
  random, every token on one leaf, and 16 tokens on 16 distinct leaves;
- ``fused_forest_decode`` at decode batch 8, one tree of 16 SwiGLU leaves,
  and in bf16 at batch 8 at three other sites of the registry (``DECODE_SITES``:
  jamba-1.5-large's 2 x 8 x 24576 forest, command-r-35b's and
  olmoe-1b-7b's), each on inputs drawn from its own seed;
- ``grouped_matmul_dual`` and ``grouped_matmul`` (down) on 1024 randomly
  routed prefill tokens at the main path's shapes (16 leaves, capacity 128,
  6144 -> 1024 -> 6144) and at olmoe-1b-7b's (8 leaves, capacity 256, 2048
  -> 1024 -> 2048), and ``grouped_matmul`` up (gelu) and down at
  whisper-small's (8 leaves of 384, D 768, capacity 256), in bf16; each
  also as a loop of 20 launches (``chip_smoke.time_ms``), whose excess over
  the device time is the wrapper's host cost while the device is the slower
  of the two, and as the host clock's time to enqueue 200 calls (the host
  cost itself, whichever is slower);
- the same grouped GEMMs in float32 at the main path's shapes, at an
  engine admission slab of 256 tokens in the same groups, at the JAX
  grouped path's capacities 136 and 264 (as many tokens as half the
  capacity a leaf), and the starcoder2 draft's float32 up (gelu) and down
  projections (8 leaves of 16, D 6144, capacity 256);
- ``grouped_matmul`` up (gelu) and down in float32 at the paper ViT's
  evenly routed site for leaf widths 32, 8 and 1 (``chip_smoke.py``'s
  balanced site: 16384 N(0, 1) tokens of width 128 through a fresh FFF,
  seeds 0 and 2, routed by the plain descent, the cuda backend's capacity);
- ``tree_router`` at the same ViT sites (float32, D 128, depths 2, 4 and
  7 for l32, l8 and l1), and on the first 2048 of those tokens at l1 (the
  FFN-site timing's batch); in float32 at the starcoder2 draft's router (D
  6144, depth 3) and in bf16 at internlm2-20b's (D 6144, depth 4), each at
  1024 and 32 tokens; each also as a loop of 20 launches and the host
  clock's enqueue time;
- the ViT's FFN-site speedup at batch 2048 on the cuda backend (the
  paper's quantity: dense FF(128) against hard FFF, host clock, each
  checkout's ``examples/vit_cifar_fff_torch.py::ffn_site_speedup``).

Prints the card's name and power limit, then one line per kernel, dtype and
routing with the four readings.  Needs one CUDA card.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
D, L_W, O, E, VERIFY_B, DECODE_B, DEPTH = 6144, 1024, 6144, 16, 32, 8, 4
# grouped sites: (name, leaves, capacity, d_model, leaf width, dual, dtype,
# randomly routed tokens)
GROUPED_SITES = (("main", 16, 128, 6144, 1024, True, "bfloat16", 1024),
                 ("olmoe", 8, 256, 2048, 1024, True, "bfloat16", 1024),
                 ("whisper", 8, 256, 768, 384, False, "bfloat16", 1024),
                 ("main", 16, 128, 6144, 1024, True, "float32", 1024),
                 ("slab 256", 16, 128, 6144, 1024, True, "float32", 256),
                 ("jax C 136", 16, 136, 6144, 1024, True, "float32", 1088),
                 ("jax C 264", 16, 264, 6144, 1024, True, "float32", 2112),
                 ("draft", 8, 256, 6144, 16, False, "float32", 1024))
# the paper ViT's leaf widths and its site's tokens
VIT_LEAVES, VIT_TOKENS = (32, 8, 1), 16384
# fused decode sites, SwiGLU in bf16: (name, trees, depth, d_model, leaf width)
DECODE_SITES = (("jamba 2x8x24576", 2, 3, 8192, 24576), ("command-r", 1, 4, 8192, 1408),
                ("olmoe", 8, 3, 2048, 1024))


def measure(checkout: Path) -> dict:
    """Device ms per kernel, dtype and routing, through `checkout`'s
    wrappers, on inputs drawn from fixed seeds."""
    import torch
    sys.path[:0] = [str(checkout / "src"), str(ROOT)]
    from chip_smoke import device_ms, time_ms
    from repro_torch.kernels import common
    from repro_torch.kernels.fused_decode import kernel as fdk
    from repro_torch.kernels.fused_fff import kernel as fk
    from repro_torch.kernels.leaf_gemm import kernel as gk

    common.build_all()
    dev = torch.device("cuda")
    out = {}
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            gen = torch.Generator(device=dev).manual_seed(0)

            def randn(*shape, scale=1.0):
                return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

            x = randn(VERIFY_B, D)
            wg, wu = randn(E, D, L_W, scale=D ** -0.5), randn(E, D, L_W, scale=D ** -0.5)
            wd = randn(E, L_W, O, scale=L_W ** -0.5)
            i32 = dict(device=dev, dtype=torch.int32)
            routings = {
                "random": torch.randint(0, E, (VERIFY_B,), generator=gen, **i32),
                "one leaf": torch.full((VERIFY_B,), 5, **i32),
                "distinct": torch.randperm(E, generator=gen, device=dev).to(torch.int32)}
            for name, idx in routings.items():
                xb = x[:idx.numel()]
                h = fk.gathered_matmul_dual(xb, wg, wu, idx)
                tag = f"{str(dtype)[6:]} {name} ({int(torch.unique(idx).numel())} leaves)"
                out[f"gathered_matmul_dual {tag}"] = device_ms(
                    lambda: fk.gathered_matmul_dual(xb, wg, wu, idx))
                out[f"gathered_matmul {tag}"] = device_ms(
                    lambda: fk.gathered_matmul(h, wd, idx))
            xd = randn(DECODE_B, D)
            nw, nb = randn(1, 2 ** DEPTH - 1, D, scale=D ** -0.5), randn(1, 2 ** DEPTH - 1, scale=0.1)
            leaves = (wg[None], wu[None], wd[None])
            out[f"fused_forest_decode {str(dtype)[6:]} batch {DECODE_B}"] = device_ms(
                lambda: fdk.fused_forest_decode(xd, nw, nb, leaves, depth=DEPTH, act="swiglu"))
            del wg, wu, wd, leaves
            torch.cuda.empty_cache()
        out.update(measure_grouped(gk, device_ms, time_ms))
        out.update(measure_vit_sites(gk, device_ms, time_ms))
        out.update(measure_routers(device_ms, time_ms))
        out.update(measure_decode_sites(fdk, device_ms))
    out.update(measure_vit_speedup(checkout))
    return out


def measure_decode_sites(fdk, device_ms) -> dict:
    """The fused decode kernel's device ms at DECODE_SITES (bf16, batch 8)."""
    import torch
    dev = torch.device("cuda")
    out = {}
    for name, trees, depth, d, L in DECODE_SITES:
        gen = torch.Generator(device=dev).manual_seed(2)

        def randn(*shape, scale=1.0):
            return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

        E, N = 2 ** depth, 2 ** depth - 1
        leaves = (randn(trees, E, d, L, scale=d ** -0.5), randn(trees, E, d, L, scale=d ** -0.5),
                  randn(trees, E, L, d, scale=L ** -0.5))
        nw, nb = randn(trees, N, d, scale=d ** -0.5), randn(trees, N, scale=0.1)
        x = randn(DECODE_B, d)
        out[f"fused_forest_decode bfloat16 {name} batch {DECODE_B}"] = device_ms(
            lambda: fdk.fused_forest_decode(x, nw, nb, leaves, depth=depth, act="swiglu"))
        del leaves
        torch.cuda.empty_cache()
    return out


def host_ms(call, n: int = 200) -> float:
    """Host clock per call over n calls enqueued back to back (fewer than
    the launch queue holds, so the host never waits for the device)."""
    import torch
    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        call()
    took = time.perf_counter() - t0
    torch.cuda.synchronize()
    return took / n * 1e3


def measure_grouped(gk, device_ms, time_ms) -> dict:
    """The grouped GEMMs' device and loop ms at GROUPED_SITES."""
    import torch
    dev = torch.device("cuda")
    out = {}
    for name, n, C, d, L, dual, dname, tokens in GROUPED_SITES:
        dtype = getattr(torch, dname)
        gen = torch.Generator(device=dev).manual_seed(1)

        def randn(*shape, scale=1.0):
            return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

        leaf = torch.randint(0, n, (tokens,), generator=gen, device=dev)
        gs = torch.bincount(leaf, minlength=n).clamp(max=C).to(torch.int32)
        mask = (torch.arange(C, device=dev)[None, :] < gs[:, None])[..., None]
        x = randn(n, C, d) * mask
        wg, wu, wd = randn(n, d, L, scale=d ** -0.5), randn(n, d, L, scale=d ** -0.5), \
            randn(n, L, d, scale=L ** -0.5)
        up = ((lambda: gk.grouped_matmul_dual(x, wg, wu, gs)) if dual else
              (lambda: gk.grouped_matmul(x, wg, gs, act="gelu")))
        h = up()
        calls = {"grouped_matmul_dual" if dual else "grouped_matmul (up)": up,
                 "grouped_matmul": lambda: gk.grouped_matmul(h, wd, gs)}
        for kname, call in calls.items():
            tag = f"{kname} {dname} {name} (E {n}, C {C})"
            out[tag] = device_ms(call)
            out[f"{tag} loop"] = time_ms(call)
            out[f"{tag} host"] = host_ms(call)
        del x, wg, wu, wd, h
        torch.cuda.empty_cache()
    return out


def timed_three_ways(tag, call, device_ms, time_ms) -> dict:
    """Device ms of ``call``, the loop of 20 launches and the enqueue time."""
    return {tag: device_ms(call), f"{tag} loop": time_ms(call), f"{tag} host": host_ms(call)}


def measure_routers(device_ms, time_ms) -> dict:
    """``tree_router`` at the starcoder2 draft's float32 router (D 6144,
    depth 3) and internlm2-20b's bf16 one (D 6144, depth 4), at 1024 and
    32 tokens."""
    import torch
    from repro_torch.kernels.tree_router import kernel as trk
    dev = torch.device("cuda")
    out = {}
    for name, dtype, depth in (("draft", torch.float32, 3), ("main", torch.bfloat16, DEPTH)):
        gen = torch.Generator(device=dev).manual_seed(3)

        def randn(*shape, scale=1.0):
            return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

        N = 2 ** depth - 1
        nw, nb = randn(N, D, scale=D ** -0.5), randn(N, scale=0.1)
        for B in (1024, VERIFY_B):
            x = randn(B, D)
            out.update(timed_three_ways(
                f"tree_router {str(dtype)[6:]} {name} ({B} tok, D {D}, depth {depth})",
                lambda: trk.tree_router(x, nw, nb, depth=depth), device_ms, time_ms))
    return out


def measure_vit_sites(gk, device_ms, time_ms) -> dict:
    """``tree_router`` and ``grouped_matmul`` up (gelu) and down at the
    paper ViT's evenly routed site for each of VIT_LEAVES, float32, drawn
    and routed as ``chip_smoke.py``'s ``vit_balanced_site`` and
    ``vit_site_rows`` do; the router also on the site's first 2048 tokens
    at l1."""
    import math
    import torch
    from chip_smoke import vit_capacity
    from repro_torch.core import fff as fff_lib
    from repro_torch.kernels.fused_decode import ops as fd_ops
    from repro_torch.kernels.leaf_gemm import ops as gemm_ops
    from repro_torch.kernels.tree_router import kernel as trk, ref as trr
    out = {}
    gen = lambda s: torch.Generator(device="cuda").manual_seed(s)
    for leaf in VIT_LEAVES:
        x = torch.randn((VIT_TOKENS, 128), generator=gen(0), device="cuda")
        c = fff_lib.FFFConfig(dim_in=128, dim_out=128, depth=int(math.log2(128 // leaf)),
                              leaf_width=leaf, activation="gelu", leaf_bias=False)
        p = fff_lib.init(gen(2), c)
        nw, nb = (t[0].contiguous() for t in fd_ops.collapse_nodes(p, c))
        idx = trr.tree_router_ref(x, nw, nb, depth=c.depth)
        lay = gemm_ops.scatter_to_groups(x, idx, c.num_leaves,
                                         vit_capacity(VIT_TOKENS, c.num_leaves))
        w1, w2 = p["leaf_w1"][0].contiguous(), p["leaf_w2"][0].contiguous()
        xg, gs = lay.x_grouped, lay.group_sizes
        h = gk.grouped_matmul(xg, w1, gs, act="gelu")
        tag = f"float32 vit l{leaf} balanced (E {c.num_leaves}, C {xg.shape[1]})"
        for B in (VIT_TOKENS, 2048) if leaf == 1 else (VIT_TOKENS,):
            xb = x[:B]
            out.update(timed_three_ways(
                f"tree_router float32 vit l{leaf} balanced ({B} tok, D 128, depth {c.depth})",
                lambda: trk.tree_router(xb, nw, nb, depth=c.depth), device_ms, time_ms))
        out[f"grouped_matmul (up) {tag}"] = device_ms(
            lambda: gk.grouped_matmul(xg, w1, gs, act="gelu"))
        out[f"grouped_matmul {tag}"] = device_ms(lambda: gk.grouped_matmul(h, w2, gs))
    return out


def measure_vit_speedup(checkout: Path) -> dict:
    """The ViT's FFN-site speedup at batch 2048 on the cuda backend, through
    ``checkout``'s example (host clock; the paper's quantity)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "vit_example", checkout / "examples" / "vit_cifar_fff_torch.py")
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    return {f"vit FFN-site speedup l{leaf} (cuda, batch {ex.SITE_BATCH}; x, not ms)":
            ex.ffn_site_speedup(leaf, device="cuda", backend="cuda") for leaf in VIT_LEAVES}


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--measure":
        print(json.dumps(measure(Path(sys.argv[2]).resolve())))
        return 0
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device available")
    baseline = Path(sys.argv[1]).resolve()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    runs = []
    for side in (baseline, ROOT, ROOT, baseline):
        proc = subprocess.run([sys.executable, __file__, "--measure", str(side)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"kernel_ab: measuring {side} failed:\n{proc.stderr[-4000:]}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    print("device ms per call (a key ending in \"loop\": a loop of 20 launches, "
          "host cost in; \"host\": the host clock's enqueue time; the ViT speedups are "
          "ratios), runs in the order baseline, this, this, baseline")
    for key in runs[1]:
        b1, t1, t2, b2 = (r.get(key, float("nan")) for r in runs)
        print(f"{key:72s} this {t1:.4f} / {t2:.4f}  baseline {b1:.4f} / {b2:.4f}")
    print("host cost per call, this / baseline, mean of each side's two runs: loop less "
          "device ms; the host clock's enqueue time")
    for key in runs[1]:
        if key.endswith(" loop") and key[:-5] in runs[1]:
            base = key[:-5]
            over = [r.get(key, float("nan")) - r.get(base, float("nan")) for r in runs]
            host = [r.get(f"{base} host", float("nan")) for r in runs]
            print(f"{base:58s} loop less device: this {(over[1] + over[2]) / 2 * 1e3:.2f} us "
                  f"baseline {(over[0] + over[3]) / 2 * 1e3:.2f} us; enqueue: this "
                  f"{(host[1] + host[2]) / 2 * 1e3:.2f} us baseline "
                  f"{(host[0] + host[3]) / 2 * 1e3:.2f} us")
    return 0


if __name__ == "__main__":
    sys.exit(main())
