"""Same-card A/B of the gathered leaf matmuls and the fused decode kernel:
this checkout's kernels against another checkout's (for example a parent
commit unpacked with ``git archive``), each side through its own wrappers.

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
- ``fused_forest_decode`` at decode batch 8, one tree of 16 SwiGLU leaves.

Prints the card's name and power limit, then one line per kernel, dtype and
routing with the four readings.  Needs one CUDA card.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
D, L_W, O, E, VERIFY_B, DECODE_B, DEPTH = 6144, 1024, 6144, 16, 32, 8, 4


def measure(checkout: Path) -> dict:
    """Device ms per kernel, dtype and routing, through `checkout`'s
    wrappers, on inputs drawn from fixed seeds."""
    import torch
    sys.path[:0] = [str(checkout / "src"), str(ROOT)]
    from chip_smoke import device_ms
    from repro_torch.kernels import common
    from repro_torch.kernels.fused_decode import kernel as fdk
    from repro_torch.kernels.fused_fff import kernel as fk

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
    return out


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
    print("device ms per call, runs in the order baseline, this, this, baseline")
    for key in runs[1]:
        b1, t1, t2, b2 = (r.get(key, float("nan")) for r in runs)
        print(f"{key:58s} this {t1:.4f} / {t2:.4f}  baseline {b1:.4f} / {b2:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
