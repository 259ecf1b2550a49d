"""Serving through the CUDA kernels of the PyTorch/CUDA port: routes a
batch through tree_router and the grouped leaf GEMMs and cross-checks it
against the plain PyTorch reference, the production inference dataflow end
to end.

Every path is one ``api.apply()`` call; only ``ExecutionSpec.backend``
changes (``reference`` against the ``cuda`` kernels), which is the point
of the backend registry (``repro_torch/core/api.py``).  On a CUDA tensor
the 256-token batch runs tree_router, grouped_matmul_dual and
grouped_matmul, and the 8-token batch tree_router, gathered_matmul_dual
and gathered_matmul.  With ``--device cpu`` the same calls run each
kernel's plain version.

Run:  PYTHONPATH=src python examples/serve_fff_kernels_torch.py
          [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import utils
from repro_torch.core import api, fff, routing


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    if out[0].is_cuda:
        torch.cuda.synchronize(out[0].device)
    return out, 1e3 * (time.perf_counter() - t0)


@torch.inference_mode()
def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    dev = utils.resolve_device(args.device)

    # a transformer-FFN-sized FFF layer: d_model 512, 16 leaves x 256 = 4096 width
    cfg = fff.FFFConfig(dim_in=512, dim_out=512, depth=4, leaf_width=256,
                        activation="swiglu", leaf_bias=False)
    params = fff.init(torch.Generator(device=dev).manual_seed(0), cfg)
    x = torch.randn((256, 512), generator=torch.Generator(device=dev).manual_seed(1),
                    device=dev)
    print(f"FFF layer: {cfg.num_leaves} leaves x {cfg.leaf_width} wide "
          f"(training width {cfg.training_width}, inference width "
          f"{cfg.inference_width})")

    # --- oracle ----------------------------------------------------------
    (y_ref, out), ms = _timed(lambda: api.apply(
        params, cfg, x, api.ExecutionSpec(mode="infer", backend="reference")))
    print(f"apply(backend='reference')  {ms:7.1f}ms")

    # --- batch path: router kernel + sorted-dispatch grouped GEMMs --------
    # (256 tokens > the gathered kernels' 32-token slab, so the cuda backend
    # takes the grouped leaf GEMMs)
    (y_k, out_k), ms = _timed(lambda: api.apply(
        params, cfg, x, api.ExecutionSpec(mode="infer", backend="cuda")))
    # untrained random params put some tokens near decision boundaries where
    # the f32 reduction order can legitimately flip a routing sign; require
    # near-total agreement rather than exact (hardened networks agree)
    same = (out_k.leaf_idx == out.leaf_idx).all(-1)
    route_agree = float(same.float().mean())
    err = float((y_k - y_ref)[same].abs().max())
    print(f"apply(backend='cuda')       {ms:7.1f}ms   "
          f"max|err| vs oracle = {err:.2e} (routing agreement {route_agree:.4f})")
    if not route_agree > 0.99:
        raise AssertionError(f"routing agreement {route_agree:.4f}")

    # --- decode path: per-token gathered weights ----------------------------
    # small batches route to the gathered kernels by themselves
    xd = x[:8]
    y_dec, out_dec = api.apply(params, cfg, xd,
                               api.ExecutionSpec(mode="infer", backend="cuda"))
    y_dec_ref, out_dec_ref = api.apply(
        params, cfg, xd, api.ExecutionSpec(mode="infer", backend="reference"))
    same_dec = (out_dec.leaf_idx == out_dec_ref.leaf_idx).all(-1)
    err_dec = float((y_dec - y_dec_ref)[same_dec].abs().max())
    print(f"apply(backend='cuda', decode batch)  max|err| vs oracle = "
          f"{err_dec:.2e}")

    # --- routing statistics -------------------------------------------------
    leaf_idx = out.leaf_idx[:, 0]
    hist = routing.leaf_histogram(leaf_idx, cfg.num_leaves).cpu().numpy()
    skew = float(routing.routing_skew(leaf_idx, cfg.num_leaves))
    print(f"\nrouting: leaf loads {np.asarray(hist).astype(int).tolist()}  "
          f"skew={skew:.2f} (1.0 = perfectly balanced; capacity dispatch "
          f"bounds the worst case)")
    return dict(max_abs_err=err, routing_agreement=route_agree,
                decode_max_abs_err=err_dec,
                decode_routing_agreement=float(same_dec.float().mean()),
                skew=skew)


if __name__ == "__main__":
    main()
