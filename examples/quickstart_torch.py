"""Quickstart on the PyTorch/CUDA port: the FFF layer as a drop-in
feedforward replacement.

Trains a small fast-feedforward network on a synthetic image task, watches
the hardening process, then serves it with hard (FORWARD_I) routing.
Everything goes through the one entry point::

    y, out = api.apply(params, cfg, x, api.ExecutionSpec(mode=..., backend=...))

``mode`` picks the paper's semantics (FORWARD_T soft mixture for training,
FORWARD_I single-leaf descent for inference); ``backend`` picks the
implementation from a registry: ``"auto"`` (the default) takes the CUDA
kernels (tree_router and the grouped GEMMs) for a tensor on the card and
the plain PyTorch reference otherwise, and step 5 registers a custom
backend to show the seam.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--steps 300]
          [--device cuda|cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import optim, utils
from repro_torch.core import api, fff
from repro_torch.data import synthetic


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the plain versions)")
    args = ap.parse_args(argv)

    # --- 1. data -----------------------------------------------------------
    ds = synthetic.make("mnist_like")
    print(f"dataset: {ds.x_train.shape[0]} train / {ds.x_test.shape[0]} test, "
          f"dim={ds.dim}, classes={ds.num_classes}")
    dev = utils.resolve_device(args.device)

    # --- 2. an FFF layer: depth 4, leaf width 8 => training width 128,
    #        inference width 8 (the paper's headline trade) -------------------
    cfg = fff.FFFConfig(dim_in=ds.dim, dim_out=ds.num_classes, depth=4,
                        leaf_width=8, activation="relu", hardening_scale=3.0)
    params = fff.init(torch.Generator(device=dev).manual_seed(0), cfg)
    print(f"FFF: training width {cfg.training_width}, inference width "
          f"{cfg.inference_width}, {cfg.num_leaves} leaves; execution backends "
          f"registered for inference: {api.list_backends('infer')}")

    # --- 3. train with the hardening loss (L_total = L_pred + h * L_harden) --
    opt = optim.sgd(0.2)
    state = opt.init(params)
    train = api.ExecutionSpec(mode="train")                 # FORWARD_T

    def loss_fn(p, x, y):
        logits, out = api.apply(p, cfg, x, train)
        ce = -torch.log_softmax(logits, -1).gather(1, y[:, None]).mean()
        return ce + cfg.hardening_scale * fff.hardening_loss(out.node_probs), \
            out.entropy

    step = optim.value_and_grad(loss_fn)
    rng = np.random.default_rng(0)
    for i in range(args.steps):
        sel = rng.integers(0, len(ds.x_train), 256)
        (loss, ent), g = step(params, torch.as_tensor(ds.x_train[sel], device=dev),
                              torch.as_tensor(ds.y_train[sel], device=dev).long())
        u, state = opt.update(g, state, params)
        params = optim.apply_updates(params, u)
        if i % 50 == 0:
            print(f"step {i:3d}  loss {float(loss):.3f}  "
                  f"mean node entropy {float(ent):.3f}  (hardening toward 0)")

    # --- 4. serve with hard routing (FORWARD_I): one leaf per input ----------
    x_test = torch.as_tensor(ds.x_test, device=dev)
    infer = api.ExecutionSpec(mode="infer")                 # backend="auto"
    with torch.inference_mode():
        logits_hard, out = api.apply(params, cfg, x_test, infer)
        acc = float((logits_hard.argmax(-1).cpu().numpy() == ds.y_test).mean())
        logits_soft, _ = api.apply(params, cfg, x_test, train)
        agree = float((logits_soft.argmax(-1) == logits_hard.argmax(-1)).float().mean())
        logits_ref, out_ref = api.apply(params, cfg, x_test,
                                        api.ExecutionSpec(mode="infer",
                                                          backend="reference"))
    backend = api.resolve_backend(params, cfg, "infer", tuple(x_test.shape),
                                  x_test.device)
    same = (out.leaf_idx == out_ref.leaf_idx).all(-1)
    route_agree = float(same.float().mean())
    err = float((logits_hard - logits_ref)[same].abs().max())
    print(f"\nhard-inference accuracy: {acc:.3f}  "
          f"(soft/hard agreement {agree:.3f}: hardening carried over)")
    print(f"auto resolved to {backend!r}: routing agreement with the "
          f"reference {route_agree:.4f}, max|err| where it agrees {err:.2e}")

    # --- 5. the registry seam: plug in a custom execution backend ------------
    # A backend is any fn(params, cfg, x, spec) -> (y, FFFOutput).  This toy
    # one wraps the reference path and rounds outputs to bf16: a stand-in for
    # quantized serving, remote execution, new kernels, ...
    def bf16_backend(p, c, x, spec):
        y, o = api.get_backend("infer", "reference")(p, c, x, spec)
        return y.to(torch.bfloat16).float(), o

    api.register_backend("infer", "bf16-demo", bf16_backend)
    with torch.inference_mode():
        logits_q, _ = api.apply(params, cfg, x_test,
                                api.ExecutionSpec(mode="infer", backend="bf16-demo"))
    agree_q = float((logits_q.argmax(-1) == logits_hard.argmax(-1)).float().mean())
    print(f"custom 'bf16-demo' backend agreement with exact serving: {agree_q:.3f}")

    # --- 6. the learned partition of the input space -------------------------
    hist = np.bincount(out.leaf_idx[:, 0].cpu().numpy(), minlength=cfg.num_leaves)
    print(f"leaf load histogram over test set: {hist.tolist()}")
    return dict(accuracy=acc, soft_hard_agreement=agree, backend=backend,
                max_abs_err=err, routing_agreement=route_agree,
                bf16_agreement=agree_q, leaf_histogram=hist.tolist())


if __name__ == "__main__":
    main()
