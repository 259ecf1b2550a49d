"""Paper Table 3 on the PyTorch/CUDA port: a vision transformer whose
feedforward layers are fast-feedforward layers, down to single-neuron
inference width.

Trains the paper's 4-layer, d128 ViT (``repro_torch.configs.paper_vit``) on
synthetic CIFAR-like data, the dense baseline and FFF leaf widths l in
{32, 8, 1}, and prints G_A, the relative drop against the dense model
(paper: 5.8% at l=1) and the speedup at the FFN sites.  Training runs
FORWARD_T (plain PyTorch, no kernel); evaluation runs hard FORWARD_I, which
on a CUDA tensor goes through the tree_router and grouped_matmul kernels.

This file holds the port's own copies of the JAX repository's Table-3
pieces (``benchmarks/table3.py``: the patch batching, the ViT training and
the FFN-site timing) and of the classifier-training plumbing they use
(``benchmarks/common.py``: ``train_classifier``, ``accuracy``,
``time_fn``).

Run:  PYTHONPATH=src python examples/vit_cifar_fff_torch.py \
          [--steps 150] [--leaves 32 8 1] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import math
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import optim, utils
from repro_torch.configs.paper_vit import vit_config
from repro_torch.core import api
from repro_torch.core import ff as ff_lib
from repro_torch.core import fff as fff_lib
from repro_torch.data import synthetic
from repro_torch.models import lm
from repro_torch.nn import transformer

TRAIN_BATCH, EVAL_BATCH, SITE_BATCH, LR = 128, 256, 2048, 4e-4
DEFAULT_STEPS, DEFAULT_LEAVES = 150, (32, 8, 1)


# ---------------------------------------------------------------------------
# classifier plumbing (the port's copy of benchmarks/common.py's)
# ---------------------------------------------------------------------------

def time_fn(fn, *args, iters: int = 30, warmup: int = 3) -> tuple[float, float]:
    """(mean_us, std_us) per call of ``fn(*args)``: CUDA events around each
    call when the first tensor argument lies on a card, else the host
    clock."""
    cuda = any(isinstance(a, torch.Tensor) and a.is_cuda
               for a in utils.tree_leaves(list(args)))
    with torch.inference_mode():
        for _ in range(warmup):
            fn(*args)
        ts = []
        for _ in range(iters):
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn(*args)
                end.record()
                end.synchronize()
                ts.append(start.elapsed_time(end) * 1e3)
            else:
                t0 = time.perf_counter()
                fn(*args)
                ts.append((time.perf_counter() - t0) * 1e6)
    return float(np.mean(ts)), float(np.std(ts))


def train_classifier(train_fwd: Callable, params, ds, *, steps: int,
                     batch: int = 256, lr: float = 0.2, seed: int = 0,
                     opt=None, eval_every: int = 0,
                     eval_fn: Optional[Callable] = None,
                     losses: Optional[list] = None):
    """Classifier training loop (the paper's protocol: pure SGD, lr 0.2,
    unless ``opt`` is given).  ``train_fwd(params, x, gen) -> (logits,
    aux_loss)``; each step draws ``batch`` training rows with
    ``np.random.default_rng(seed)``, as the JAX loop does.  Returns (params,
    history), history the ``(step, eval_fn(params))`` pairs; ``losses``,
    when given, receives each step's loss (a host sync a step)."""
    opt = opt or optim.sgd(lr)
    state = opt.init(params)
    dev = utils.tree_leaves(params)[0].device

    def loss_fn(p, x, y, gen):
        logits, aux = train_fwd(p, x, gen)
        ce = -torch.log_softmax(logits.float(), -1).gather(1, y[:, None]).mean()
        return ce + aux, ce

    vg = optim.value_and_grad(loss_fn)
    rng = np.random.default_rng(seed)
    history = []
    for i in range(steps):
        sel = rng.integers(0, len(ds.x_train), batch)
        x = torch.as_tensor(ds.x_train[sel], device=dev)
        y = torch.as_tensor(ds.y_train[sel], device=dev).long()
        gen = torch.Generator(device=dev).manual_seed(seed + 12345 + i)
        (loss, _), grads = vg(params, x, y, gen)
        updates, state = opt.update(grads, state, params)
        params = optim.apply_updates(params, updates)
        if losses is not None:
            losses.append(float(loss))
        if eval_every and eval_fn and (i + 1) % eval_every == 0:
            history.append((i + 1, eval_fn(params)))
    return params, history


@torch.inference_mode()
def accuracy(predict: Callable, params, x, y, batch: int = 1024) -> float:
    dev = utils.tree_leaves(params)[0].device
    correct = 0
    for i in range(0, len(x), batch):
        logits = predict(params, torch.as_tensor(x[i:i + batch], device=dev))
        correct += int((logits.argmax(-1).cpu().numpy() == y[i:i + batch]).sum())
    return correct / len(x)


# ---------------------------------------------------------------------------
# the ViT (the port's copy of benchmarks/table3.py's)
# ---------------------------------------------------------------------------

def vit_batchify(ds, patch: int = 4, side: int = 32, channels: int = 3):
    """Flattened images -> (N, 64, 48) patch rows, train and test."""
    return (synthetic.patches(ds.x_train, side, channels, patch),
            synthetic.patches(ds.x_test, side, channels, patch))


def patch_projection(dpatch: int, d_model: int, seed: int = 0,
                     device="cuda") -> torch.Tensor:
    """The fixed random projection of raw patches to d_model, N(0, 1 /
    dpatch) from a generator seeded with ``seed + 1`` (the frontend stub
    owns the learned projection)."""
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    return torch.randn((dpatch, d_model), generator=gen,
                       device=device) / math.sqrt(dpatch)


def vit_forward(params, cfg, proj: torch.Tensor, x_patches: torch.Tensor,
                mode: str):
    """Patches (B, S, dpatch) -> class logits (B, classes), aux: the fixed
    projection, the vision stub and learned positions
    (``lm._embed_inputs``), the non-causal stack in ``mode`` ("train":
    FORWARD_T at every FFF site; "eval": hard FORWARD_I), the mean over
    tokens and the head."""
    emb = torch.einsum("bsp,pd->bsd", x_patches.to(proj.dtype), proj)
    x = lm._embed_inputs(params, cfg, {"embeds": emb})
    x, _, aux = transformer.stack_forward(params["stack"], cfg, x, mode=mode,
                                          causal=False)
    logits = lm._head(params, cfg, x.mean(dim=1)[:, None, :])[:, 0]
    return logits, aux


def make_vit(cfg, dpatch: int, seed: int = 0, device="cuda"):
    """(params, proj): ``lm.init``'s weights and the patch projection."""
    return (lm.init(cfg, seed=seed, device=device),
            patch_projection(dpatch, cfg.d_model, seed, device))


def vit_train(cfg, params, proj, x_patches, labels, steps: int, *,
              seed: int = 0, losses: Optional[list] = None):
    """``steps`` AdamW steps (lr 4e-4, batch 128) on the ViT's cross-entropy
    plus the FFF hardening loss; returns the trained params."""
    def fwd_train(p, x, gen=None):
        logits, aux = vit_forward(p, cfg, proj, x, "train")
        return logits, aux["hardening"]

    class DS:
        x_train, y_train = x_patches, labels

    params, _ = train_classifier(fwd_train, params, DS, steps=steps,
                                 batch=TRAIN_BATCH, seed=seed,
                                 opt=optim.adamw(LR), losses=losses)
    return params


def vit_accuracy(cfg, params, proj, x_patches, labels) -> float:
    """G_A: test accuracy under hard FORWARD_I at every FFF site."""
    return accuracy(lambda p, x: vit_forward(p, cfg, proj, x, "eval")[0],
                    params, x_patches, labels, batch=EVAL_BATCH)


def train_vit(cfg, ds_patches, labels, test_patches, test_labels, steps: int,
              seed: int = 0, device="cuda"):
    """The ViT trained ``steps`` steps and its G_A: (params, ga)."""
    params, proj = make_vit(cfg, ds_patches.shape[-1], seed, device)
    params = vit_train(cfg, params, proj, ds_patches, labels, steps, seed=seed)
    return params, vit_accuracy(cfg, params, proj, test_patches, test_labels)


def ffn_site_speedup(leaf: int, d_model: int = 128, d_ff: int = 128,
                     batch: int = SITE_BATCH, device="cuda",
                     backend: str = "reference") -> float:
    """Timed FFN-site comparison: dense FF(d_ff) against hard FFF(depth,
    leaf) on ``backend`` (the paper's per-token FORWARD_I gather:
    ``reference``, as the JAX benchmark pins it)."""
    dev = utils.resolve_device(device)
    gen = lambda s: torch.Generator(device=dev).manual_seed(s)
    x = torch.randn((batch, d_model), generator=gen(0), device=dev)
    fcfg = ff_lib.FFConfig(dim_in=d_model, dim_out=d_model, width=d_ff,
                           activation="gelu")
    fp = ff_lib.init(gen(1), fcfg)
    t_ff, _ = time_fn(lambda p, x: ff_lib.forward(p, fcfg, x), fp, x, iters=15)
    depth = int(np.log2(d_ff // leaf))
    xcfg = fff_lib.FFFConfig(dim_in=d_model, dim_out=d_model, depth=depth,
                             leaf_width=leaf, activation="gelu",
                             leaf_bias=False)
    xp = fff_lib.init(gen(2), xcfg)
    spec = api.ExecutionSpec(mode="infer", backend=backend)
    t_fff, _ = time_fn(lambda p, x: api.apply(p, xcfg, x, spec)[0], xp, x,
                       iters=15)
    return t_ff / t_fff


def run(steps: int = 200, leaves=(32, 8, 1), quick: bool = False,
        device="cuda") -> list[dict]:
    """Table 3's rows: the dense baseline, then each leaf width."""
    ds = synthetic.make("cifar10_like")
    xtr, xte = vit_batchify(ds)
    rows = []
    _, ga0 = train_vit(vit_config("dense"), xtr, ds.y_train, xte, ds.y_test,
                       steps, device=device)
    rows.append(dict(model="ff", leaf=0, depth=0, ga=ga0, speedup=1.0,
                     train_size=128, inf_width=128))
    for leaf in (leaves[:2] if quick else leaves):
        cfg = vit_config("fff", leaf_width=leaf)
        depth = int(np.log2(128 // leaf))
        _, ga = train_vit(cfg, xtr, ds.y_train, xte, ds.y_test, steps,
                          device=device)
        rows.append(dict(model="fff", leaf=leaf, depth=depth, ga=ga,
                         speedup=ffn_site_speedup(leaf, device=device),
                         train_size=(2 ** depth - 1) + 128, inf_width=leaf))
    return rows


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=DEFAULT_STEPS)
    ap.add_argument("--leaves", type=int, nargs="+", default=list(DEFAULT_LEAVES))
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    rows = run(steps=args.steps, leaves=tuple(args.leaves), device=args.device)
    base = rows[0]["ga"]
    print(f"\n{'model':12s} {'leaf':>4s} {'G_A':>7s} {'drop':>7s} "
          f"{'ffn speedup':>12s} {'inf width':>9s}")
    for r in rows:
        drop = (base - r["ga"]) / max(base, 1e-9) * 100
        print(f"{r['model']:12s} {r['leaf']:4d} {r['ga']:7.3f} "
              f"{drop:6.1f}% {r['speedup']:11.2f}x {r['inf_width']:9d}")
    return rows


if __name__ == "__main__":
    main()
