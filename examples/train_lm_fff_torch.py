"""End-to-end driver on the PyTorch/CUDA port: train a ~100M-parameter
decoder-only LM whose FFN sites are fast-feedforward layers, for a few
hundred steps, with checkpointing and restart: the port's train path at
example scale.

Training is plain PyTorch (FORWARD_T at the FFF sites); the closing greedy
sample serves the trained model, on a card through the kernels (the
gathered kernels for the 8-token prompt, fused decode for each new token).
The supervisor checkpoints every ``--ckpt-every`` steps into
``--ckpt-dir``; run the command again to resume from its newest
checkpoint.

Run:  PYTHONPATH=src python examples/train_lm_fff_torch.py [--steps 300]
          [--small] [--device cuda|cpu] [--ckpt-dir DIR]
(~100M params; --small drops to a ~10M model for a fast demo.)
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch import optim, utils
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import BlockSpec, FFNSpec, ModelConfig
from repro_torch.data import tokens as tokens_lib
from repro_torch.distributed import fault
from repro_torch.models import lm


def make_config(small: bool) -> ModelConfig:
    if small:
        d_model, n_layers, d_ff, vocab = 256, 4, 1024, 2048
    else:
        d_model, n_layers, d_ff, vocab = 768, 12, 3072, 32768   # ~100M params
    ffn = FFNSpec(kind="dense", d_ff=d_ff, activation="swiglu").as_fff(
        leaf_width=d_ff // 8)
    return ModelConfig(
        arch_id="example-lm-fff",
        family="dense",
        d_model=d_model,
        n_layers=n_layers,
        n_heads=d_model // 64,
        n_kv_heads=d_model // 64,
        vocab_size=vocab,
        max_seq_len=1024,
        period=(BlockSpec(mixer="attn", ffn=ffn),),
        scan_layers=True,
        attn_chunk=256,
    )


def main(argv=None) -> fault.RunResult:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_example_lm"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the plain versions)")
    args = ap.parse_args(argv)

    cfg = make_config(args.small)
    params = lm.init(cfg, seed=0, device=args.device)
    print(f"model: {utils.tree_size(params) / 1e6:.1f}M params "
          f"({cfg.n_layers}L d{cfg.d_model}, FFF "
          f"{cfg.period[0].ffn.fff_depth}-deep "
          f"{cfg.period[0].ffn.fff_leaf_width}-wide leaves)")

    opt = optim.chain_clip(
        optim.adamw(optim.cosine_warmup(3e-4, 20, args.steps)), 1.0)
    src = tokens_lib.MarkovTokenSource(cfg.vocab_size, seed=0)
    grad = optim.value_and_grad(lambda p, b, g: lm.loss_fn(p, cfg, b, g))
    dev = utils.tree_leaves(params)[0].device

    def do_step(state, i):
        batch = src.batch(args.batch, args.seq, seed=i)
        t0 = time.perf_counter()
        (_, m), g = grad(state["params"], batch,
                         torch.Generator(device=dev).manual_seed(1 + i))
        u, o2 = opt.update(g, state["opt"], state["params"])
        p2 = optim.apply_updates(state["params"], u)
        if i % 10 == 0:
            print(f"step {i:4d}  ce {float(m['ce']):7.4f}  "
                  f"harden {float(m['hardening']):6.4f}  "
                  f"acc {float(m['accuracy']):5.3f}  "
                  f"{(time.perf_counter() - t0) * 1e3:7.0f}ms", flush=True)
        return {"params": p2, "opt": o2}

    mgr = CheckpointManager(args.ckpt_dir, keep=2)
    sup = fault.TrainSupervisor(mgr, fault.SupervisorConfig(
        ckpt_every=args.ckpt_every))
    res = sup.run({"params": params, "opt": opt.init(params)}, do_step,
                  args.steps)
    print(f"finished at step {res.step}; checkpoints in {args.ckpt_dir}")

    # quick sample
    prompt = torch.as_tensor(src.sample(1, 8, seed=9)[:, :8], device=dev)
    with torch.inference_mode():
        out = lm.generate(res.state["params"], cfg, prompt, steps=16, max_len=64)
    print("greedy sample:", out[0].tolist())
    return res


if __name__ == "__main__":
    main()
