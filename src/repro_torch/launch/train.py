"""Training driver (port of ``repro/launch/train.py``): Markov-source
batches -> ``lm.loss_fn`` and its gradient -> clipped AdamW with a cosine
warmup, step by step, printing the JAX driver's step line.

``train(cfg, ...)`` takes any ``ModelConfig`` (e.g. a full-width config
with fewer layers) and optionally ready parameters; the command line
trains the registry config, cut by ``reduced()`` with ``--reduced``.  The
card is the default; ``--device cpu`` runs on the host::

  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-20b \\
      --reduced --steps 3 --device cpu

Not offered yet: the JAX driver's ``--ckpt-dir``, ``--ckpt-every`` and
``--mesh`` with its checkpoint manager, fault supervisor and straggler
tracker (they come with ``checkpoint/`` and ``distributed/{fault,
straggler}``), and ``--ffn dense|native`` (with ``core/ff.py``).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, Optional

import torch

from repro_torch import optim, utils
from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig
from repro_torch.data import tokens as tokens_lib
from repro_torch.models import lm


def _with_fff_training_opts(cfg: ModelConfig, *, balance: float = 0.0,
                            master: bool = False) -> ModelConfig:
    """Turn on the balance aux weight and/or the master leaf on every FFF
    site of ``cfg``."""
    def upd(b):
        if b.ffn.kind != "fff":
            return b
        return dataclasses.replace(b, ffn=dataclasses.replace(
            b.ffn, balance_scale=balance, fff_master_leaf=master))

    return dataclasses.replace(cfg, period=tuple(upd(b) for b in cfg.period))


@dataclasses.dataclass
class TrainResult:
    params: dict                   # the trained parameters
    metrics: list                  # per step: the loss_fn metrics as floats
    step_ms: list                  # per step: loss, gradient and update (CUDA
                                   # events on the card, host clock on the CPU)

    @property
    def losses(self) -> list:
        return [m["loss"] for m in self.metrics]


def train(cfg: ModelConfig, *, steps: int, batch: int, seq: int,
          lr: float = 3e-4, seed: int = 0, device="cuda",
          params: Optional[dict] = None,
          inspect: Optional[Callable] = None, log=print) -> TrainResult:
    """``steps`` steps of ``chain_clip(adamw(cosine_warmup(lr, steps // 10
    + 1, steps)), 1.0)`` on ``MarkovTokenSource(cfg.vocab_size, seed)``
    batches (``batch(batch, seq, seed=seed + i)`` at step i), from
    ``params`` or ``lm.init(cfg, seed=seed)``; params made under
    ``torch.inference_mode`` cannot train.  ``inspect(i, grads, metrics)``,
    when given, sees each step's gradients before the update."""
    dev = utils.resolve_device(device)
    if params is None:
        params = lm.init(cfg, seed=seed, device=dev)
    log(f"{cfg.arch_id}: {lm.param_count(params) / 1e6:.1f}M params, "
        f"device={dev}")
    opt = optim.chain_clip(
        optim.adamw(optim.cosine_warmup(lr, steps // 10 + 1, steps)), 1.0)
    state = opt.init(params)
    source = tokens_lib.MarkovTokenSource(cfg.vocab_size, seed=seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    grad_fn = optim.value_and_grad(lambda p, b: lm.loss_fn(p, cfg, b, gen))
    on_card = dev.type == "cuda"
    metrics_log, step_ms = [], []
    for i in range(steps):
        b = source.batch(batch, seq, seed=seed + i)
        if on_card:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
        t0 = time.perf_counter()
        (_, metrics), grads = grad_fn(params, b)
        if inspect is not None:
            inspect(i, grads, metrics)
        updates, state = opt.update(grads, state, params)
        del grads
        params = optim.apply_updates(params, updates)
        del updates
        if on_card:
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        else:
            ms = (time.perf_counter() - t0) * 1e3
        m = {k: float(v) for k, v in metrics.items()}
        metrics_log.append(m)
        step_ms.append(ms)
        log(f"step {i:4d} loss {m['loss']:8.4f} ce {m['ce']:8.4f} "
            f"harden {m['hardening']:6.3f} balance {m['balance']:7.4f} "
            f"{ms:7.1f}ms")
    log(f"done at step {steps}")
    return TrainResult(params=params, metrics=metrics_log, step_ms=step_ms)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Train an LM with FFF FFN sites on Markov-source data.",
        epilog="Not offered yet: --ckpt-dir, --ckpt-every and --mesh (with "
               "checkpoint/ and distributed/{fault,straggler}), and --ffn "
               "dense|native (with core/ff.py).")
    ap.add_argument("--arch", default="internlm2-20b",
                    choices=list(registry.ARCH_IDS))
    ap.add_argument("--ffn", default="fff", choices=["fff"])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU-runnable)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--balance-weight", type=float, default=0.0,
                    help="load-balancing aux weight over FFF soft leaf "
                         "usage; 0 = off")
    ap.add_argument("--master-leaf", action="store_true",
                    help="train with the always-on master leaf (enables "
                         "master_leaf overflow repair at serving time)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def main(argv=None) -> TrainResult:
    args = build_parser().parse_args(argv)
    cfg = registry.get_config(args.arch, ffn=args.ffn)
    if args.reduced:
        cfg = cfg.reduced()
    if args.balance_weight or args.master_leaf:
        cfg = _with_fff_training_opts(cfg, balance=args.balance_weight,
                                      master=args.master_leaf)
    return train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                 lr=args.lr, seed=args.seed, device=args.device)


if __name__ == "__main__":
    main()
