"""Training driver (port of ``repro/launch/train.py``): Markov-source
batches -> ``lm.loss_fn`` and its gradient -> clipped AdamW with a cosine
warmup, step by step, printing the JAX driver's step line.  With
``--ckpt-dir`` the steps run inside the fault supervisor over the state
``{"params", "opt"}``: a checkpoint every ``--ckpt-every`` steps and at
the end (async, atomic, the newest 2 kept), restore-and-replay after a
failed step, and a run started over an existing directory resumes from
its newest checkpoint.  Step ``i`` draws from a generator seeded from
``(seed, i)`` alone, so a replayed step is the step it replaces.

``train(cfg, ...)`` takes any ``ModelConfig`` (e.g. a full-width config
with fewer layers) and optionally ready parameters; the command line
trains the registry config (``--ffn fff``; ``native`` for the arch's own
FFN, the dense baseline or olmoe-1b-7b's noisy top-k MoE; ``dense`` for a
dense FFN of the training width), cut by ``reduced()`` with
``--reduced``.  The arch defaults to olmoe-1b-7b, as in the JAX driver.
As there, each step of an encoder model (whisper-small) adds
``enc_embeds`` and a frontend model without an encoder (internvl2-26b)
trains on ``embeds`` in place of tokens, both float32 N(0, 1) from
``np.random.default_rng(i)`` at step i.
``--mesh host|prod`` trains data-parallel over a layout of the world's
ranks (``launch/mesh``; ``host`` is every rank on one data axis, ``prod``
the 256-rank production layout): each rank takes its share of each step's
batch (the batch one process would draw) and the parameters are stored as
the config's ``zero_stage`` says (``distributed/sharding.shard_params``,
``fsdp`` at stage 3; replicated below it, and the gradients mean-reduced
over the data axes); each rank's optimizer updates its own slices, and
the clip reads the norm of the whole gradient.  Run one process a rank
under ``python -m torch.distributed.run``; one process is a world of one.
The card is the default; ``--device cpu`` runs on the host::

  PYTHONPATH=src python -m repro_torch.launch.train --reduced --steps 6 \\
      --ckpt-every 3 --ckpt-dir /path/to/ckpt --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b \\
      --ffn native --reduced --steps 3 --device cpu
  python -m torch.distributed.run --nproc-per-node 2 -m \\
      repro_torch.launch.train --reduced --steps 3 --mesh host --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import optim, utils
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig
from repro_torch.data import tokens as tokens_lib
from repro_torch.distributed import fault, sharding, straggler
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import lm


def _with_fff_training_opts(cfg: ModelConfig, *, balance: float = 0.0,
                            master: bool = False) -> ModelConfig:
    """Turn on the balance aux weight and/or the master leaf on every FFF
    site of ``cfg``, the decoder's and the encoder's."""
    def upd(b):
        if b.ffn.kind != "fff":
            return b
        return dataclasses.replace(b, ffn=dataclasses.replace(
            b.ffn, balance_scale=balance, fff_master_leaf=master))

    cfg = dataclasses.replace(cfg, period=tuple(upd(b) for b in cfg.period))
    if cfg.encoder is not None and cfg.encoder.period:
        cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
            cfg.encoder, period=tuple(upd(b) for b in cfg.encoder.period)))
    return cfg


def step_batch(cfg: ModelConfig, source, batch: int, seq: int, seed: int,
               i: int) -> dict:
    """Step ``i``'s batch: ``source.batch(batch, seq, seed=seed + i)``'s
    tokens and labels; a frontend model without an encoder takes
    ``embeds`` (batch, seq, D) in place of the tokens, and an encoder model
    adds ``enc_embeds`` (batch, encoder seq_len, D), float32 N(0, 1) from
    ``np.random.default_rng(i)`` as in the JAX driver."""
    b = source.batch(batch, seq, seed=seed + i)
    if cfg.frontend != "none" and cfg.encoder is None:
        b = {"embeds": np.random.default_rng(i).normal(
            0, 1, (batch, seq, cfg.d_model)).astype(np.float32), "labels": b["labels"]}
    if cfg.encoder is not None:
        b["enc_embeds"] = np.random.default_rng(i).normal(
            0, 1, (batch, cfg.encoder.seq_len, cfg.d_model)).astype(np.float32)
    return b


def step_generator(seed: int, i: int, device) -> torch.Generator:
    """Step ``i``'s generator, seeded from ``(seed, i)`` alone (the JAX
    driver's ``jax.random.fold_in(key, i)``): a step replayed after a
    restore draws what the step it replaces drew."""
    s = np.random.SeedSequence((seed, i)).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(s >> np.uint64(1)))


@dataclasses.dataclass
class TrainResult:
    params: dict                   # the trained parameters
    opt_state: object              # the optimizer state after the last step
    metrics: list                  # per step run: the loss_fn metrics as floats
    step_ms: list                  # per step run: loss, gradient and update (CUDA
                                   # events on the card, host clock on the CPU)
    start: int = 0                 # the first step this call ran (a resumed
                                   # checkpoint's step); metrics cover start..end
    end: int = 0                   # the step the run ended at
    restarts: int = 0              # restores after a failed step
    ckpt_timings: dict = dataclasses.field(default_factory=dict)
                                   # with a checkpoint directory: the manager's
                                   # newest snapshot_s, write_s and restore_s
    placements: Optional[sharding.Placements] = None
                                   # with a layout: where the slices in params
                                   # and opt_state lie (its gather makes them
                                   # whole)

    @property
    def losses(self) -> list:
        return [m["loss"] for m in self.metrics]


def train(cfg: ModelConfig, *, steps: int, batch: int, seq: int,
          lr: float = 3e-4, seed: int = 0, device="cuda",
          params: Optional[dict] = None,
          inspect: Optional[Callable] = None, log=print,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 10, keep: int = 2,
          failure_hook: Optional[Callable[[int], bool]] = None,
          layout=None) -> TrainResult:
    """``steps`` steps of ``chain_clip(adamw(cosine_warmup(lr, steps // 10
    + 1, steps)), 1.0)`` on ``MarkovTokenSource(cfg.vocab_size, seed)``
    batches (``step_batch`` at step i), from
    ``params`` or ``lm.init(cfg, seed=seed)``; params made under
    ``torch.inference_mode`` cannot train.  ``inspect(i, grads, metrics)``,
    when given, sees each step's gradients before the update.

    With ``ckpt_dir`` the steps run under ``fault.TrainSupervisor``: a
    checkpoint of ``{"params", "opt"}`` every ``ckpt_every`` steps and at
    the end (``keep`` kept), resuming from the directory's newest one, and
    ``failure_hook(i) -> True`` failing step ``i`` (the supervisor
    restores and replays, on the same device).

    With ``layout`` (``launch/mesh``; every rank of the world calls
    ``train`` alike) the steps run data-parallel over its data axes: this
    rank takes its share of each step's batch, ``params`` (whole, the same
    on every rank) are placed by ``sharding.Placements.of(params, layout,
    fsdp=cfg.zero_stage >= 3)`` and each rank keeps its slices, the gradients are averaged over the data ranks,
    the clip reads the whole gradient's norm, checkpoints hold whole arrays
    (rank 0 writes), and ``metrics`` are the data ranks' means.  The
    returned parameters and optimizer state are this rank's slices
    (``placements.gather`` of the result makes them whole)."""
    dev = utils.resolve_device(device)
    if params is None:
        params = lm.init(cfg, seed=seed, device=dev)
    log(f"{cfg.arch_id}: {lm.param_count(params) / 1e6:.1f}M params, "
        f"device={dev}")
    norm_fn = utils.tree_global_norm
    share = slice(None)
    placements = None
    if layout is not None:
        placements = sharding.Placements.of(params, layout,
                                            fsdp=cfg.zero_stage >= 3)
        params = placements.shard(params)
        norm_fn = functools.partial(sharding.global_norm,
                                    placements=placements)
        d, n = mesh_lib.data_index(layout, mesh_lib.world_rank())
        if batch % n:
            raise ValueError(f"batch {batch} does not split over {n} data ranks")
        share = slice(d * batch // n, (d + 1) * batch // n)
        log(f"layout: {layout.shape} (data-parallel over {n} ranks, "
            f"zero_stage {cfg.zero_stage})")
    opt = optim.chain_clip(
        optim.adamw(optim.cosine_warmup(lr, steps // 10 + 1, steps)), 1.0,
        norm_fn)
    source = tokens_lib.MarkovTokenSource(cfg.vocab_size, seed=seed)
    grad_fn = optim.value_and_grad(lambda p, b, g: lm.loss_fn(p, cfg, b, g))
    on_card = dev.type == "cuda"
    runs = {}                      # step -> (metrics, ms) of its newest run

    def one_step(params, opt_state, i):
        b = {k: v[share] for k, v in
             step_batch(cfg, source, batch, seq, seed, i).items()}
        if on_card:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
        t0 = time.perf_counter()
        with sharding.use_placements(placements):
            (_, metrics), grads = grad_fn(params, b, step_generator(seed, i, dev))
        if layout is not None:
            grads = sharding.reduce_gradients(grads, placements)
            metrics = sharding.data_mean(metrics, layout)
        if inspect is not None:
            inspect(i, grads, metrics)
        updates, opt_state = opt.update(grads, opt_state, params)
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
        runs[i] = (m, ms)
        log(f"step {i:4d} loss {m['loss']:8.4f} ce {m['ce']:8.4f} "
            f"harden {m['hardening']:6.3f} balance {m['balance']:7.4f} "
            f"{ms:7.1f}ms")
        return params, opt_state, ms

    start = restarts = 0
    timings = {}
    if ckpt_dir is None:
        opt_state = opt.init(params)
        for i in range(steps):
            params, opt_state, _ = one_step(params, opt_state, i)
        end = steps
    else:
        manager = CheckpointManager(ckpt_dir, keep=keep,
                                    placements=placements)
        tracker = straggler.StepTimeTracker(1)
        start = manager.latest_step() or 0
        if start:
            log(f"resuming from step {start} ({ckpt_dir})")

        def do_step(state, i):
            p, o, ms = one_step(state["params"], state["opt"], i)
            tracker.record([ms / 1e3])
            return {"params": p, "opt": o}

        sup = fault.TrainSupervisor(manager, fault.SupervisorConfig(
            ckpt_every=ckpt_every, keep=keep))
        result = sup.run({"params": params, "opt": opt.init(params)}, do_step,
                         steps, failure_hook=failure_hook)
        params, opt_state = result.state["params"], result.state["opt"]
        end, restarts = result.step, result.restarts
        timings = dict(manager.timings)
    log(f"done at step {end} (restarts={restarts})")
    done = sorted(runs)
    return TrainResult(params=params, opt_state=opt_state,
                       metrics=[runs[i][0] for i in done],
                       step_ms=[runs[i][1] for i in done], start=start, end=end,
                       restarts=restarts, ckpt_timings=timings,
                       placements=placements)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Train an LM with FFF (or dense or MoE) FFN sites on "
                    "Markov-source data.")
    ap.add_argument("--arch", default="olmoe-1b-7b",
                    choices=list(registry.ARCH_IDS),
                    help="registry arch (default olmoe-1b-7b, the JAX "
                         "driver's)")
    ap.add_argument("--ffn", default="fff", choices=["fff", "native", "dense"],
                    help="fff = the paper's FFF sites; native = the arch's "
                         "own FFN (dense, or the noisy top-k MoE with its "
                         "balancing loss); dense = a dense FFN of the "
                         "training width (the vanilla FF baseline)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU-runnable)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory: run under the fault "
                         "supervisor, resuming from its newest checkpoint "
                         "(default: no checkpoints)")
    ap.add_argument("--ckpt-every", type=int, default=10,
                    help="steps between checkpoints (with --ckpt-dir)")
    ap.add_argument("--mesh", default="host", choices=["host", "prod"],
                    help="the layout of the world's ranks: host = every rank "
                         "on one data axis; prod = the (16, 16) production "
                         "layout, 256 ranks (one process a rank, e.g. under "
                         "python -m torch.distributed.run)")
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
    rank, world = mesh_lib.init_ranks()
    layout = (mesh_lib.make_production_mesh() if args.mesh == "prod"
              else mesh_lib.make_host_mesh() if world > 1 else None)
    return train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                 lr=args.lr, seed=args.seed, device=args.device,
                 ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                 layout=layout, log=print if rank == 0 else _quiet)


def _quiet(*_a, **_kw) -> None:
    """The log of a rank other than 0: rank 0 reports for the world."""


if __name__ == "__main__":
    main()
