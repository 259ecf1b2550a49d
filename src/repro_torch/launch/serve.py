"""Serving driver (port of ``repro/launch/serve.py``): the continuous-
batching engine (default) or the fixed-batch loop (``--engine off``).

``--engine continuous`` serves ``--requests`` Markov-source requests of
mixed prompt lengths (up to ``--prompt-len``) through ``repro_torch.
serving``: a request queue, admission by ``--scheduler fcfs|leaf_aware``,
a slot-pooled KV cache of ``--batch`` slots and interleaved prefill and
decode over fixed shapes.  ``--prefill-chunk N`` switches admission to
chunked prefill (N tokens per slab, at most ``--prefill-budget`` slabs per
step); ``--spec-k K`` turns on speculative decoding, the draft
(``--draft-config self:N``, default the target's first period) proposing K
tokens per slot per round and the target verifying them in one slab.
``--fff-backend grouped`` (or ``grouped_ep``) serves every FFF site through
capacity-bounded grouped dispatch, ``--capacity-factor`` sets its per-leaf
capacity and ``--overflow-policy`` what over-capacity tokens get.
``--engine off`` keeps the fixed-batch loop: one batched prefill, then a
greedy decode loop.  Both print latency percentiles, tokens/s and how many
times each CUDA kernel launched.

``serve(cfg, ...)`` and ``serve_engine(cfg, ...)`` take any
``ModelConfig``, e.g. a full-width config with fewer layers,
``dataclasses.replace(FFF_CONFIG, n_layers=8)``.  The command line serves
the registry config cut by ``reduced()``, as the JAX driver does (its
``--reduced`` is always on).  The card is the default; ``--device cpu``
runs the plain PyTorch versions on the host::

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --engine continuous --batch 4 --prompt-len 32 --gen 8 --spec-k 2
  PYTHONPATH=src python -m repro_torch.launch.serve --engine off --batch 4 \
      --prompt-len 32 --gen 16 [--fff-backend auto|reference|grouped|...]
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --fff-backend grouped --capacity-factor 0.5 --overflow-policy exact_dense
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import utils
from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig
from repro_torch.core import api
from repro_torch.data import tokens as tokens_lib
from repro_torch.kernels import common
from repro_torch.models import lm
from repro_torch.serving import metrics as metrics_lib
from repro_torch.serving.engine import ContinuousBatchingEngine, EngineConfig
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import SCHEDULERS


@dataclasses.dataclass
class ServeResult:
    tokens: torch.Tensor           # (B, 1 + decode steps) generated tokens
    prefill_s: float
    decode_s: list                 # per decode step
    step_tokens: list              # real (non-pad) tokens per decode step
    steady: Optional[metrics_lib.LatencySummary]
    tokens_per_s: float
    launches: dict                 # kernel name -> launches during the run


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(cfg: ModelConfig, *, batch: int = 4, prompt_len: int = 32,
          gen: int = 16, fff_backend: str = "auto",
          capacity_factor: Optional[float] = None,
          overflow_policy: Optional[str] = None, eos_id: int = -1,
          seed: int = 0, device="cuda", params=None) -> ServeResult:
    """Prefill ``batch`` Markov-source prompts of ``prompt_len`` tokens and
    decode up to ``gen`` tokens greedily.  ``params`` defaults to
    ``lm.init(cfg, seed=seed)`` on ``device``.  ``fff_backend``,
    ``capacity_factor`` and ``overflow_policy`` steer every FFF site
    (``api.overrides``)."""
    dev = utils.resolve_device(device)
    if params is None:
        params = lm.init(cfg, seed=seed, device=dev)
        print(f"{cfg.arch_id}: {lm.param_count(params)/1e6:.1f}M params")
    src = tokens_lib.MarkovTokenSource(cfg.vocab_size, seed=seed)
    prompt = torch.from_numpy(
        src.sample(batch, prompt_len, seed=1)[:, :prompt_len]).to(dev)
    max_len = prompt_len + gen + 1

    def backend_ctx():
        # mode="infer": a serving override never redirects train-mode math
        kw = {}
        if fff_backend != "auto":
            kw.update(backend=fff_backend, mode="infer")
        if capacity_factor is not None:
            kw["capacity_factor"] = capacity_factor
        if overflow_policy is not None:
            kw["overflow_policy"] = overflow_policy
        return api.overrides(**kw) if kw else contextlib.nullcontext()

    before = common.launch_counts()
    caches = lm.init_caches(cfg, batch, max_len, device=dev)
    with torch.inference_mode():
        t0 = time.perf_counter()
        with backend_ctx():
            logits, caches = lm.prefill(params, cfg, {"tokens": prompt}, caches)
        _sync(dev)
        t_prefill = time.perf_counter() - t0
        # "requested": ineligible sites fall through to auto resolution
        print(f"prefill: {batch}x{prompt_len} in {t_prefill*1e3:.1f}ms "
              f"(first call, fff backend={fff_backend} requested)")

        eos = eos_id if eos_id >= 0 else None
        tok = logits.argmax(-1)[:, None].to(torch.int32)
        out = [tok]
        lat, step_tokens = [], []
        done = np.zeros((batch,), bool)
        for i in range(gen):
            if eos is not None:
                done |= tok[:, 0].cpu().numpy() == eos
                if done.all():
                    break
            t0 = time.perf_counter()
            with backend_ctx():
                logits, caches = lm.decode_step(params, cfg, tok, caches,
                                                prompt_len + i)
            _sync(dev)
            lat.append(time.perf_counter() - t0)
            step_tokens.append(int(batch - done.sum()))  # finished rows: pad
            tok = logits.argmax(-1)[:, None].to(torch.int32)
            if eos is not None:
                tok = torch.where(torch.from_numpy(done).to(dev)[:, None],
                                  torch.full_like(tok, eos), tok)
            out.append(tok)
    gen_tokens = torch.cat(out, dim=1)
    summary, tok_s = None, 0.0
    if lat:
        # steady state leaves out the first step; tokens and time cover the
        # same steps, so tok/s is decode-only
        steady = slice(1, None) if len(lat) > 1 else slice(None)
        summary = metrics_lib.summarize(lat[steady])
        tok_s = metrics_lib.tokens_per_second(sum(step_tokens[steady]),
                                              max(sum(lat[steady]), 1e-9))
        print(f"decode: {len(lat)} steps; first {lat[0]*1e3:.1f}ms; "
              + summary.line("steady"))
        print(f"throughput: {tok_s:.1f} tok/s steady decode "
              f"({sum(step_tokens)} decode tokens total)")
    else:
        print("decode: 0 steps (every sequence hit --eos-id at prefill)")
    print("sample continuation:", gen_tokens[0].cpu().tolist()[:12])
    after = common.launch_counts()
    launches = {k: after[k] - before.get(k, 0) for k in after}
    print("kernel launches: " + (" ".join(f"{k}={v}" for k, v in
                                          sorted(launches.items())) or "none"))
    return ServeResult(gen_tokens, t_prefill, lat, step_tokens, summary,
                       tok_s, launches)


@dataclasses.dataclass
class EngineRun:
    results: list                  # RequestResult per request, by rid
    metrics: metrics_lib.EngineMetrics
    launches: dict                 # kernel name -> launches during the run
    shapes: dict                   # engine.dispatch_shapes()


def build_requests(vocab_size: int, n: int, prompt_len: int, gen: int, *,
                   eos_id: int = -1, seed: int = 0,
                   min_prompt_len: Optional[int] = None) -> list:
    """``n`` Markov-source requests with prompts of mixed lengths in
    [min_prompt_len, prompt_len] (default min: max(4, prompt_len // 4)) and
    ``gen`` new tokens each (the JAX driver's synthetic workload, less
    tenants and shared prefixes)."""
    src = tokens_lib.MarkovTokenSource(vocab_size, seed=seed)
    rng = np.random.default_rng(seed)
    lo = min(min_prompt_len or max(4, prompt_len // 4), prompt_len)
    reqs = []
    for i in range(n):
        L = int(rng.integers(lo, prompt_len + 1))
        reqs.append(Request(rid=i, prompt=src.sample(1, L, seed=seed + 1 + i)[0, :L],
                            max_new_tokens=gen,
                            eos_id=eos_id if eos_id >= 0 else None))
    return reqs


def serve_engine(cfg: ModelConfig, ecfg: EngineConfig, requests: list, *,
                 params=None) -> EngineRun:
    """Serve ``requests`` through a ``ContinuousBatchingEngine`` on
    ``ecfg.device``; ``params`` defaults to ``lm.init(cfg, seed=ecfg.seed)``
    there.  Prints the metrics report, the dispatch shapes and the kernel
    launches of the run."""
    if params is None:
        params = lm.init(cfg, seed=ecfg.seed, device=ecfg.device)
        print(f"{cfg.arch_id}: {lm.param_count(params)/1e6:.1f}M params")
    engine = ContinuousBatchingEngine(params, cfg, ecfg)
    mode = (f"chunked prefill (chunk={ecfg.prefill_chunk}, "
            f"budget={ecfg.prefill_budget})" if ecfg.prefill_chunk
            else "monolithic prefill")
    spec = (f", speculative (k={ecfg.spec_k}, "
            f"draft={ecfg.draft_config or 'self'})" if ecfg.spec_k else "")
    print(f"engine: {ecfg.num_slots} slots, {len(requests)} requests, prompt "
          f"lens {min(len(r.prompt) for r in requests)}-"
          f"{max(len(r.prompt) for r in requests)}, scheduler="
          f"{ecfg.scheduler}, {mode}{spec}, fff backend={ecfg.fff_backend} "
          f"requested" + (f", capacity factor {ecfg.capacity_factor}"
                          if ecfg.capacity_factor is not None else "")
          + (f", overflow policy {ecfg.overflow_policy}"
             if ecfg.overflow_policy is not None else ""))
    before = common.launch_counts()
    results, m = engine.run(requests)
    _sync(engine.device)
    after = common.launch_counts()
    launches = {k: after[k] - before.get(k, 0) for k in after}
    print(m.report())
    shapes = engine.dispatch_shapes()
    print("dispatch shapes: " + " ".join(
        f"{k}={sorted(v)}" for k, v in sorted(shapes.items())))
    print("kernel launches: " + " ".join(f"{k}={v}" for k, v in
                                         sorted(launches.items())))
    return EngineRun(results, m, launches, shapes)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-20b",
                    choices=list(registry.ARCH_IDS))
    ap.add_argument("--ffn", default="fff", choices=["fff", "native", "dense"],
                    help="fff = the paper's FFF sites; native/dense = the "
                         "arch's dense FFN (the vanilla FF baseline: no "
                         "kernel, no routing telemetry; leaf_aware admits "
                         "as fcfs)")
    ap.add_argument("--fff-backend", default="auto",
                    choices=["auto"] + api.list_backends("infer"),
                    help="execution backend for every FFF site (auto = "
                         "per-site resolution; see core/api.py)")
    ap.add_argument("--capacity-factor", type=float, default=None,
                    help="capacity factor of the capacity-bounded FFF "
                         "backends (grouped / grouped_ep): per-(shard, leaf) "
                         "slots scale with cf * tokens / leaves; < 1.0 "
                         "under-provisions on purpose, pair it with "
                         "--overflow-policy (default: the backend's own)")
    ap.add_argument("--overflow-policy", default=None,
                    choices=list(api.OVERFLOW_POLICIES),
                    help="what over-capacity tokens get under a capacity-"
                         "bounded backend: exact_dense = their exact leaf "
                         "output, master_leaf = the always-on master term "
                         "alone (needs a model built with fff_master_leaf), "
                         "drop = zeros (default: the backend's own)")
    ap.add_argument("--engine", default="continuous",
                    choices=["continuous", "off"],
                    help="continuous = the batching engine "
                         "(repro_torch.serving); off = the fixed-batch loop")
    ap.add_argument("--scheduler", default="fcfs", choices=sorted(SCHEDULERS),
                    help="admission policy for --engine continuous")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="engine: >0 = chunked prefill, this many tokens per "
                         "(slots, chunk) slab, interleaved with decode (a "
                         "power of two <= --prompt-len; 0 = monolithic "
                         "per-bucket prefill)")
    ap.add_argument("--prefill-budget", type=int, default=1,
                    help="engine: most chunk slabs per step when "
                         "--prefill-chunk > 0")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="engine: >0 = speculative decoding, the draft "
                         "proposing this many tokens per slot per round and "
                         "the target verifying the (slots, k+1) slab; 0 = "
                         "plain one-token decode")
    ap.add_argument("--draft-config", default="",
                    help="engine: the draft for --spec-k, 'self' / 'self:N' "
                         "= the target's own first N periods (default "
                         "'self')")
    ap.add_argument("--batch", type=int, default=4,
                    help="fixed batch (off) / cache slots (engine)")
    ap.add_argument("--requests", type=int, default=0,
                    help="engine: number of requests (0 = 2x slots)")
    ap.add_argument("--prompt-len", type=int, default=32,
                    help="prompt length (off) / longest prompt (engine)")
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--eos-id", type=int, default=-1,
                    help=">= 0: stop each sequence at this token id")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch versions)")
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    cfg = registry.get_config(args.arch, ffn=args.ffn)
    cfg = cfg.reduced(seq=max(64, args.prompt_len + args.gen + 1))
    if args.engine == "off":
        serve(cfg, batch=args.batch, prompt_len=args.prompt_len, gen=args.gen,
              fff_backend=args.fff_backend,
              capacity_factor=args.capacity_factor,
              overflow_policy=args.overflow_policy, eos_id=args.eos_id,
              seed=args.seed, device=args.device)
        return
    ecfg = EngineConfig(
        num_slots=args.batch, max_len=args.prompt_len + args.gen + 1,
        max_prompt_len=args.prompt_len, scheduler=args.scheduler,
        prefill_chunk=args.prefill_chunk, prefill_budget=args.prefill_budget,
        fff_backend=args.fff_backend, capacity_factor=args.capacity_factor,
        overflow_policy=args.overflow_policy, spec_k=args.spec_k,
        draft_config=args.draft_config or None, seed=args.seed,
        device=args.device)
    reqs = build_requests(cfg.vocab_size, args.requests or 2 * args.batch,
                          args.prompt_len, args.gen, eos_id=args.eos_id,
                          seed=args.seed)
    serve_engine(cfg, ecfg, reqs)


if __name__ == "__main__":
    main()
