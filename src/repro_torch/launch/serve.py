"""Serving driver: the fixed-batch loop (port of ``repro/launch/serve.py
--engine off``, ``run_legacy``).  One batched prefill, then a greedy decode
loop; prints prefill time, decode latency percentiles, tokens/s and how
many times each CUDA kernel launched.  The continuous-batching engine is
the next slice.

``serve(cfg, ...)`` takes any ``ModelConfig`` — e.g. a full-width config
with fewer layers, ``dataclasses.replace(FFF_CONFIG, n_layers=8)``.  The
command line serves the registry config cut by ``reduced()``, as the JAX
driver does (its ``--reduced`` is always on)::

  PYTHONPATH=src python -m repro_torch.launch.serve --batch 4 \
      --prompt-len 32 --gen 16 [--fff-backend auto|reference|cuda|cuda_decode]
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
          gen: int = 16, fff_backend: str = "auto", eos_id: int = -1,
          seed: int = 0, device="cuda", params=None) -> ServeResult:
    """Prefill ``batch`` Markov-source prompts of ``prompt_len`` tokens and
    decode up to ``gen`` tokens greedily.  ``params`` defaults to
    ``lm.init(cfg, seed=seed)`` on ``device``."""
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
        if fff_backend == "auto":
            return contextlib.nullcontext()
        return api.overrides(backend=fff_backend, mode="infer")

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


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-20b",
                    choices=list(registry.ARCH_IDS))
    # dense/native FFN sites are not ported yet
    ap.add_argument("--ffn", default="fff", choices=["fff"])
    ap.add_argument("--fff-backend", default="auto",
                    choices=["auto"] + api.list_backends("infer"),
                    help="execution backend for every FFF site (auto = "
                         "per-site resolution; see core/api.py)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
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
    serve(cfg, batch=args.batch, prompt_len=args.prompt_len, gen=args.gen,
          fff_backend=args.fff_backend, eos_id=args.eos_id, seed=args.seed,
          device=args.device)


if __name__ == "__main__":
    main()
