"""Serving driver (port of ``repro/launch/serve.py``): the continuous-
batching engine (default) or the fixed-batch loop (``--engine off``).

``--engine continuous`` serves ``--requests`` Markov-source requests of
mixed prompt lengths (up to ``--prompt-len``) through ``repro_torch.
serving``: a request queue, admission by ``--scheduler
fcfs|leaf_aware|weighted_leaf_aware``, a slot-pooled KV cache of
``--batch`` slots and interleaved prefill and decode over fixed shapes.
``--prefill-chunk N`` switches admission to chunked prefill (N tokens per
slab, at most ``--prefill-budget`` slabs per step, at most
``--max-prefilling`` slots prefilling at once); ``--spec-k K`` turns on
speculative decoding, the draft (``--draft-config self:N``, default the
target's first period) proposing K tokens per slot per round and the
target verifying them in one slab.  ``--page-size N`` pages the KV cache
(N tokens a page) and shares cached prompt prefixes across requests;
``--shared-prefix N`` starts every request with the same N-token system
prompt.  ``--tenant-weights a=3,b=1`` labels the requests round-robin with
those tenants and gives ``weighted_leaf_aware`` its weights.
``--fff-backend grouped`` (or ``grouped_ep``) serves every FFF site through
capacity-bounded grouped dispatch, ``--capacity-factor`` sets its per-leaf
capacity and ``--overflow-policy`` what over-capacity tokens get;
``--cuda-decode`` steers decode and draft steps to the fused decode
kernel.  ``--metrics-json PATH`` writes the run's metrics as JSON.
``--draft-config`` also takes a registry arch id: an independent draft of
that arch reduced to the target's width (``serving/spec.build_draft``).
``--cluster N_PREFILL N_DECODE`` serves through the disaggregated cluster
(``repro_torch.cluster``, ``run_cluster``): a router over that many
prefill and decode workers of ``--batch`` slots each, KV pages handed from
prefill to decode, on ``--cluster-bus proc`` (one process per worker,
each with its own CUDA context on the card) or ``local`` (in process);
``--cluster-kill N`` SIGKILLs a decode worker after N results,
``--cluster-verify`` replays the workload on one engine and reports
whether every token matched (``parity_ok``), ``--drain`` drains the fleet
at the end.
``--model-parallel M`` lays the world's ranks out as (world/M, M) on
("data", "model") (``launch/mesh.serving_context``), keeps each rank's
share of the leaves (``distributed/sharding.shard_leaves``: E/M leaves of
every FFF site where M divides E; every other tensor whole on each rank)
and serves every FFF site expert-parallel (``grouped_ep``): every rank serves the same requests to the same tokens
and rank 0 reports; one process a rank, e.g. under ``python -m
torch.distributed.run``; it refuses ``--cluster``, as the JAX driver does.
``--engine off`` keeps the fixed-batch loop: one batched prefill, then a
greedy decode loop.  Both replay their decode step (the engine also its
speculative round) from a CUDA graph captured once per shape
(``serving/graphs.py``), and print latency percentiles, tokens/s and how
many times each CUDA kernel launched.

``serve(cfg, ...)`` and ``serve_engine(cfg, ...)`` take any
``ModelConfig``, e.g. a full-width config with fewer layers,
``dataclasses.replace(FFF_CONFIG, n_layers=8)``.  The command line serves
the registry config cut by ``reduced()``, as the JAX driver does (its
``--reduced`` is always on).  The archs with recurrent mixers
(jamba-1.5-large-398b, xlstm-1.3b), the encoder-decoder whisper-small and
the vision-stub internvl2-26b serve through ``--engine off``: the engine
refuses them, as the JAX package's does.  The loop gives whisper-small
``enc_embeds`` (batch, the encoder's frames, D) and internvl2-26b an
``embeds`` prompt (batch, prompt-len, D) in place of tokens, drawn N(0, 1)
from ``np.random.default_rng(0)`` as the JAX driver draws them.  The card
is the default; ``--device cpu`` runs the plain PyTorch versions on the host::

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --engine continuous --batch 4 --prompt-len 32 --gen 8 --spec-k 2
  PYTHONPATH=src python -m repro_torch.launch.serve --engine off --batch 4 \
      --prompt-len 32 --gen 16 [--fff-backend auto|reference|grouped|...]
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --fff-backend grouped --capacity-factor 0.5 --overflow-policy exact_dense
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --page-size 4 --shared-prefix 8 --tenant-weights a=3,b=1 \
      --scheduler weighted_leaf_aware --metrics-json /tmp/metrics.json
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --cluster 1 1 --cluster-bus local --cluster-verify
  PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \
      -m repro_torch.launch.serve --model-parallel 2 --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import utils
from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig
from repro_torch.core import api
from repro_torch.data import tokens as tokens_lib
from repro_torch.distributed import sharding
from repro_torch.kernels import common
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import lm
from repro_torch.serving import graphs
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
    graphs: dict                   # decode graphs captured (staged on the CPU)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(cfg: ModelConfig, *, batch: int = 4, prompt_len: int = 32,
          gen: int = 16, fff_backend: str = "auto",
          capacity_factor: Optional[float] = None,
          overflow_policy: Optional[str] = None, eos_id: int = -1,
          seed: int = 0, device="cuda", params=None) -> ServeResult:
    """Prefill ``batch`` Markov-source prompts of ``prompt_len`` tokens and
    decode up to ``gen`` tokens greedily.  As in the JAX driver, an encoder
    model's batch adds ``enc_embeds`` and a frontend model without an
    encoder takes ``embeds`` (batch, prompt_len, D) for its prompt, both
    float32 N(0, 1) from ``np.random.default_rng(0)``; every decode step
    embeds its token.  ``params`` defaults to
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
    inputs = {"tokens": prompt}
    if cfg.encoder is not None:
        inputs["enc_embeds"] = torch.from_numpy(np.random.default_rng(0).normal(
            0, 1, (batch, cfg.encoder.seq_len, cfg.d_model)).astype(np.float32)).to(dev)
    if cfg.frontend != "none" and cfg.encoder is None:
        inputs = {"embeds": torch.from_numpy(np.random.default_rng(0).normal(
            0, 1, (batch, prompt_len, cfg.d_model)).astype(np.float32)).to(dev)}

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
    # the decode step, captured once as a CUDA graph and replayed (the JAX
    # loop's decode_jit); its cache leaves settle into the prefill's caches,
    # and the step's position is a staged input, as JAX passes it traced
    graph = graphs.DispatchCache(dev)

    def decode(inp):
        with backend_ctx():
            logits, new = lm.decode_step(params, cfg, inp["tok"], caches,
                                         inp["offset"])
        graphs.settle(caches, new)
        return {"logits": logits}

    with torch.inference_mode():
        t0 = time.perf_counter()
        with backend_ctx():
            logits, caches = lm.prefill(params, cfg, inputs, caches)
            ctx = graphs.context_key()
            eager = graphs.eager_reason(params, cfg, batch, 1)
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
            logits = graph.run("decode", (tuple(tok.shape), False, ctx), decode,
                               {"tok": tok, "offset": np.int32(prompt_len + i)},
                               eager=eager)["logits"]
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
                       tok_s, launches, graph.counts())


@dataclasses.dataclass
class EngineRun:
    results: list                  # RequestResult per request, by rid
    metrics: metrics_lib.EngineMetrics
    launches: dict                 # kernel name -> launches during the run
    shapes: dict                   # engine.dispatch_shapes()
    compiled: dict                 # engine.compiled_shapes()
    graphs: dict                   # dispatch graphs captured (staged on the CPU)


def parse_tenant_weights(spec: str) -> dict:
    """'gold=3,free=1' -> {'gold': 3.0, 'free': 1.0}."""
    out = {}
    for part in filter(None, (p.strip() for p in spec.split(","))):
        name, eq, w = part.partition("=")
        if not eq or not name:
            raise ValueError(f"--tenant-weights entry {part!r} is not "
                             f"tenant=weight")
        try:
            weight = float(w)
        except ValueError:
            raise ValueError(f"--tenant-weights entry {part!r}: weight "
                             f"{w!r} is not a number") from None
        if not (weight > 0 and np.isfinite(weight)):
            # fail where the operator sees which flag was wrong
            raise ValueError(f"--tenant-weights entry {part!r}: weight must "
                             f"be positive and finite")
        if name in out:
            raise ValueError(f"--tenant-weights names tenant {name!r} twice")
        out[name] = weight
    return out


def build_requests(vocab_size: int, n: int, prompt_len: int, gen: int, *,
                   eos_id: int = -1, seed: int = 0,
                   min_prompt_len: Optional[int] = None,
                   shared_prefix: int = 0, tenants=None) -> list:
    """``n`` Markov-source requests with prompts of mixed lengths in
    [min_prompt_len, prompt_len] (default min: max(shared_prefix + 1, 4,
    prompt_len // 4)) and ``gen`` new tokens each: the JAX driver's
    synthetic workload, prompt for prompt for the same seed.  With
    ``shared_prefix`` N > 0 every prompt starts with the same N-token
    system prompt; ``tenants`` (names) label the requests round-robin
    (default one tenant, "default")."""
    if shared_prefix >= prompt_len:
        raise ValueError(f"--shared-prefix ({shared_prefix}) must be "
                         f"< --prompt-len ({prompt_len}): every request "
                         f"needs at least one token of its own")
    src = tokens_lib.MarkovTokenSource(vocab_size, seed=seed)
    rng = np.random.default_rng(seed)
    tenants = list(tenants or ["default"])
    sp = max(shared_prefix, 0)
    system = src.sample(1, sp, seed=seed)[0, :sp] if sp else None
    lo = min(max(sp + 1, min_prompt_len or max(4, prompt_len // 4)),
             prompt_len)
    reqs = []
    for i in range(n):
        L = int(rng.integers(lo, prompt_len + 1))
        prompt = src.sample(1, L, seed=seed + 1 + i)[0, :L]
        if system is not None:
            prompt = np.concatenate([system, prompt[sp:]])
        reqs.append(Request(rid=i, prompt=prompt, max_new_tokens=gen,
                            eos_id=eos_id if eos_id >= 0 else None,
                            tenant=tenants[i % len(tenants)]))
    return reqs


def serve_engine(cfg: ModelConfig, ecfg: EngineConfig, requests: list, *,
                 params=None, metrics_json: str = "") -> EngineRun:
    """Serve ``requests`` through a ``ContinuousBatchingEngine`` on
    ``ecfg.device``; ``params`` defaults to ``lm.init(cfg, seed=ecfg.seed)``
    there.  Prints the metrics report, the dispatch shapes and the kernel
    launches of the run; with ``metrics_json`` also writes the metrics
    (``EngineMetrics.as_dict``), the dispatch shapes and the learned
    routing profiles there as JSON."""
    if params is None:
        params = lm.init(cfg, seed=ecfg.seed, device=ecfg.device)
        print(f"{cfg.arch_id}: {lm.param_count(params)/1e6:.1f}M params")
    engine = ContinuousBatchingEngine(params, cfg, ecfg)
    mode = (f"chunked prefill (chunk={ecfg.prefill_chunk}, "
            f"budget={ecfg.prefill_budget})" if ecfg.prefill_chunk
            else "monolithic prefill")
    spec = (f", speculative (k={ecfg.spec_k}, "
            f"draft={ecfg.draft_config or 'self'})" if ecfg.spec_k else "")
    paged = (f", paged kv (page={ecfg.page_size}, prefix sharing "
             f"{'on' if ecfg.prefix_sharing else 'off'})"
             if ecfg.page_size else "")
    tenants = sorted({r.tenant for r in requests})
    print(f"engine: {ecfg.num_slots} slots, {len(requests)} requests, prompt "
          f"lens {min(len(r.prompt) for r in requests)}-"
          f"{max(len(r.prompt) for r in requests)}, scheduler="
          f"{ecfg.scheduler}, {mode}{spec}{paged}, fff backend="
          f"{ecfg.fff_backend} requested"
          + (", cuda_decode on decode steps" if ecfg.cuda_decode else "")
          + (f", tenants {tenants}" if tenants != ["default"] else "")
          + (f", capacity factor {ecfg.capacity_factor}"
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
    compiled = engine.compiled_shapes()
    print("dispatch shapes: " + " ".join(
        f"{k}={sorted(v)}" for k, v in sorted(shapes.items()))
        + "; compiled (graphs, or shapes run eagerly): " + " ".join(
            f"{k}={v}" for k, v in sorted(compiled.items())))
    print("kernel launches: " + " ".join(f"{k}={v}" for k, v in
                                         sorted(launches.items())))
    if metrics_json:
        payload = m.as_dict()
        payload["dispatch_shapes"] = {k: sorted(map(list, v))
                                      for k, v in sorted(shapes.items())}
        if engine.profiles is not None:
            payload["routing_profiles"] = engine.profiles.as_dict()
        with open(metrics_json, "w") as f:
            json.dump(payload, f, indent=1)
        print(f"wrote metrics to {metrics_json}")
    return EngineRun(results, m, launches, shapes, compiled,
                     engine._graphs.counts())


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-20b",
                    choices=list(registry.ARCH_IDS))
    ap.add_argument("--ffn", default="fff", choices=["fff", "native", "dense"],
                    help="fff = the paper's FFF sites; native = the arch's "
                         "own FFN (dense, or olmoe-1b-7b's top-k MoE); dense "
                         "= a dense FFN of the training width (native and "
                         "dense run no kernel and give no routing telemetry; "
                         "leaf_aware admits as fcfs)")
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
    ap.add_argument("--cuda-decode", action="store_true",
                    help="engine: steer one-token decode steps (and the "
                         "speculative draft steps) to the cuda_decode backend, "
                         "the one-call fused decode kernels; prefill and "
                         "verify slabs keep the normal resolution (the JAX "
                         "driver's --pallas-decode)")
    ap.add_argument("--engine", default="continuous",
                    choices=["continuous", "off"],
                    help="continuous = the batching engine "
                         "(repro_torch.serving); off = the fixed-batch loop")
    ap.add_argument("--scheduler", default="fcfs", choices=sorted(SCHEDULERS),
                    help="admission policy for --engine continuous")
    ap.add_argument("--tenant-weights", default="",
                    help="comma list of tenant=weight pairs (e.g. "
                         "gold=3,free=1): the requests are labelled "
                         "round-robin with the named tenants, and the "
                         "weights drive --scheduler weighted_leaf_aware's "
                         "weighted-fair admission; empty = one 'default' "
                         "tenant")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="engine: >0 = chunked prefill, this many tokens per "
                         "(slots, chunk) slab, interleaved with decode (a "
                         "power of two <= --prompt-len; 0 = monolithic "
                         "per-bucket prefill)")
    ap.add_argument("--prefill-budget", type=int, default=1,
                    help="engine: most chunk slabs per step when "
                         "--prefill-chunk > 0")
    ap.add_argument("--max-prefilling", type=int, default=0,
                    help="scheduler: most slots mid-chunked-prefill at once "
                         "(0 = uncapped)")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="engine: >0 = speculative decoding, the draft "
                         "proposing this many tokens per slot per round and "
                         "the target verifying the (slots, k+1) slab; 0 = "
                         "plain one-token decode")
    ap.add_argument("--draft-config", default="",
                    help="engine: the draft for --spec-k, 'self' / 'self:N' "
                         "= the target's own first N periods (default "
                         "'self'), or a registry arch id = that arch reduced "
                         "to the target's width, random weights")
    ap.add_argument("--page-size", type=int, default=0,
                    help="engine: >0 = paged KV cache, a pool of pages of "
                         "this many tokens with per-slot page tables; "
                         "admissions that share a cached prompt prefix map "
                         "its pages instead of prefilling them (0 = one "
                         "contiguous row per slot)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="workload: >0 = every request starts with the same "
                         "system prompt of this many tokens (0 = "
                         "independent prompts)")
    ap.add_argument("--metrics-json", default="",
                    help="engine: write the run's metrics, dispatch shapes "
                         "and learned routing profiles as JSON to this path")
    ap.add_argument("--batch", type=int, default=4,
                    help="fixed batch (off) / cache slots (engine)")
    ap.add_argument("--requests", type=int, default=0,
                    help="engine: number of requests (0 = 2x slots)")
    ap.add_argument("--prompt-len", type=int, default=32,
                    help="prompt length (off) / longest prompt (engine)")
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--eos-id", type=int, default=-1,
                    help=">= 0: stop each sequence at this token id")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="model-axis size of the serving layout; >1 lays "
                         "the world's ranks out as (data, model), stores "
                         "each rank's share of the FFF leaves and serves "
                         "the FFF sites expert-parallel (grouped_ep); run "
                         "one process a rank, e.g. under python -m "
                         "torch.distributed.run")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch versions)")
    ap.add_argument("--cluster", nargs=2, type=int, default=None,
                    metavar=("N_PREFILL", "N_DECODE"),
                    help="disaggregated serving: this many prefill and "
                         "decode workers behind the cluster router "
                         "(repro_torch.cluster) instead of one engine; each "
                         "worker gets --batch slots; implies a paged KV "
                         "cache (--page-size, 16 when unset)")
    ap.add_argument("--cluster-bus", default="proc", choices=["local", "proc"],
                    help="cluster transport: proc = one OS process per "
                         "worker (each with its own CUDA context); local = "
                         "every worker in this process, stepped in turn")
    ap.add_argument("--cluster-kill", type=int, default=0,
                    help="cluster fault injection: after this many requests "
                         "complete, SIGKILL one decode worker; the router "
                         "replays its in-flight requests from the prompt and "
                         "respawns the role (0 = no kill)")
    ap.add_argument("--cluster-verify", action="store_true",
                    help="cluster: afterwards serve the same requests on one "
                         "engine in this process and report whether every "
                         "token matched (parity_ok in --metrics-json)")
    ap.add_argument("--scale-up-watermark", type=float, default=0.0,
                    help="cluster: smoothed queue depth above which the "
                         "monitor spawns a decode worker (0 = off)")
    ap.add_argument("--scale-down-watermark", type=float, default=0.0,
                    help="cluster: smoothed queue depth below which an idle "
                         "surplus decode worker is drained (0 = never)")
    ap.add_argument("--heartbeat-timeout", type=float, default=600.0,
                    help="cluster: seconds without a heartbeat before a "
                         "worker is declared dead and its requests replayed")
    ap.add_argument("--drain", action="store_true",
                    help="cluster: after serving, drain the fleet (finish "
                         "in-flight work, stop each worker on its Drained "
                         "handshake) instead of stopping it at once")
    return ap


def _json_default(o):
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, (np.integer, np.floating)):
        return o.item()
    raise TypeError(f"not JSON serializable: {type(o)}")


def run_cluster(args, cfg: ModelConfig) -> None:
    """Disaggregated serving (``--cluster N_PREFILL N_DECODE``): the router
    over role-restricted worker engines, the prefill-to-decode KV handoff,
    heartbeat liveness and replay, and elastic scaling when its watermarks
    are set.  Every worker runs on ``--device``.  Prints the report; with
    ``--metrics-json`` writes the metrics, the cluster's counters, the
    topology and ``parity_ok`` (with ``--cluster-verify``) as JSON."""
    from repro_torch.cluster import (ClusterConfig, ClusterWorker, LocalBus,
                                     ProcBus, Router, WorkerSpec)
    from repro_torch.cluster.control import ControlConfig

    n_prefill, n_decode = args.cluster
    if n_prefill < 1 or n_decode < 1:
        raise ValueError("--cluster needs >= 1 prefill and >= 1 decode worker")
    if args.model_parallel > 1:
        raise ValueError("--cluster and --model-parallel are exclusive: "
                         "cluster workers are single-process engines")
    page = args.page_size or 16         # the handoff moves pages: paging is on
    weights = parse_tenant_weights(args.tenant_weights)
    sched_kw = ({"weights": weights}
                if weights and args.scheduler == "weighted_leaf_aware" else {})

    def ecfg_for(role):
        return EngineConfig(
            num_slots=args.batch, max_len=args.prompt_len + args.gen + 1,
            max_prompt_len=args.prompt_len, prefill_chunk=args.prefill_chunk,
            prefill_budget=args.prefill_budget, fff_backend=args.fff_backend,
            cuda_decode=args.cuda_decode, capacity_factor=args.capacity_factor,
            overflow_policy=args.overflow_policy, spec_k=args.spec_k,
            draft_config=args.draft_config or None, page_size=page,
            seed=args.seed, device=args.device)

    ctrl = ControlConfig(
        heartbeat_timeout=args.heartbeat_timeout,
        scale_up_watermark=args.scale_up_watermark or 1e9,
        scale_down_watermark=args.scale_down_watermark or -1.0,
        max_decode=max(n_decode + 2, n_decode * 2))
    params = None
    if args.cluster_bus == "local":
        params = lm.init(cfg, seed=args.seed, device=args.device)
        print(f"{cfg.arch_id}: {lm.param_count(params)/1e6:.1f}M params "
              f"(shared by the in-process workers)")
        bus = LocalBus(lambda wid, role: ClusterWorker(
            wid, role, ContinuousBatchingEngine(params, cfg, ecfg_for(role))))
    else:
        bus = ProcBus(lambda wid, role: WorkerSpec(
            wid=wid, role=role, cfg=cfg, ecfg=ecfg_for(role), seed=args.seed,
            device=args.device))
    router = Router(bus, ClusterConfig(
        n_prefill=n_prefill, n_decode=n_decode, scheduler=args.scheduler,
        scheduler_kw=sched_kw, control=ctrl, page_size=page),
        clock=time.monotonic)
    reqs = build_requests(cfg.vocab_size, args.requests or 2 * args.batch,
                          args.prompt_len, args.gen, eos_id=args.eos_id,
                          seed=args.seed, shared_prefix=args.shared_prefix,
                          tenants=sorted(weights) or None)
    print(f"cluster: {n_prefill} prefill + {n_decode} decode workers "
          f"({args.cluster_bus} bus, {args.device}), {args.batch} slots each, "
          f"{len(reqs)} requests, prompt lens "
          f"{min(len(r.prompt) for r in reqs)}-"
          f"{max(len(r.prompt) for r in reqs)}, page={page}, "
          f"scheduler={args.scheduler}")
    killed = []

    def on_tick(r):
        if args.cluster_kill and not killed and \
                len(r.results) >= args.cluster_kill:
            victim = next((w for w, v in sorted(r.views.items())
                           if v.role == "decode"), None)
            if victim is not None:
                print(f"FAULT INJECTION: killing decode worker {victim} "
                      f"after {len(r.results)} results")
                killed.append(victim)
                r.kill_worker(victim)

    try:
        router.start()
        t0 = time.monotonic()
        results = router.run(reqs, on_tick=on_tick)
        elapsed = time.monotonic() - t0
        m = router.metrics(elapsed_s=elapsed)
        cm = router.cluster_metrics()
        print(m.report())
        print(f"cluster: replayed={cm['replayed_requests']} "
              f"restarts={cm['worker_restarts']} "
              f"handoff={cm['handoff_bytes']/1e6:.2f}MB "
              f"scale_events={len(cm['scale_events'])}")
        if args.drain:
            router.drain_all()
            deadline = time.monotonic() + 120
            while router.views and time.monotonic() < deadline:
                router.step()
            print(f"drained: {'clean' if not router.views else 'TIMED OUT'} "
                  f"({len(router.byes)} goodbyes)")
    finally:
        router.shutdown()
    parity_ok = None
    if args.cluster_verify:
        # one engine in this process, same seed and requests: the cluster's
        # tokens must equal its own
        if params is None:
            params = lm.init(cfg, seed=args.seed, device=args.device)
        ref = ContinuousBatchingEngine(params, cfg, ecfg_for("decode"))
        want, _ = ref.run([Request(rid=r.rid, prompt=r.prompt,
                                   max_new_tokens=r.max_new_tokens,
                                   eos_id=r.eos_id, tenant=r.tenant)
                           for r in reqs])
        parity_ok = len(results) == len(want) and all(
            a.rid == b.rid and list(a.tokens) == list(b.tokens)
            and a.finish_reason == b.finish_reason
            for a, b in zip(results, want))
        print(f"parity vs single engine: {'EXACT' if parity_ok else 'MISMATCH'}")
    payload = m.as_dict()
    payload["cluster"] = cm
    payload["topology"] = {"n_prefill": n_prefill, "n_decode": n_decode,
                           "bus": args.cluster_bus, "device": args.device,
                           "slots_per_worker": args.batch}
    if parity_ok is not None:
        payload["parity_ok"] = bool(parity_ok)
    if args.metrics_json:
        with open(args.metrics_json, "w") as f:
            json.dump(payload, f, indent=1, default=_json_default)
        print(f"wrote metrics to {args.metrics_json}")


def setup_model_parallel(cfg: ModelConfig, model_parallel: int, *,
                         seed: int = 0, device="cuda", params=None):
    """The serving layout of ``model_parallel`` ranks on the model axis over
    the world (``launch/mesh.serving_context``) and this rank's share of
    the parameters (``sharding.shard_leaves``: E/M leaves of each FFF site,
    the rest whole; ``params`` default ``lm.init(cfg, seed=seed)``, which
    every rank draws alike).
    Returns (layout, ctx, params): serve under ``with ctx():``.  With
    ``model_parallel`` 1: (None, nullcontext, params)."""
    if model_parallel > 1:
        mesh_lib.init_ranks()
    layout, ctx = mesh_lib.serving_context(model_parallel)
    if params is None:
        params = lm.init(cfg, seed=seed, device=device)
        print(f"{cfg.arch_id}: {lm.param_count(params)/1e6:.1f}M params")
    if layout is not None:
        params = sharding.shard_leaves(params, layout)
        print(f"layout: {layout.shape} (expert-parallel serving, "
              f"{mesh_lib.num_chips(layout)} ranks)")
    return layout, ctx, params


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    cfg = registry.get_config(args.arch, ffn=args.ffn)
    cfg = cfg.reduced(seq=max(64, args.prompt_len + args.gen + 1))
    if args.cluster is not None:
        run_cluster(args, cfg)
        return
    rank = mesh_lib.init_ranks()[0] if args.model_parallel > 1 else 0
    # every rank serves the same requests; rank 0 reports
    with (contextlib.redirect_stdout(io.StringIO()) if rank
          else contextlib.nullcontext()):
        _serve_main(args, cfg, rank)


def _serve_main(args, cfg: ModelConfig, rank: int) -> None:
    layout, ctx, params = setup_model_parallel(
        cfg, args.model_parallel, seed=args.seed, device=args.device)
    if args.engine == "off":
        with ctx():
            serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
                  gen=args.gen, fff_backend=args.fff_backend,
                  capacity_factor=args.capacity_factor,
                  overflow_policy=args.overflow_policy, eos_id=args.eos_id,
                  seed=args.seed, device=args.device, params=params)
        return
    weights = parse_tenant_weights(args.tenant_weights)
    sched_kw = ({"max_prefilling": args.max_prefilling}
                if args.max_prefilling > 0 else {})
    if weights and args.scheduler == "weighted_leaf_aware":
        sched_kw["weights"] = weights
    elif weights:
        # labels without enforcement: the metrics split per tenant, but
        # admission ignores the weights
        print(f"WARNING: --tenant-weights given but --scheduler is "
              f"{args.scheduler!r}: requests get tenant labels and "
              f"per-tenant metrics, but only weighted_leaf_aware enforces "
              f"the weights at admission")
    ecfg = EngineConfig(
        num_slots=args.batch, max_len=args.prompt_len + args.gen + 1,
        max_prompt_len=args.prompt_len, scheduler=args.scheduler,
        scheduler_kw=sched_kw, prefill_chunk=args.prefill_chunk,
        prefill_budget=args.prefill_budget, fff_backend=args.fff_backend,
        cuda_decode=args.cuda_decode, capacity_factor=args.capacity_factor,
        overflow_policy=args.overflow_policy, spec_k=args.spec_k,
        draft_config=args.draft_config or None, page_size=args.page_size,
        seed=args.seed, device=args.device)
    reqs = build_requests(cfg.vocab_size, args.requests or 2 * args.batch,
                          args.prompt_len, args.gen, eos_id=args.eos_id,
                          seed=args.seed, shared_prefix=args.shared_prefix,
                          tenants=sorted(weights) or None)
    with ctx():
        serve_engine(cfg, ecfg, reqs, params=params,
                     metrics_json="" if rank else args.metrics_json)


if __name__ == "__main__":
    main()
