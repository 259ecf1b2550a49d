"""Dry run of every (arch x shape x production layout) cell, with no
process and no memory (port of ``repro/launch/dryrun.py``).

The JAX package lowers and compiles each cell over 512 placeholder
devices and reads the per-device footprint, FLOPs and collectives off the
compiled module.  The port computes the same record from its own rules:

* parameters from ``lm.init(cfg, device="meta")`` (shapes and dtypes, no
  storage; the draws do no work);
* per-rank bytes of the parameters, their gradients and AdamW moments
  (train; the moments always fully sharded, as JAX's) and the caches
  (prefill, decode) from ``distributed/sharding``'s rules over
  ``launch/mesh.make_production_mesh``, the (16, 16) (data, model) layout
  or the (2, 16, 16) (pod, data, model) one, whose rank arithmetic needs
  no process;
* FLOPs a rank from ``torch.utils.flop_counter.FlopCounterMode`` over one
  period of the stack on meta tensors at the per-rank batch (forward and
  backward in training), times ``n_periods`` (and ``grad_accum``), plus
  the embedding and head.  Each rank computes its whole batch through the
  whole model: the port gathers sharded tensors whole before a layer runs
  (``sharding.gathered``) instead of computing on shards.  An FFN site
  whose dispatch depends on the data (FFF inference, straight-through FFF
  training and the MoE, whose sorts, counts and live-expert loops cannot
  run on meta tensors) is counted by formula instead and listed in the
  record's ``ffn_analytic``; a recurrent mixer (Mamba, xLSTM), whose cost
  is linear in the sequence and whose step loop is slow on meta tensors,
  is counted at ``RECURRENT_PROBE`` tokens and scaled;
* HBM bytes a rank as the least a step must move: the whole parameters
  once per pass (three passes in training: forward, backward, update) and
  the caches once; activations are not counted;
* collectives from the placements (``roofline.CollectiveStats``).

``fits_h100_80g`` replaces JAX's ``fits_v5e_16g``: parameters, gradients,
moments and caches a rank against 80 GiB (activations not counted).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch internlm2-20b \\
      --shape train_4k --multi-pod both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dryrun.json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
from typing import Any

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import utils
from repro_torch.configs import SHAPES, registry, shape_applicable
from repro_torch.configs.base import BlockSpec, FFNSpec, ModelConfig, ShapeSpec
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import roofline, specs
from repro_torch.models import lm
from repro_torch.nn import mlp, transformer

META = specs.META
#: tokens a recurrent mixer is counted at before scaling to the sequence
RECURRENT_PROBE = 256
#: a rank's device memory (H100 80GB)
H100_BYTES = 80 * 1024 ** 3
NO_FFN = FFNSpec(kind="none")


def _layout(multi_pod: bool):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    return mesh_lib.make_production_mesh(multi_pod=multi_pod,
                                         world=math.prod(shape))


def _data_ranks(layout) -> int:
    return math.prod(layout.shape[a] for a in mesh_lib.data_axes(layout))


def _rank_batch(layout, batch: int) -> int:
    """The batch a rank holds: split over the data ranks when it divides
    them, else whole (long-context decode at batch 1 is replicated)."""
    n = _data_ranks(layout)
    return batch // n if batch % n == 0 and batch >= n else batch


def _at(tree, path: str):
    """The node of ``tree`` at a ``utils.tree_map_with_paths`` path."""
    for part in path.split("/") if path else ():
        if isinstance(tree, dict):
            tree = tree[part]
        elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
            tree = getattr(tree, part)
        else:
            tree = tree[int(part)]
    return tree


def placed(tree, spec_tree) -> list[tuple[torch.Tensor, tuple]]:
    """(tensor, spec) pairs of ``tree``'s tensors, each spec read from the
    spec tree at the tensor's path (``param_specs``, ``cache_specs``)."""
    return [(t, _at(spec_tree, p)) for p, t in utils.tree_leaves_with_paths(tree)
            if isinstance(t, torch.Tensor)]


def _local_bytes(pairs, layout) -> int:
    """Bytes of a rank's slices of the (tensor, spec) pairs."""
    return sum(math.prod(sharding.local_shape(sharding.Placement(
        spec, tuple(t.shape)), layout)) * t.element_size() for t, spec in pairs)


# ---------------------------------------------------------------------------
# collectives from the placements
# ---------------------------------------------------------------------------

def _crosses_node(layout, axis: str) -> bool:
    ranks = layout.axis_ranks(axis, 0)
    return min(ranks) // roofline.NODE_GPUS != max(ranks) // roofline.NODE_GPUS


def placement_collectives(pairs, layout, train: bool
                          ) -> list[roofline.CollectiveStats]:
    """What a step moves for the parameters: ``sharding.gathered``'s
    all-gathers of every sharded tensor (a pass), in training its
    backward's all-reduces over the data axes and ``reduce_gradients``'
    all-reduces over the data axes the tensor is not sharded on."""
    data = mesh_lib.data_axes(layout)
    out: dict[tuple, roofline.CollectiveStats] = {}

    def add(op, shape, elem, axis):
        key = (op, math.prod(shape) * elem, layout.shape[axis],
               _crosses_node(layout, axis))
        if key in out:
            out[key].count += 1
        else:
            out[key] = roofline.CollectiveStats(*key)

    for t, spec in pairs:
        pl = sharding.Placement(spec, tuple(t.shape))
        local = list(sharding.local_shape(pl, layout))
        steps = [(dim, a) for dim, entry in enumerate(spec)
                 for a in reversed(sharding._axes(entry))]
        shapes = []
        cur = list(local)
        for dim, axis in steps:
            cur[dim] *= layout.shape[axis]
            shapes.append(list(cur))
            add("all-gather", cur, t.element_size(), axis)
        if not train:
            continue
        for (dim, axis), shape in zip(reversed(steps), reversed(shapes)):
            if axis in data:
                add("all-reduce", shape, t.element_size(), axis)
        covered = sharding._covered(pl)
        for axis in data:
            if axis not in covered:
                add("all-reduce", local, t.element_size(), axis)
    return list(out.values())


# ---------------------------------------------------------------------------
# FLOPs: one period on meta tensors, FFN sites by formula where they must be
# ---------------------------------------------------------------------------

def _counted_ffn(f: FFNSpec, mode: str) -> bool:
    """Whether an FFN site runs on meta tensors: dense sites, and FORWARD_T
    FFF training (einsums over every leaf)."""
    return f.kind == "dense" or (f.kind == "fff" and mode == "train"
                                 and not f.fff_st)


def ffn_formula_flops(f: FFNSpec, d: int, tokens: int, mode: str) -> float:
    """FLOPs of an FFN site whose dispatch depends on the data, forward
    (and backward, 3x, in training): an FFF descends ``depth`` node
    hyperplanes a tree (straight-through training computes every node's
    logit) and runs one leaf a tree; a MoE gates over every expert and
    runs its top k (in training every expert, the dense combine)."""
    kk = 3 if f.activation == "swiglu" else 2
    if f.kind == "fff":
        nodes = (2 ** f.fff_depth - 1) if mode == "train" else f.fff_depth
        per = f.fff_trees * (2 * d * nodes * f.fff_node_width
                             + kk * 2 * d * f.fff_leaf_width)
        if f.fff_master_leaf:
            per += kk * 2 * d * (f.fff_master_width or f.fff_leaf_width)
    elif f.kind == "moe":
        experts = f.moe_experts if mode == "train" else f.moe_top_k
        per = 2 * d * f.moe_experts * (2 if mode == "train" else 1) \
            + experts * 2 * 2 * d * f.d_ff
    else:
        return 0.0
    return per * tokens * (3.0 if mode == "train" else 1.0)


def _grad_leaves(tree):
    return [t for t in utils.tree_leaves(tree)
            if isinstance(t, torch.Tensor) and t.is_floating_point()]


def _requiring_grad(tree):
    return utils.tree_map(
        lambda t: (t.detach().requires_grad_() if isinstance(t, torch.Tensor)
                   and t.is_floating_point() else t), tree)


def _count(fn) -> float:
    with FlopCounterMode(display=False) as fc:
        fn()
    return float(fc.get_total_flops())


def _block_flops(cfg: ModelConfig, spec: BlockSpec, mode: str, B: int, S: int,
                 cache_len: int, causal: bool, enc_len: int) -> float:
    """FLOPs of one block without its FFN site at (B, S) tokens: forward,
    and backward to its inputs and parameters in training."""
    cfg1 = dataclasses.replace(cfg, n_layers=1, period=(spec,))
    bspec = dataclasses.replace(spec, ffn=NO_FFN)
    params = transformer.block_init(utils.generator(META), cfg1, bspec,
                                    causal=causal)
    x = specs.struct((B, S, cfg.d_model), cfg.accum_dtype)
    enc = (specs.struct((B, enc_len, cfg.d_model), cfg.accum_dtype)
           if spec.cross_attention else None)
    if mode == "train":
        params, x = _requiring_grad(params), x.requires_grad_()

        def run():
            y, _, _ = transformer.block_forward(params, cfg1, bspec, x,
                                                mode="train", enc_out=enc,
                                                causal=causal)
            torch.autograd.grad(y.float().sum(), [x] + _grad_leaves(params))
        return _count(run)
    cache = transformer.init_block_cache(cfg1, bspec, B, cache_len,
                                         cfg.param_dtype, enc_len=enc_len,
                                         device=META)
    return _count(lambda: transformer.block_forward(
        params, cfg1, bspec, x, mode=mode, cache=cache, enc_out=enc,
        causal=causal))


def _ffn_flops(cfg: ModelConfig, f: FFNSpec, mode: str, B: int, S: int) -> float:
    kw = dict(param_dtype=cfg.param_dtype, accum_dtype=cfg.accum_dtype)
    params = mlp.init(utils.generator(META), f, cfg.d_model, **kw)
    x = specs.struct((B, S, cfg.d_model), cfg.accum_dtype)
    if mode == "train":
        params, x = _requiring_grad(params), x.requires_grad_()

        def run():
            y, aux = mlp.forward(params, f, cfg.d_model, x, train=True, **kw)
            loss = y.float().sum() + aux["hardening"] + aux["balance"]
            torch.autograd.grad(loss, [x] + _grad_leaves(params))
        return _count(run)
    return _count(lambda: mlp.forward(params, f, cfg.d_model, x, **kw))


def _period_flops(cfg: ModelConfig, period, mode: str, B: int, S: int,
                  cache_len: int, causal: bool, enc_len: int, rec: dict) -> float:
    total = 0.0
    for spec in period:
        if spec.mixer == "attn":
            total += _block_flops(cfg, spec, mode, B, S, cache_len, causal, enc_len)
        else:
            probe = min(S, RECURRENT_PROBE)
            total += _block_flops(cfg, spec, mode, B, probe, cache_len, causal,
                                  enc_len) * S / probe
            rec["recurrent_scaled_from"] = probe
        f = spec.ffn
        if f.kind == "none":
            continue
        if _counted_ffn(f, mode):
            total += _ffn_flops(cfg, f, mode, B, S)
        else:
            total += ffn_formula_flops(f, cfg.d_model, B * S, mode)
            rec.setdefault("ffn_analytic", sorted({f.kind}))
    return total


def _ends_flops(cfg: ModelConfig, mode: str, B: int, S: int) -> float:
    """The embedding and head (and the loss, forward and backward, in
    training); at inference the head runs on the last position."""
    cfg1 = dataclasses.replace(cfg, n_layers=len(cfg.period))
    params = {k: v for k, v in lm.init(cfg1, device=META).items()
              if k not in ("stack", "enc_stack")}
    batch = specs._token_batch(cfg, B, S, mode == "train") \
        if mode != "decode" else {"tokens": specs.struct((B, 1), torch.int32)}
    y = specs.struct((B, S, cfg.d_model), cfg.accum_dtype)
    if mode == "train":
        params, y = _requiring_grad(params), y.requires_grad_()

        def run():
            x0 = lm._embed_inputs(params, cfg, batch)
            lg = lm._head(params, cfg, x0 * 0.5 + y)
            loss = lm.cross_entropy(lg, batch["labels"])[0]
            torch.autograd.grad(loss, [y] + _grad_leaves(params),
                                allow_unused=True)
        return _count(run)
    return _count(lambda: lm._head(params, cfg, lm._embed_inputs(params, cfg, batch)
                                   * 0.5 + y[:, -1:, :]))


def cost_model(cfg: ModelConfig, shape: ShapeSpec, layout) -> dict:
    """A rank's FLOPs for one step: one micro-batch through one period of
    the stack (and of whisper's encoder) times the periods and micro-steps,
    plus the ends."""
    accum = cfg.grad_accum if shape.mode == "train" else 1
    B = _rank_batch(layout, shape.global_batch // accum)
    S = shape.seq_len if shape.mode != "decode" else 1
    rec: dict[str, Any] = {"rank_batch": B}
    enc_len = cfg.encoder.seq_len if cfg.encoder is not None else 0
    flops = _period_flops(cfg, cfg.period, shape.mode, B, S, shape.seq_len,
                          True, enc_len, rec) * cfg.n_periods * accum
    if cfg.encoder is not None and shape.mode != "decode":
        # the encoder runs in train mode, as in the JAX package
        emode = "train" if shape.mode == "train" else "eval"
        n_enc = cfg.encoder.n_layers // len(cfg.encoder.period)
        flops += _period_flops(cfg, cfg.encoder.period, emode, B, enc_len, 0,
                               False, 0, rec) * n_enc * accum
    flops += _ends_flops(cfg, shape.mode, B, S) * accum
    rec["flops"] = flops
    return rec


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------

def lower_cell(arch: str, shape_name: str, *, multi_pod: bool,
               ffn: str = "fff") -> dict:
    """One cell's dry-run and roofline record."""
    cfg = registry.get_config(arch, ffn=ffn)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    rec: dict[str, Any] = {
        "arch": arch, "shape": shape_name, "ffn": ffn,
        "mesh": "2x16x16" if multi_pod else "16x16",
    }
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = why
        return rec
    layout = _layout(multi_pod)
    chips = mesh_lib.num_chips(layout)
    params = lm.init(cfg, device=META)
    total_params = utils.tree_size(params)
    embed_params = utils.tree_size(params["embed"])
    p_pairs = placed(params, sharding.param_specs(params, layout,
                                                  fsdp=cfg.zero_stage >= 3))
    param_b = _local_bytes(p_pairs, layout)
    rec["param_bytes_per_rank"] = param_b
    train = shape.mode == "train"
    if train:
        moments = placed(params, sharding.param_specs(params, layout, fsdp=True))
        rec["grad_bytes_per_rank"] = param_b
        rec["opt_bytes_per_rank"] = 2 * _local_bytes(
            [(t.to(torch.float32), spec) for t, spec in moments], layout)
        cache_b = 0
    else:
        if shape.mode == "prefill":
            caches = lm.init_caches(cfg, shape.global_batch, shape.seq_len,
                                    dtype=cfg.param_dtype, device=META)
        else:
            _, caches, _ = specs.decode_specs(cfg, shape)
        cache_b = _local_bytes(placed(caches, sharding.cache_specs(
            caches, layout, shape.global_batch)), layout)
        rec["cache_bytes_per_rank"] = cache_b
    rec["bytes_per_rank"] = (param_b + cache_b + rec.get("grad_bytes_per_rank", 0)
                             + rec.get("opt_bytes_per_rank", 0))
    rec["fits_h100_80g"] = bool(rec["bytes_per_rank"] < H100_BYTES)

    cm = cost_model(cfg, shape, layout)
    accum = cfg.grad_accum if train else 1
    whole_params = utils.tree_bytes(params)
    hbm = whole_params * (3 if train else 1) * accum + cache_b
    colls = [(c, accum) for c in placement_collectives(p_pairs, layout, train)]
    mf = roofline.model_flops(cfg, shape, total_params, embed_params)
    terms = roofline.analyze_terms(cm["flops"], hbm, colls, chips, mf)
    rec.update({
        "status": "ok",
        "total_params": total_params,
        "active_params": roofline.param_counts(cfg, total_params)[1],
        "rank_batch": cm["rank_batch"],
        "flops_per_rank": terms.flops,
        "hbm_bytes_per_rank": terms.bytes_hbm,
        "nvlink_bytes_per_rank": terms.bytes_nvlink,
        "ib_bytes_per_rank": terms.bytes_ib,
        "t_compute_s": terms.t_compute,
        "t_memory_s": terms.t_memory,
        "t_collective_s": terms.t_collective,
        "dominant": terms.dominant,
        "model_flops": mf,
        "useful_ratio": terms.useful_ratio,
        "roofline_fraction": terms.roofline_fraction,
        "n_collectives": sum(c.count * m for c, m in colls),
    })
    for k in ("ffn_analytic", "recurrent_scaled_from"):
        if k in cm:
            rec[k] = cm[k]
    return rec


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, choices=list(registry.ARCH_IDS))
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--ffn", default="fff", choices=["fff", "native", "dense"])
    ap.add_argument("--multi-pod", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    archs = list(registry.ARCH_IDS) if (args.all or args.arch is None) \
        else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[
        args.multi_pod]

    records = []
    for arch in archs:
        for shape_name in shapes:
            for mp in meshes:
                t0 = time.time()
                try:
                    rec = lower_cell(arch, shape_name, multi_pod=mp,
                                     ffn=args.ffn)
                except Exception as e:            # noqa: BLE001
                    rec = {"arch": arch, "shape": shape_name,
                           "mesh": "2x16x16" if mp else "16x16",
                           "status": "error",
                           "error": f"{type(e).__name__}: {e}"}
                    traceback.print_exc()
                rec["wall_s"] = round(time.time() - t0, 1)
                records.append(rec)
                status = rec.get("status")
                extra = ""
                if status == "ok":
                    extra = (f" bytes/rank={utils.human_bytes(rec['bytes_per_rank'])}"
                             f" dominant={rec['dominant']}"
                             f" roofline={rec['roofline_fraction']:.3f}")
                elif status == "skipped":
                    extra = f" ({rec['reason']})"
                print(f"[{rec['mesh']:8s}] {arch:24s} {shape_name:12s} "
                      f"{status}{extra}", flush=True)
                if args.out:
                    with open(args.out, "w") as f:
                        json.dump(records, f, indent=1)
    n_ok = sum(r.get("status") == "ok" for r in records)
    n_skip = sum(r.get("status") == "skipped" for r in records)
    n_err = len(records) - n_ok - n_skip
    print(f"\ndry-run: {n_ok} ok, {n_skip} skipped, {n_err} errors "
          f"/ {len(records)} cells")
    if n_err:
        raise SystemExit(1)
    return records


if __name__ == "__main__":
    main()
