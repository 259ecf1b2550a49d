"""FFN sites (port of ``repro/nn/mlp.py``): the dispatch point for the
paper's technique.  ``FFNSpec.kind`` selects ``fff`` (the paper: FORWARD_T
or the straight-through estimator in training, with the hardening and
balance aux losses; the kernels at inference), ``dense`` (the vanilla FF
baseline, ``core/ff.py``: a native SwiGLU or GELU site) or ``moe`` (the
noisy top-k contender, ``core/moe.py``: the dense-combine ``forward`` with
its balancing loss as ``moe_aux`` in training, ``forward_sparse`` at
inference)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import FFNSpec
from repro_torch.core import api, ff, fff, moe

Params = dict


def make_fff_config(spec: FFNSpec, d_model: int, *, param_dtype, accum_dtype
                    ) -> fff.FFFConfig:
    return fff.FFFConfig(
        dim_in=d_model, dim_out=d_model, depth=spec.fff_depth,
        leaf_width=spec.fff_leaf_width, node_width=spec.fff_node_width,
        activation=spec.activation, trees=spec.fff_trees,
        hardening_scale=spec.hardening_scale, leaf_bias=False,
        st_training=spec.fff_st, master_leaf=spec.fff_master_leaf,
        master_width=spec.fff_master_width,
        param_dtype=param_dtype, accum_dtype=accum_dtype)


def make_moe_config(spec: FFNSpec, d_model: int, *, param_dtype, accum_dtype
                    ) -> moe.MoEConfig:
    return moe.MoEConfig(
        dim_in=d_model, dim_out=d_model, num_experts=spec.moe_experts,
        expert_width=spec.d_ff, top_k=spec.moe_top_k,
        activation="gelu" if spec.activation == "swiglu" else spec.activation,
        bias=False, param_dtype=param_dtype, accum_dtype=accum_dtype)


def make_ff_config(spec: FFNSpec, d_model: int, *, param_dtype, accum_dtype
                   ) -> ff.FFConfig:
    return ff.FFConfig(
        dim_in=d_model, dim_out=d_model, width=spec.d_ff,
        activation=spec.activation, bias=False,
        param_dtype=param_dtype, accum_dtype=accum_dtype)


def init(gen: torch.Generator, spec: FFNSpec, d_model: int, *, param_dtype,
         accum_dtype) -> Params:
    kw = dict(param_dtype=param_dtype, accum_dtype=accum_dtype)
    if spec.kind == "none":
        return {}
    if spec.kind == "dense":
        return ff.init(gen, make_ff_config(spec, d_model, **kw))
    if spec.kind == "fff":
        return fff.init(gen, make_fff_config(spec, d_model, **kw))
    if spec.kind == "moe":
        return moe.init(gen, make_moe_config(spec, d_model, **kw))
    raise ValueError(f"unknown ffn kind {spec.kind!r}")


def forward(params: Params, spec: FFNSpec, d_model: int, x: torch.Tensor, *,
            param_dtype, accum_dtype, train: bool = False,
            gen: Optional[torch.Generator] = None,
            valid: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, dict]:
    """x (..., D) -> (..., D), aux.  In training, aux is the JAX package's
    {'hardening', 'moe_aux', 'balance'} (float32 scalars; zeros for a dense
    site); at inference it holds 'routing' (RoutingStats) for an FFF site
    when an ``api.collect_routing`` tap is active, else nothing (the
    serving path allocates no zero scalars).
    ``gen`` drives the stochastic training feature (ExecutionSpec.rng; a
    MoE site's gating noise);
    ``valid`` marks phantom tokens for the FFF dispatch
    (ExecutionSpec.valid)."""
    aux = {}
    if train:
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        aux = {"hardening": zero, "moe_aux": zero, "balance": zero}
    kw = dict(param_dtype=param_dtype, accum_dtype=accum_dtype)
    if spec.kind == "none":
        return x, aux
    if spec.kind == "dense":
        return ff.forward(params, make_ff_config(spec, d_model, **kw), x), aux
    if spec.kind == "moe":
        cfg = make_moe_config(spec, d_model, **kw)
        if not train:
            return moe.forward_sparse(params, cfg, x)[0], aux
        y, moe_aux = moe.forward(params, cfg, x, gen=gen, train=True)
        aux["moe_aux"] = moe_aux["aux_loss"].float()
        return y, aux
    if spec.kind != "fff":
        raise ValueError(f"unknown ffn kind {spec.kind!r}")
    cfg = make_fff_config(spec, d_model, **kw)
    # one entry point; backend="auto" picks the execution strategy per site
    # (and the launch layer can steer it with api.overrides)
    y, out = api.apply(params, cfg, x, api.ExecutionSpec(
        mode="train" if train else "infer", rng=gen, valid=valid))
    if train:
        aux["hardening"] = (spec.hardening_scale
                            * fff.hardening_loss(out.node_probs)).float()
        # the soft node_probs exist in both the FORWARD_T and ST train paths
        if spec.balance_scale:
            aux["balance"] = (spec.balance_scale
                              * fff.balance_loss(out.node_probs, cfg.depth)).float()
    elif api.routing_enabled():
        aux["routing"] = api.routing_stats_from(out, cfg)
    return y, aux
