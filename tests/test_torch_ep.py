"""``grouped_ep`` over ``torch.distributed`` against the JAX package's
``shard_map`` + ``all_to_all``, on the CPU.

One spawn of gloo ranks per rank count (2 and 4) runs every case: the model
group of 2 ranks, of 4 ranks, and a data group of 2 by a model group of 2.
The JAX package runs the same cases in a subprocess on 4 fake host devices
(``--xla_force_host_platform_device_count``), meshes of the same layout,
and writes its outputs to a ``.npz``; both sides read one input ``.npz``
drawn with numpy.  The routing is skewed so that leaves overflow:

* under "exact_dense" the port's ``grouped_ep`` equals the JAX
  ``reference`` backend (``kernel`` tolerance, float32);
* under "drop" and "master_leaf" its outputs, kept masks, leaf indices and
  overflow fractions equal JAX's sharded ``grouped_ep``;
* every rank returns the same global outputs, and ``auto`` resolves to
  ``grouped_ep`` under the groups.

Ranks meet through a ``file://`` rendezvous under ``tmp_path``, never a
fixed port, and each side of the run has a wall-clock limit of its own.
"""
import os
import pathlib
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

REPO = pathlib.Path(__file__).resolve().parent.parent
CFG = dict(dim_in=16, dim_out=12, depth=3, leaf_width=8, activation="gelu",
           trees=2, leaf_bias=False, master_leaf=True)
B, CF = 125, 1.25
POLICIES = ("exact_dense", "master_leaf", "drop")
#: layout -> (ranks, data shards G, model shards M)
LAYOUTS = {"model2": (2, 1, 2), "model4": (4, 1, 4), "data2_model2": (4, 2, 2)}
TORCH_LIMIT_S, JAX_LIMIT_S = 120, 240

JAX_CODE = textwrap.dedent("""
    import sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh
    from repro.core import api, fff, routing
    from repro.distributed import act, sharding

    d, cfg_kw, layouts, cf = sys.argv[1], eval(sys.argv[2]), eval(sys.argv[3]), float(sys.argv[4])
    cfg = fff.FFFConfig(**cfg_kw)
    npz = np.load(d + "/inputs.npz")
    params = {k[2:]: jnp.asarray(npz[k]) for k in npz.files if k.startswith("p/")}
    x = jnp.asarray(npz["x"])
    out = {}
    y, o = jax.jit(lambda p, x: api.apply(p, cfg, x, api.ExecutionSpec(
        mode="infer", backend="reference")))(params, x)
    out["reference/y"], out["reference/leaf_idx"] = np.asarray(y), np.asarray(o.leaf_idx)
    tree0 = {k: v[0] for k, v in params.items() if k.startswith("leaf_")}
    idx0 = o.leaf_idx[:, 0]
    for name, (_, G, M) in layouts.items():
        mesh = Mesh(np.array(jax.devices()[:G * M]).reshape(G, M), ("data", "model"))
        p_sh = sharding.shard_params(params, mesh, fsdp=False)
        with act.use_mesh(mesh, sharding.activation_rules(mesh)):
            for policy in ("exact_dense", "master_leaf", "drop"):
                y, o = jax.jit(lambda p, x: api.apply(p, cfg, x, api.ExecutionSpec(
                    mode="infer", backend="grouped_ep", capacity_factor=cf,
                    overflow_policy=policy)))(p_sh, x)
                out[f"{name}/{policy}/y"] = np.asarray(y)
                out[f"{name}/{policy}/leaf_idx"] = np.asarray(o.leaf_idx)
                out[f"{name}/{policy}/overflow"] = np.asarray(o.overflow_fraction)
            y, kept = jax.jit(lambda t, x, i: routing.grouped_leaf_apply_ep(
                x, i, t, cfg.activation, capacity_factor=cf, return_kept=True,
                overflow_policy="drop"))(tree0, x, idx0)
            out[f"{name}/direct/y"], out[f"{name}/direct/kept"] = np.asarray(y), np.asarray(kept)
    np.savez(d + "/jax.npz", **out)
""")


def _draw_inputs(path: pathlib.Path) -> None:
    """Parameters under the JAX package's keys and shapes, and tokens; the
    root and its right child lean right, so leaves 6 and 7 overflow."""
    from repro_torch.core import fff
    r = np.random.default_rng(0)
    shapes = {k: tuple(v.shape) for k, v in
              fff.init(torch.Generator().manual_seed(0), fff.FFFConfig(**CFG)).items()}
    arrays = {}
    for k, shp in shapes.items():
        fan_in = shp[-2] if len(shp) >= 2 and not k.startswith("node_b") else 1
        arrays["p/" + k] = (r.normal(size=shp) / np.sqrt(fan_in)).astype(np.float32)
    arrays["p/node_b2"][:, [0, 2]] += 1.5
    arrays["x"] = r.normal(size=(B, CFG["dim_in"])).astype(np.float32)
    np.savez(path / "inputs.npz", **arrays)


def _groups(rank: int, G: int, M: int):
    """(model group, data group) of ``rank`` in a G x M layout, data-major;
    every rank creates every group, in one order."""
    if G == 1:
        return dist.group.WORLD, None
    models = [dist.new_group([g * M + m for m in range(M)]) for g in range(G)]
    datas = [dist.new_group([g * M + m for g in range(G)]) for m in range(M)]
    return models[rank // M], datas[rank % M]


def _rank_main(rank: int, world: int, d: str) -> None:
    """One gloo rank: every layout of ``world`` ranks, every policy; writes
    its outputs to ``torch<world>_<rank>.npz``."""
    from repro_torch.core import api, fff, routing
    from repro_torch.distributed import act
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{d}/rendezvous{world}",
                            rank=rank, world_size=world)
    try:
        npz = np.load(f"{d}/inputs.npz")
        params = {k[2:]: torch.from_numpy(npz[k]) for k in npz.files
                  if k.startswith("p/")}
        x = torch.from_numpy(npz["x"])
        cfg = fff.FFFConfig(**CFG)
        tree0 = {k: v[0] for k, v in params.items() if k.startswith("leaf_")}
        idx0 = fff.route_hard(params, cfg, x)[:, 0]
        out = {}
        for name, (w, G, M) in LAYOUTS.items():
            if w != world:
                continue
            with act.use_groups(*_groups(rank, G, M)):
                out[f"{name}/auto"] = np.array(
                    api.resolve_backend(params, cfg, "infer", tuple(x.shape),
                                        x.device) == "grouped_ep")
                for policy in POLICIES:
                    y, o = api.apply(params, cfg, x, api.ExecutionSpec(
                        backend="grouped_ep", capacity_factor=CF,
                        overflow_policy=policy))
                    out[f"{name}/{policy}/y"] = y.numpy()
                    out[f"{name}/{policy}/leaf_idx"] = o.leaf_idx.numpy()
                    out[f"{name}/{policy}/overflow"] = o.overflow_fraction.numpy()
                y, kept = routing.grouped_leaf_apply_ep(
                    x, idx0, tree0, cfg.activation, capacity_factor=CF,
                    return_kept=True, overflow_policy="drop")
                out[f"{name}/direct/y"], out[f"{name}/direct/kept"] = y.numpy(), kept.numpy()
        np.savez(f"{d}/torch{world}_{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


class EPRun:
    """Starts the JAX subprocess at once; spawns the torch ranks of a rank
    count on first use; each side within its own time limit."""

    def __init__(self, d: pathlib.Path):
        self.d = d
        _draw_inputs(d)
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                             "--xla_cpu_multi_thread_eigen=false",
                   PYTHONPATH=str(REPO / "src"))
        self.jax_proc = subprocess.Popen(
            [sys.executable, "-c", JAX_CODE, str(d), repr(CFG), repr(LAYOUTS),
             str(CF)], env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        self._torch, self._jax = {}, None

    def jax(self) -> dict:
        if self._jax is None:
            try:
                _, err = self.jax_proc.communicate(timeout=JAX_LIMIT_S)
            except subprocess.TimeoutExpired:
                self.jax_proc.kill()
                pytest.fail(f"the JAX run took over {JAX_LIMIT_S} s")
            assert self.jax_proc.returncode == 0, err[-3000:]
            self._jax = dict(np.load(self.d / "jax.npz"))
        return self._jax

    def torch(self, world: int) -> list:
        """Each rank's outputs for ``world`` ranks."""
        if world not in self._torch:
            ctx = mp.start_processes(_rank_main, args=(world, str(self.d)),
                                     nprocs=world, join=False, start_method="spawn")
            deadline = time.monotonic() + TORCH_LIMIT_S
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    for p in ctx.processes:
                        p.kill()
                    pytest.fail(f"{world} gloo ranks took over {TORCH_LIMIT_S} s")
            self._torch[world] = [dict(np.load(self.d / f"torch{world}_{r}.npz"))
                                  for r in range(world)]
        return self._torch[world]

    def close(self) -> None:
        if self.jax_proc.poll() is None:
            self.jax_proc.kill()
            self.jax_proc.communicate()


@pytest.fixture(scope="module")
def ep(tmp_path_factory):
    run = EPRun(tmp_path_factory.mktemp("ep"))
    try:
        yield run
    finally:
        run.close()


def close(got, want):
    from conftest import dtype_tol
    import jax.numpy as jnp
    rtol, atol = dtype_tol(jnp.float32, "kernel")
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def port(ep, layout) -> dict:
    """Rank 0's outputs, after checking that every rank returned the same
    global outputs (the reassembling all_gather)."""
    ranks = ep.torch(LAYOUTS[layout][0])
    keys = [k for k in ranks[0] if k.startswith(layout + "/")]
    for other in ranks[1:]:
        for k in keys:
            np.testing.assert_array_equal(other[k], ranks[0][k], err_msg=k)
    return {k[len(layout) + 1:]: ranks[0][k] for k in keys}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_ep_exact_dense_equals_reference(ep, layout):
    t, j = port(ep, layout), ep.jax()
    assert bool(t["auto"])
    np.testing.assert_array_equal(t["exact_dense/leaf_idx"], j["reference/leaf_idx"])
    assert float(t["exact_dense/overflow"]) > 0.2      # the repair round ran
    close(t["exact_dense/y"], j["reference/y"])


@pytest.mark.parametrize("policy", ["drop", "master_leaf"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_ep_matches_jax_sharded(ep, layout, policy):
    t, j = port(ep, layout), ep.jax()
    np.testing.assert_array_equal(t[f"{policy}/leaf_idx"], j[f"{layout}/{policy}/leaf_idx"])
    assert float(t[f"{policy}/overflow"]) == pytest.approx(
        float(j[f"{layout}/{policy}/overflow"]), abs=1e-6)
    close(t[f"{policy}/y"], j[f"{layout}/{policy}/y"])
    kept = t["direct/kept"]
    np.testing.assert_array_equal(kept, j[f"{layout}/direct/kept"])
    assert kept.any() and not kept.all()
    close(t["direct/y"], j[f"{layout}/direct/y"])
