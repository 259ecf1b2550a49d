"""The port's training substrates against the JAX package's, on the CPU.

* The fault supervisor and the straggler policy: every case of
  ``tests/test_fault.py`` and the supervisor and straggler cases of
  ``tests/test_substrates.py``, on torch states; and against the JAX
  package's on the same random step-time streams and the same random
  failure, ejection and resume schedules (outcome, steps run, sleeps and
  checkpoints alike).
* ``launch.train.train`` with a checkpoint directory on a reduced config:
  a run with an injected failure equals an uninterrupted run (losses and
  final parameters bit for bit), also with ``transposition_prob=0.1``
  drawing from each step's generator, and replays the steps JAX's
  supervisor replays; the command line in a child process killed with
  SIGKILL after step 4 and run again resumes at step 3 and ends in the
  uninterrupted run's state.
* The dense FFN baseline: ``core/ff.forward`` against JAX ``ff.forward``
  (relu, gelu, silu, swiglu, with and without bias; the ``kernel``
  tolerance), and the reduced ``native`` LM's ``loss_fn``, every gradient
  and ``generate`` against JAX (``e2e``), both drivers with ``--ffn
  native|dense``.
* ``core/regions`` on the same parameters as JAX's; ``data/synthetic`` and
  ``epoch_batches`` exactly equal; the ``Prefetcher``.
"""
import dataclasses
import json
import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import dtype_tol
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs import registry as jregistry
from repro.core import ff as jff
from repro.core import fff as jfff
from repro.core import regions as jregions
from repro.data import pipeline as jpipeline
from repro.data import synthetic as jsynthetic
from repro.distributed import fault as jfault
from repro.distributed import straggler as jstraggler
from repro.models import lm as jlm
from repro_torch import checkpoint, optim, utils, weights
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import registry
from repro_torch.core import ff, fff, regions
from repro_torch.data import pipeline, synthetic
from repro_torch.distributed import fault, straggler
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import train as train_mod
from repro_torch.models import lm
from repro_torch.nn import mlp

torch.set_num_threads(2)

BATCH, SEQ = 2, 16


def rng(seed):
    return np.random.default_rng(seed)


def t(a):
    return weights.tensor(np.asarray(a), device="cpu")


def close(got, want, kind="e2e", dtype=jnp.float32):
    rtol, atol = dtype_tol(dtype, kind)
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol, atol=atol)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# RestartBackoff and TrainSupervisor (tests/test_fault.py, on torch states)
# ---------------------------------------------------------------------------

def test_backoff_exponential_then_exhausted():
    b = fault.RestartBackoff(max_restarts=3, base=0.5, factor=2.0)
    assert [b.next_delay() for _ in range(5)] == [0.5, 1.0, 2.0, None, None]
    b.reset()
    assert b.next_delay() == 0.5


def test_backoff_zero_base_disables_sleeps():
    b = fault.RestartBackoff(max_restarts=2, base=0.0)
    assert [b.next_delay() for _ in range(3)] == [0.0, 0.0, None]


def _step(state, step):
    # deterministic given (state, step): the supervisor's replay contract
    return {"x": state["x"] + step + 1}


def _plain(num_steps):
    state = {"x": torch.zeros((), dtype=torch.float64)}
    for s in range(num_steps):
        state = _step(state, s)
    return float(state["x"])


def _x0():
    return {"x": torch.zeros((), dtype=torch.float64)}


def test_supervisor_clean_run_matches_plain_loop(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    out = fault.TrainSupervisor(mgr, fault.SupervisorConfig(ckpt_every=4)).run(
        _x0(), _step, 10)
    assert (out.step, out.restarts, out.ejections) == (10, 0, 0)
    assert float(out.state["x"]) == _plain(10)
    assert mgr.steps() == [4, 8, 10][-mgr.keep:]


@pytest.mark.parametrize("async_save", [False, True])
def test_supervisor_recovers_from_injected_failure(tmp_path, async_save):
    mgr = CheckpointManager(str(tmp_path), async_save=async_save)
    sleeps = []
    sup = fault.TrainSupervisor(
        mgr, fault.SupervisorConfig(ckpt_every=2, max_restarts=3,
                                    backoff_base=0.25, backoff_factor=2.0),
        sleep_fn=sleeps.append)
    tripped = []

    def hook(step):
        if step == 5 and not tripped:
            tripped.append(step)
            return True
        return False

    out = sup.run(_x0(), _step, 10, failure_hook=hook)
    assert out.restarts == 1 and sleeps == [0.25]
    assert float(out.state["x"]) == _plain(10)


def test_supervisor_restart_budget_exhausts(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    sup = fault.TrainSupervisor(mgr, fault.SupervisorConfig(ckpt_every=2,
                                                            max_restarts=2))
    with pytest.raises(RuntimeError, match="exceeded 2 restarts"):
        sup.run(_x0(), _step, 10, failure_hook=lambda step: step == 3)


def test_supervisor_resumes_from_existing_checkpoint(tmp_path):
    cfg = fault.SupervisorConfig(ckpt_every=4)
    first = fault.TrainSupervisor(CheckpointManager(str(tmp_path), async_save=False),
                                  cfg).run(_x0(), _step, 8)
    out = fault.TrainSupervisor(CheckpointManager(str(tmp_path), async_save=False),
                                cfg).run(_x0(), _step, 12)
    assert out.step == 12 and float(out.state["x"]) == _plain(12)
    assert float(first.state["x"]) == _plain(8)


def test_supervisor_straggler_ejection_raises_remesh(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    sup = fault.TrainSupervisor(mgr, fault.SupervisorConfig(ckpt_every=100))
    with pytest.raises(fault.ElasticRemesh) as exc:
        sup.run(_x0(), _step, 10, straggler_hook=lambda s: [1] if s == 6 else None)
    assert exc.value.surviving_hosts == [1]
    assert mgr.latest_step() == 6          # the blocking pre-ejection save


def _state():
    return {"params": {"w": torch.arange(12.0).reshape(3, 4),
                       "b": torch.ones(4, dtype=torch.bfloat16)},
            "step": torch.zeros((), dtype=torch.int32)}


def test_supervisor_restarts_from_checkpoint(tmp_path):
    """tests/test_substrates.py's case: every leaf + 1 a step, one failure."""
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=False)
    sup = fault.TrainSupervisor(mgr, fault.SupervisorConfig(ckpt_every=2,
                                                            max_restarts=3))
    fail_at = {5}

    def failure(i):
        if i in fail_at:
            fail_at.discard(i)
            return True
        return False

    res = sup.run(_state(), lambda s, i: utils.tree_map(lambda x: x + 1, s), 8,
                  failure_hook=failure)
    assert res.step == 8 and res.restarts == 1
    assert float(res.state["params"]["w"][0, 0]) == 8.0
    assert res.state["params"]["b"].dtype == torch.bfloat16


def test_supervisor_gives_up_after_max_restarts(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=1, async_save=False)
    sup = fault.TrainSupervisor(mgr, fault.SupervisorConfig(ckpt_every=100,
                                                            max_restarts=2))
    with pytest.raises(RuntimeError, match="restarts"):
        sup.run(_state(), lambda s, i: s, 5, failure_hook=lambda i: True)


# ---------------------------------------------------------------------------
# straggler escalation (tests/test_fault.py, tests/test_substrates.py)
# ---------------------------------------------------------------------------

def test_straggler_policy_escalates_to_eject():
    cfg = straggler.StragglerConfig(window=16, slow_factor=1.5, eject_after=3,
                                    min_history=4)
    policy = straggler.MitigationPolicy(straggler.StepTimeTracker(3, cfg))
    decisions = [policy.step([1.0, 1.0, 4.0]).action for _ in range(10)]
    assert decisions[-1] == "eject" and "warn" in decisions
    assert policy.tracker.to_eject() == [2]


def test_straggler_flags_reset_on_recovery():
    cfg = straggler.StragglerConfig(window=8, slow_factor=1.5, eject_after=50,
                                    min_history=2)
    tracker = straggler.StepTimeTracker(2, cfg)
    policy = straggler.MitigationPolicy(tracker)
    for _ in range(4):
        policy.step([1.0, 4.0])
    assert tracker.flagged_streak[1] > 0
    for _ in range(8):
        policy.step([1.0, 1.0])
    assert tracker.flagged_streak[1] == 0


def test_straggler_escalation_ladder():
    cfg = straggler.StragglerConfig(window=40, slow_factor=1.5, eject_after=5,
                                    min_history=5)
    pol = straggler.MitigationPolicy(straggler.StepTimeTracker(4, cfg))
    actions = [pol.step([1.0, 1.0, 1.0, 2.5]).action for _ in range(15)]
    assert "warn" in actions and actions[-1] == "eject"
    pol2 = straggler.MitigationPolicy(straggler.StepTimeTracker(2, cfg))
    for i in range(30):
        dec = pol2.step([1.0, 2.5 if i < 7 else 1.0])
    assert dec.action == "none"


# ---------------------------------------------------------------------------
# the supervisor and the straggler policy against the JAX package's
# ---------------------------------------------------------------------------

def _time_streams(seed):
    """Per-host step times (a shared drift, host noise, slow stretches on
    random hosts) and a random StragglerConfig."""
    r = rng(seed)
    hosts, steps = int(r.integers(2, 7)), 80
    times = (np.exp(r.normal(0, 0.05, (steps, 1)))
             * np.exp(r.normal(0, 0.1, (steps, hosts))))
    for _ in range(int(r.integers(1, 4))):
        h, a = int(r.integers(hosts)), int(r.integers(steps))
        times[a:a + int(r.integers(10, 50)), h] *= float(r.uniform(1.5, 4.0))
    window = int(r.integers(4, 32))
    cfg = dict(window=window, slow_factor=float(r.uniform(1.1, 2.0)),
               eject_after=int(r.integers(1, 20)),
               min_history=int(r.integers(1, window + 1)))
    return times.tolist(), cfg


@pytest.mark.parametrize("seed", range(8))
def test_mitigation_policy_matches_jax(seed):
    """The same random per-host step times through JAX's policy and the
    port's: the same action and hosts, streaks and medians at every step."""
    times, cfg = _time_streams(seed)
    hosts = len(times[0])
    jpol = jstraggler.MitigationPolicy(jstraggler.StepTimeTracker(
        hosts, jstraggler.StragglerConfig(**cfg)))
    pol = straggler.MitigationPolicy(straggler.StepTimeTracker(
        hosts, straggler.StragglerConfig(**cfg)))
    actions = set()
    for i, row in enumerate(times):
        want, got = jpol.step(row), pol.step(row)
        assert (got.action, got.hosts) == (want.action, want.hosts), i
        np.testing.assert_array_equal(pol.tracker.flagged_streak, jpol.tracker.flagged_streak)
        assert pol.tracker.global_p50() == jpol.tracker.global_p50()
        assert [pol.tracker.host_p50(h) for h in range(hosts)] == \
            [jpol.tracker.host_p50(h) for h in range(hosts)]
        actions.add(got.action)
    assert actions - {"none"}, "the stream never flagged a host"


def _schedule(seed):
    """A supervised run: steps, config and manager, failures (a step may
    fail more than once) and an ejection drawn from ``seed``; sleeps,
    async saves and an earlier run to resume from on a share of seeds."""
    r = rng(100 + seed)
    n = int(r.integers(4, 14))
    fails = {}
    for s in r.integers(0, n, int(r.integers(0, 4))):
        fails[int(s)] = fails.get(int(s), 0) + int(r.integers(1, 3))
    return dict(
        steps=n, fails=fails,
        eject={int(r.integers(1, n + 1)): [int(h) for h in r.choice(4, 2, replace=False)]}
        if r.random() < 0.3 else {},
        cfg=dict(ckpt_every=int(r.integers(1, 5)), max_restarts=int(r.integers(1, 5)),
                 backoff_base=0.25 * (seed % 3 == 1), backoff_factor=1.5 + seed % 2 / 2),
        keep=int(r.integers(1, 4)), async_save=seed % 2 == 0,
        resume_from=n // 2 if seed % 4 == 3 else None)


def _jax_step(s, i):
    return {"w": s["w"] * 0.5 + (i + 1), "b": s["b"] + jnp.bfloat16(i), "n": s["n"] + 1}


def _torch_step(s, i):
    return {"w": s["w"] * 0.5 + (i + 1), "b": s["b"] + i, "n": s["n"] + 1}


def _bits(tree):
    """A state's leaves as (dtype, shape, bytes), bf16 as its uint16 bits."""
    def one(x):
        if isinstance(x, torch.Tensor):
            x = x.view(torch.uint16) if x.dtype == torch.bfloat16 else x
            a = x.numpy()
        else:
            a = np.asarray(x)
            a = a.view(np.uint16) if a.dtype == jnp.bfloat16 else a
        return str(a.dtype), a.shape, a.tobytes()
    return {k: one(v) for k, v in tree.items()}


def _supervise(fault_mod, manager_cls, state, step_fn, root, sched, steps):
    """One supervised run: (outcome, step indices run, sleeps, committed
    steps).  The outcome is the end (step, restarts, ejections, the final
    state's bits), the ejection or the give-up."""
    calls, sleeps, left = [], [], dict(sched["fails"])
    mgr = manager_cls(str(root), keep=sched["keep"], async_save=sched["async_save"])
    sup = fault_mod.TrainSupervisor(mgr, fault_mod.SupervisorConfig(**sched["cfg"]),
                                    sleep_fn=sleeps.append)

    def failure(i):
        if left.get(i, 0):
            left[i] -= 1
            return True
        return False

    def step(s, i):
        calls.append(i)
        return step_fn(s, i)

    try:
        res = sup.run(state, step, steps, failure_hook=failure,
                      straggler_hook=lambda i: sched["eject"].get(i))
        out = ("done", res.step, res.restarts, res.ejections, _bits(res.state))
    except fault_mod.ElasticRemesh as e:
        out = ("remesh", e.surviving_hosts, str(e))
    except RuntimeError as e:
        out = ("gave up", str(e), str(e.__cause__))
    mgr.wait()
    return out, calls, sleeps, mgr.steps()


def _same_checkpoint(a, b):
    """Two checkpoint directories hold the same manifest and the same
    arrays, bit for bit."""
    ma, mb = (json.loads((d / "manifest.json").read_text()) for d in (a, b))
    assert ma == mb
    for shard in ma["shards"]:
        with np.load(a / shard) as za, np.load(b / shard) as zb:
            assert za.files == zb.files
            for k in za.files:
                assert za[k].dtype == zb[k].dtype
                np.testing.assert_array_equal(za[k], zb[k])


@pytest.mark.parametrize("seed", range(10))
def test_supervisor_matches_jax(tmp_path, seed):
    """JAX's TrainSupervisor and the port's over the same deterministic
    step, failure and ejection schedules (after an earlier run over the
    directory, for some): the same outcome (step, restarts, ejections and
    the final state bit for bit; or the same ejection or give-up), the
    same step indices run (so each replay starts where JAX's does), the
    same sleeps, the same committed checkpoints holding the same arrays."""
    sched = _schedule(seed)
    w0 = np.arange(12, dtype=np.float32).reshape(3, 4) / 4
    b0 = np.array([0.5, 1.0, 2.0, 3.0], np.float32)
    runs = {}
    for name, fault_mod, manager_cls, state, step_fn in (
            ("jax", jfault, JCheckpointManager,
             lambda: {"w": jnp.asarray(w0), "b": jnp.asarray(b0, jnp.bfloat16),
                      "n": jnp.zeros((), jnp.int32)}, _jax_step),
            ("port", fault, CheckpointManager,
             lambda: {"w": t(w0), "b": t(b0).to(torch.bfloat16),
                      "n": torch.zeros((), dtype=torch.int32)}, _torch_step)):
        root, run = tmp_path / name, []
        if sched["resume_from"] is not None:
            run.append(_supervise(fault_mod, manager_cls, state(), step_fn, root,
                                  dict(sched, fails={}, eject={}), sched["resume_from"]))
        run.append(_supervise(fault_mod, manager_cls, state(), step_fn, root, sched,
                              sched["steps"]))
        runs[name] = run
    assert runs["port"] == runs["jax"]
    for s in runs["port"][-1][-1]:
        _same_checkpoint(tmp_path / "port" / f"step_{s}", tmp_path / "jax" / f"step_{s}")

# ---------------------------------------------------------------------------
# the training driver under the supervisor
# ---------------------------------------------------------------------------

REPO = Path(__file__).resolve().parent.parent
ENV = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="2")
#: the command line in a child process (argv: transposition_prob, the
#: prefix of the line after which the child is held until it is killed
#: ("" never), then the driver's arguments)
HELD_CLI = """
import dataclasses, sys, threading
import torch
from repro_torch.launch import train
from repro_torch.nn import mlp
torch.set_num_threads(2)
prob, hold = float(sys.argv[1]), sys.argv[2]
if prob:
    make = mlp.make_fff_config
    mlp.make_fff_config = lambda *a, **kw: dataclasses.replace(
        make(*a, **kw), transposition_prob=prob)

class Held:
    def __init__(self, out):
        self.out, self.line = out, ""
    def write(self, s):
        self.out.write(s)
        self.out.flush()
        *done, self.line = (self.line + s).split("\\n")
        if hold and any(line.startswith(hold) for line in done):
            threading.Event().wait()
        return len(s)
    def flush(self):
        self.out.flush()

sys.stdout = Held(sys.stdout)
train.main(sys.argv[3:])
"""


@pytest.fixture(params=[0.0, 0.1], ids=["plain", "transposition"])
def transposition(request, monkeypatch):
    """Every FFF site built with this transposition_prob (the LM's configs
    carry none, so the test sets it where the sites are configured)."""
    make = mlp.make_fff_config
    monkeypatch.setattr(mlp, "make_fff_config", lambda *a, **kw: dataclasses.replace(
        make(*a, **kw), transposition_prob=request.param))
    return request.param


def _cfg():
    return registry.get_config("internlm2-20b").reduced()


def _run(log=lambda s: None, **kw):
    return train_mod.train(_cfg(), steps=6, batch=BATCH, seq=SEQ, seed=0,
                           device="cpu", log=log, **kw)


def _same_run(got, want, first=0):
    assert got.losses == want.losses[first:]
    assert all(torch.equal(a, b) for a, b in zip(utils.tree_leaves(got.params),
                                                 utils.tree_leaves(want.params)))


CLI_ARGS = ["--reduced", "--steps", "6", "--batch", str(BATCH), "--seq", str(SEQ),
            "--device", "cpu"]


def _cli(ckpt_dir, prob=0.0):
    """The command line over ``ckpt_dir`` in a fresh interpreter, to its
    end: its output lines."""
    out = subprocess.run([sys.executable, "-c", HELD_CLI, str(prob), "", *CLI_ARGS,
                          "--ckpt-dir", str(ckpt_dir), "--ckpt-every", "3"],
                         env=ENV, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()


def _cli_killed_after_step_4(ckpt_dir, prob=0.0):
    """The command line over ``ckpt_dir`` in a child process, held once it
    has printed its step-4 line (steps 5 on never start) and sent SIGKILL
    as soon as the step-3 checkpoint has committed."""
    child = subprocess.Popen([sys.executable, "-c", HELD_CLI, str(prob), "step    4 ",
                              *CLI_ARGS, "--ckpt-dir", str(ckpt_dir), "--ckpt-every", "3"],
                             env=ENV, cwd=REPO, stdout=subprocess.PIPE, text=True)
    try:
        lines = []
        for line in child.stdout:
            lines.append(line)
            if line.startswith("step    4 "):
                break
        assert lines and lines[-1].startswith("step    4 "), lines
        deadline = time.monotonic() + 120
        while not (ckpt_dir / "step_3" / "manifest.json").exists():
            assert child.poll() is None and time.monotonic() < deadline
            time.sleep(0.01)
        child.send_signal(signal.SIGKILL)
        assert child.wait(timeout=60) == -signal.SIGKILL
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
        child.stdout.close()
    assert CheckpointManager(str(ckpt_dir)).steps() == [3]


def _no_ms(line):
    """A step line without its time."""
    return re.sub(r"\s+[\d.]+ms$", "", line)


def test_train_with_an_injected_failure_equals_an_uninterrupted_run(tmp_path, transposition):
    full = _run()
    tripped = []

    def hook(i):
        if i == 4 and not tripped:
            tripped.append(i)
            return True
        return False

    res = _run(ckpt_dir=str(tmp_path), ckpt_every=3, failure_hook=hook)
    assert (res.start, res.end, res.restarts, tripped) == (0, 6, 1, [4])
    assert set(res.ckpt_timings) == {"snapshot_s", "write_s", "restore_s"}
    _same_run(res, full)
    assert CheckpointManager(str(tmp_path)).steps() == [3, 6]


def test_train_killed_and_restarted_equals_an_uninterrupted_run(tmp_path, transposition):
    """A child process killed after step 4 and the command line run again
    over its directory: steps 3-5 print the uninterrupted run's lines, and
    the step-6 checkpoint holds its parameters and optimizer state."""
    lines = []
    full = _run(log=lines.append)
    _cli_killed_after_step_4(tmp_path, transposition)
    out = _cli(tmp_path, transposition)
    assert out[1] == f"resuming from step 3 ({tmp_path})"
    assert [_no_ms(x) for x in out[2:5]] == [_no_ms(x) for x in lines[4:7]]
    assert out[-1] == "done at step 6 (restarts=0)"
    like = {"params": full.params, "opt": full.opt_state}
    got, step, _ = checkpoint.restore_tree(str(tmp_path / "step_6"), like)
    assert step == 6
    for a, b in zip(utils.tree_leaves(got), utils.tree_leaves(like)):
        assert torch.equal(a, b) if isinstance(b, torch.Tensor) else a == b


@pytest.mark.parametrize("every,fails", [(3, {4: 1}), (2, {1: 1, 5: 2})],
                         ids=["fail_4", "fail_1_5_twice"])
def test_train_replays_the_steps_jax_replays(tmp_path, every, fails):
    """The driver under failures runs the step indices, restarts and
    checkpoints that JAX's supervisor runs as the JAX driver configures it
    (``SupervisorConfig(ckpt_every)``, a manager keeping 2)."""
    def schedule():
        left = dict(fails)

        def hook(i):
            if left.get(i, 0):
                left[i] -= 1
                return True
            return False
        return hook

    ran = []
    res = _run(ckpt_dir=str(tmp_path / "port"), ckpt_every=every,
               failure_hook=schedule(), inspect=lambda i, g, m: ran.append(i))
    jran, jmgr = [], JCheckpointManager(str(tmp_path / "jax"), keep=2)
    want = jfault.TrainSupervisor(jmgr, jfault.SupervisorConfig(ckpt_every=every)).run(
        {"x": jnp.zeros(())}, lambda s, i: jran.append(i) or {"x": s["x"] + 1}, 6,
        failure_hook=schedule())
    assert ran == jran and (res.end, res.restarts) == (want.step, want.restarts)
    assert CheckpointManager(str(tmp_path / "port")).steps() == jmgr.steps()


def test_transposition_draws_change_the_trajectory(monkeypatch):
    """The transposition fixture's draws take effect (else the tests above
    would hold with any generator), and come from step i's generator."""
    plain = _run()
    make = mlp.make_fff_config
    monkeypatch.setattr(mlp, "make_fff_config", lambda *a, **kw: dataclasses.replace(
        make(*a, **kw), transposition_prob=0.1))
    drawn = _run()
    assert drawn.losses[0] != plain.losses[0]
    g = [train_mod.step_generator(0, i, "cpu") for i in (0, 0, 1)]
    draws = [torch.rand(4, generator=x) for x in g]
    assert torch.equal(draws[0], draws[1]) and not torch.equal(draws[0], draws[2])


def test_train_cli_resumes_after_a_kill(tmp_path):
    """``python -m repro_torch.launch.train --reduced --steps 6 --ckpt-every
    3 --ckpt-dir D``, killed with SIGKILL after step 4 and run again,
    resumes at step 3; its step-5 line and step-6 checkpoint are the
    uninterrupted run's."""
    cmd = [sys.executable, "-m", "repro_torch.launch.train", *CLI_ARGS, "--ckpt-every", "3"]

    def run(d):
        out = subprocess.run(cmd + ["--ckpt-dir", str(d)], env=ENV, cwd=REPO,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr
        return out.stdout.strip().splitlines()

    full = run(tmp_path / "full")
    _cli_killed_after_step_4(tmp_path / "killed")
    res = run(tmp_path / "killed")
    assert res[1] == f"resuming from step 3 ({tmp_path / 'killed'})"
    assert [int(x.split()[1]) for x in res[2:5]] == [3, 4, 5]
    assert _no_ms(res[4]) == _no_ms(full[6])
    assert res[-1] == full[-1] == "done at step 6 (restarts=0)"
    _same_checkpoint(tmp_path / "killed" / "step_6", tmp_path / "full" / "step_6")


# ---------------------------------------------------------------------------
# the dense FFN baseline
# ---------------------------------------------------------------------------

def ff_pair(seed, act, bias, dtype=jnp.float32):
    jcfg = jff.FFConfig(dim_in=16, dim_out=12, width=24, activation=act, bias=bias,
                        param_dtype=dtype, accum_dtype=dtype)
    shapes = jax.eval_shape(lambda: jff.init(jax.random.PRNGKey(0), jcfg))
    r = rng(seed)
    jp = jax.tree_util.tree_map(
        lambda s: jnp.asarray(r.normal(size=s.shape) / 4.0, s.dtype), shapes)
    td = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}[dtype]
    tcfg = ff.FFConfig(dim_in=16, dim_out=12, width=24, activation=act, bias=bias,
                       param_dtype=td, accum_dtype=td)
    return jcfg, jp, tcfg, weights.tree(np_tree(jp), device="cpu")


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("act", ["relu", "gelu", "silu", "swiglu"])
def test_ff_forward_matches_jax(act, bias):
    jcfg, jp, tcfg, tp = ff_pair(40, act, bias)
    assert set(tp) == set(jp)
    x = rng(41).normal(size=(2, 5, 16)).astype(np.float32)
    want = jax.jit(lambda p, x: jff.forward(p, jcfg, x))(jp, jnp.asarray(x))
    got = ff.forward(tp, tcfg, t(x))
    assert got.shape == (2, 5, 12)
    close(got, want, kind="kernel")


def test_ff_forward_bf16_and_init_match_jax():
    jcfg, jp, tcfg, tp = ff_pair(42, "swiglu", False, dtype=jnp.bfloat16)
    x = rng(43).normal(size=(6, 16)).astype(np.float32)
    want = jax.jit(lambda p, x: jff.forward(p, jcfg, x))(jp, jnp.asarray(x, jnp.bfloat16))
    got = ff.forward(tp, tcfg, t(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    close(got, want, kind="kernel", dtype=jnp.bfloat16)
    for act, bias in [("swiglu", True), ("gelu", True), ("relu", False)]:
        jcfg, _, tcfg, _ = ff_pair(0, act, bias)
        shapes = jax.eval_shape(lambda: jff.init(jax.random.PRNGKey(0), jcfg))
        mine = ff.init(torch.Generator().manual_seed(0), tcfg)
        assert {k: tuple(v.shape) for k, v in mine.items()} == \
            {k: tuple(v.shape) for k, v in shapes.items()}


def test_dense_site_aux_and_moe_still_unported():
    spec = registry.get_config("internlm2-20b", ffn="native").reduced().period[0].ffn
    p = mlp.init(torch.Generator().manual_seed(0), spec, 64,
                 param_dtype=torch.float32, accum_dtype=torch.float32)
    assert set(p) == {"wg", "wu", "wd"} and p["wg"].shape == (64, spec.d_ff)
    x = torch.randn(2, 3, 64, generator=torch.Generator().manual_seed(1))
    kw = dict(param_dtype=torch.float32, accum_dtype=torch.float32)
    y, aux = mlp.forward(p, spec, 64, x, train=True, **kw)
    assert set(aux) == {"hardening", "moe_aux", "balance"}
    assert all(float(v) == 0.0 for v in aux.values())
    y2, aux2 = mlp.forward(p, spec, 64, x, **kw)
    assert aux2 == {} and torch.equal(y, y2)
    with pytest.raises(NotImplementedError, match="'moe'"):
        mlp.init(torch.Generator(), dataclasses.replace(spec, kind="moe"), 64, **kw)


@pytest.fixture(scope="module")
def native():
    jcfg = jregistry.get_config("internlm2-20b", ffn="native").reduced(n_layers=2)
    tcfg = registry.get_config("internlm2-20b", ffn="native").reduced(n_layers=2)
    shapes = jax.eval_shape(lambda: jlm.init(jax.random.PRNGKey(0), jcfg))
    r = rng(50)

    def draw(path, s):
        if path[-1].key == "scale":
            return jnp.ones(s.shape, s.dtype)
        return jnp.asarray(r.normal(size=s.shape) / 8.0, s.dtype)

    jp = jax.tree_util.tree_map_with_path(draw, shapes)
    return jcfg, tcfg, jp, weights.from_jax(np_tree(jp), tcfg, device="cpu")


def test_native_config_matches_jax(native):
    jcfg, tcfg, _, _ = native
    for cut in (lambda c: c, lambda c: c.reduced()):
        for ffn in ("native", "dense"):
            j = cut(jregistry.get_config("internlm2-20b", ffn=ffn)).period[0].ffn
            p = cut(registry.get_config("internlm2-20b", ffn=ffn)).period[0].ffn
            assert (p.kind, p.d_ff, p.activation) == (j.kind, j.d_ff, j.activation)
    assert registry.get_config("internlm2-20b", ffn="native").period[0].ffn.d_ff == 16384


def test_native_loss_and_gradients_match_jax(native):
    jcfg, tcfg, jp, tp = native
    from repro_torch.data import tokens as tokens_lib
    batch = tokens_lib.MarkovTokenSource(tcfg.vocab_size, seed=0).batch(BATCH, SEQ, seed=1)
    (jloss, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(p, jcfg, b), has_aux=True))(jp, batch)
    (loss, m), g = optim.value_and_grad(lambda p, b: lm.loss_fn(p, tcfg, b))(tp, batch)
    close(loss, jloss)
    assert set(m) == set(jm)
    for k in jm:
        close(m[k], jm[k])
    assert float(m["hardening"]) == 0.0 and float(m["balance"]) == 0.0
    want = weights.from_jax(np_tree(jg), tcfg, device="cpu")
    assert len(utils.tree_leaves(g)) == len(utils.tree_leaves(want))
    utils.tree_map(lambda a, b: close(a, b.numpy()), g, want)


def test_native_generate_matches_jax(native):
    jcfg, tcfg, jp, tp = native
    prompt = rng(51).integers(0, jcfg.vocab_size, (2, 8)).astype(np.int32)
    want = jax.jit(lambda p, x: jlm.generate(p, jcfg, x, 6, 15))(jp, jnp.asarray(prompt))
    got = lm.generate(tp, tcfg, torch.from_numpy(prompt), 6, 15)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("ffn", ["native", "dense"])
def test_drivers_take_the_dense_baseline(ffn, capsys):
    res = train_mod.main(["--reduced", "--ffn", ffn, "--steps", "2", "--batch", "2",
                          "--seq", "16", "--device", "cpu"])
    assert all(np.isfinite(res.losses)) and "wg" in res.params["stack"][0]["ffn"]
    assert capsys.readouterr().out.strip().splitlines()[-1] == "done at step 2 (restarts=0)"
    for engine in ("off", "continuous"):
        serve_mod.main(["--device", "cpu", "--ffn", ffn, "--engine", engine,
                        "--batch", "2", "--prompt-len", "8", "--gen", "3",
                        "--scheduler", "leaf_aware", "--spec-k", "2"])
        out = capsys.readouterr().out
        assert "kernel launches:" in out
        assert all(f"{k}=0" in out for k in ("tree_router", "fused_forest_decode"))


# ---------------------------------------------------------------------------
# regions, data
# ---------------------------------------------------------------------------

def test_regions_match_jax():
    kw = dict(dim_in=8, dim_out=8, depth=3, leaf_width=4, trees=2, activation="relu")
    jcfg, tcfg = jfff.FFFConfig(**kw), fff.FFFConfig(**kw)
    shapes = jax.eval_shape(lambda: jfff.init(jax.random.PRNGKey(0), jcfg))
    r = rng(60)
    jp = jax.tree_util.tree_map(lambda s: jnp.asarray(r.normal(size=s.shape), s.dtype),
                                shapes)
    tp = weights.tree(np_tree(jp), device="cpu")
    x = r.normal(size=(3, 40, 8)).astype(np.float32)
    for tree in range(2):
        for leaf in range(tcfg.num_leaves):
            got = regions.leaf_region(tp, tcfg, leaf, tree)
            want = jregions.leaf_region(jp, jcfg, leaf, tree)
            assert [c.sign for c in got] == [c.sign for c in want]
            for a, b in zip(got, want):
                np.testing.assert_allclose(a.normal, b.normal, rtol=1e-6)
                assert a.offset == pytest.approx(b.offset, rel=1e-6, abs=1e-7)
            np.testing.assert_array_equal(
                regions.region_membership(got, x.reshape(-1, 8)),
                jregions.region_membership(want, x.reshape(-1, 8)))
    np.testing.assert_array_equal(regions.partition_histogram(tp, tcfg, t(x)).numpy(),
                                  np.asarray(jregions.partition_histogram(jp, jcfg, x)))
    assert regions.is_partition(tp, tcfg, t(x)) and jregions.is_partition(jp, jcfg, x)
    with pytest.raises(ValueError, match="node_width == 1"):
        regions.leaf_region(tp, dataclasses.replace(tcfg, node_width=2), 0)


@pytest.mark.parametrize("spec", [
    "usps_like",
    jsynthetic.SyntheticSpec(side=8, channels=3, num_classes=5, prototypes_per_class=3,
                             n_train=96, n_val=16, n_test=32, seed=7)],
    ids=["usps_like", "small_rgb"])
def test_synthetic_datasets_equal_jax(spec):
    want = jsynthetic.make(spec)
    got = synthetic.make(spec if isinstance(spec, str) else
                         synthetic.SyntheticSpec(**dataclasses.asdict(spec)))
    assert got.num_classes == want.num_classes
    for a, b in zip(got[:6], want[:6]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    side, ch = (16, 1) if spec == "usps_like" else (8, 3)
    np.testing.assert_array_equal(synthetic.patches(got.x_test, side, ch, 4),
                                  jsynthetic.patches(want.x_test, side, ch, 4))


def test_epoch_batches_equal_jax():
    ds = synthetic.make(synthetic.SyntheticSpec(n_train=100, n_val=4, n_test=4))
    got = list(pipeline.epoch_batches(ds.x_train, ds.y_train, 16, seed=3))
    want = list(jpipeline.epoch_batches(ds.x_train, ds.y_train, 16, seed=3))
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a["x"], b["x"])
        np.testing.assert_array_equal(a["y"], b["y"])


def test_prefetcher_delivers_in_order_and_surfaces_errors():
    pf = pipeline.Prefetcher(lambda i: {"x": np.full((2,), i)}, depth=2, device="cpu")
    got = [next(pf)["x"] for _ in range(5)]
    pf.close()
    assert not pf._thread.is_alive()
    assert all(isinstance(v, torch.Tensor) for v in got)
    assert [int(v[0]) for v in got] == [0, 1, 2, 3, 4]

    def make(i):
        if i == 3:
            raise ValueError("bad batch 3")
        return {"x": np.full((1,), i)}

    pf = pipeline.Prefetcher(make, depth=1, device="cpu")
    assert [int(next(pf)["x"][0]) for _ in range(3)] == [0, 1, 2]
    with pytest.raises(ValueError, match="bad batch 3"):
        next(pf)
    pf.close()
    b = pipeline.shard_batch({"t": np.arange(3, dtype=np.int32)}, device="cpu")
    assert b["t"].dtype == torch.int32 and b["t"].tolist() == [0, 1, 2]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pipeline.Prefetcher(make)
