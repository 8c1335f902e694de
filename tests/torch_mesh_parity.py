"""Train steps, rollouts and gradients of pogema_torch in one process or
over a mesh of gloo processes on the CPU: the harness shared by
``test_torch_distributed.py``, the ``test_torch_mesh_jax_*.py`` files and
their worker processes (``torch_mesh_worker.py``). It imports no JAX.

Sizes follow ``torch_train_parity.py``: 8 envs x 2 agents, 8x8, r=2,
T=8, 2 epochs x 2 minibatches, f32 models of width 32. Every result is
returned whole (gathered over the mesh) as a dict of CPU tensors, so
that the caller compares it with the single-process run.
"""

import json
import os
import socket
import subprocess
import sys

import torch

from pogema_torch import GridConfig, PogemaCore
from pogema_torch import parallel as tp
from pogema_torch.models import (ActorCritic, EmbedActorCritic, RecurrentEmbedActorCritic,
                                 gather_params, partition_params)
from pogema_torch.models.tensor_parallel import shard_module
from pogema_torch.parallel import learner as tl
from pogema_torch.parallel import rollout as roll
from pogema_torch.parallel.mesh import (all_gather_cat, all_reduce_sum, axis_size, data_rows,
                                        gather_batch)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID = dict(seed=0, size=8, density=0.2, num_agents=2, obs_radius=2, max_episode_steps=16,
            on_target="restart")
NUM_ENVS = 8
# The rollouts are bit-equal at the size of the JAX package's
# test_sharded_rollout_bit_exact (16 envs). With fewer than 8 rows per
# product the CPU's BLAS takes another kernel for the conv model's trunk
# (K = 100), whose sums differ in the last bit from those of a taller
# product: at 8 envs on 4 ranks the values and log-probs differ by 1e-7,
# the actions and states do not (test_torch_distributed.py holds both).
ROLLOUT_ENVS = (16, 8)
PPO = dict(rollout_steps=8, epochs=2, minibatches=2)
WIDTH = 32
WINDOW = 5
# flavour: (model family, obstacle_path, auto-reset mode)
FLAVOURS = {"obs": ("conv", "auto", "cached"),
            "fused_windows": ("fused", "windows", "regen"),
            "fused_pre": ("fused", "pre", "regen"),
            "recurrent": ("recurrent", "auto", "regen")}
# (data, model) meshes by world size
CASES = {2: [(2, 1)], 4: [(4, 1), (2, 2)]}
INITS = {"conv": tp.init_train_state, "fused": tp.init_fused_train_state,
         "recurrent": tp.init_recurrent_train_state}
MAKES = {"conv": tp.make_train_step, "fused": tp.make_fused_train_step,
         "recurrent": tp.make_recurrent_train_step}


def make_model(family, params):
    """The port's f32 model of ``family`` at the harness's widths, holding
    ``params`` (``{name: tensor}``, whole)."""
    if family == "conv":
        model = ActorCritic(WINDOW, hidden=WIDTH, channels=4, dtype=torch.float32)
    elif family == "recurrent":
        model = RecurrentEmbedActorCritic(WINDOW, embed=WIDTH, hidden=WIDTH, dtype=torch.float32)
    else:
        model = EmbedActorCritic(WINDOW, embed=WIDTH, hidden=WIDTH, dtype=torch.float32)
    tl.load_params(model, params)
    return model


def make_core(mode, num_envs=NUM_ENVS):
    return PogemaCore(GridConfig(**GRID), num_envs=num_envs, auto_reset_mode=mode, device="cpu")


def _whole_h(h, mesh):
    """The hidden state of every env and feature (a collective call)."""
    h = gather_batch(h, mesh)
    if axis_size(mesh, "model") > 1:
        h = all_gather_cat(h, mesh.get_group("model"), dim=-1)
    return h


def _whole(ts, mesh):
    """The train state's tensors, whole, as CPU tensors."""
    params, mu = ts.params, ts.opt_state["mu"]
    env_state, h = ts.env_state, getattr(ts, "h", None)
    if mesh is not None:
        params, mu = gather_params(params, mesh), gather_params(mu, mesh)
        env_state = gather_batch(env_state, mesh)
        h = None if h is None else _whole_h(h, mesh)
    out = {"params": dict(params), "mu": dict(mu), "key": ts.key,
           "count": ts.opt_state["count"], "env_state": env_state.tensors()}
    if h is not None:
        out["h"] = h.float()
    return out


def run_train(flavour, params, mesh=None, steps=2, num_envs=NUM_ENVS, minibatches=None):
    """``steps`` train steps of ``flavour`` from ``init_*(key 1)`` with
    ``params`` (whole; partitioned here over ``mesh``). Returns {"init":
    state, "steps": [{"stats", "state", "grads" (first minibatch), "local_losses"
    (this rank's loss of every minibatch)}]}, gathered."""
    family, path, mode = FLAVOURS[flavour]
    core = make_core(mode, num_envs)
    model = make_model(family, params)
    ppo = dict(PPO, minibatches=minibatches or PPO["minibatches"])
    cfg = tl.PPOConfig(obstacle_path=path, **ppo)
    given = params if mesh is None else partition_params(params, mesh)
    ts, tx = INITS[family](core, model, given, cfg, core.make_key(1), mesh=mesh)
    out = {"init": _whole(ts, mesh), "steps": []}
    seen = []

    def hook(epoch, i, loss, grads):
        seen.append((float(loss), {k: g.clone() for k, g in grads.items()}))

    step = MAKES[family](core, model, cfg, tx, grad_hook=hook, mesh=mesh)
    for _ in range(steps):
        seen.clear()
        ts, stats = step(ts)
        grads = seen[0][1] if mesh is None else gather_params(seen[0][1], mesh)
        out["steps"].append({"stats": {k: float(v) for k, v in stats.items()},
                             "state": _whole(ts, mesh), "grads": grads,
                             "local_losses": [loss for loss, _ in seen]})
    return out


def run_rollouts(params_by_family, mesh=None, num_envs=16):
    """One rollout of T steps of each rollout function from the init
    state of its flavour (obs: conv model, cached; state: fused
    from_state, regen; recurrent, regen). Returns {kind: {field: tensor
    [T, B, ...]}} with the final state, gathered over the envs."""
    out = {}
    for kind, (flavour, fn) in {"obs": ("obs", roll.make_rollout_fn),
                                "state": ("fused_windows", roll.make_state_rollout_fn),
                                "recurrent": ("recurrent", roll.make_recurrent_rollout_fn)}.items():
        family, _, mode = FLAVOURS[flavour]
        core = make_core(mode, num_envs)
        model = make_model(family, params_by_family[family])
        cfg = tl.PPOConfig(**PPO)
        given = params_by_family[family] if mesh is None else partition_params(
            params_by_family[family], mesh)
        ts, _ = INITS[family](core, model, given, cfg, core.make_key(1), mesh=mesh)
        lo = 0 if mesh is None else data_rows(mesh, num_envs)[0]
        t = cfg.rollout_steps
        if kind == "obs":
            s, _, _, traj = fn(core, model, t, env_offset=lo)(
                ts.env_state, ts.initial_env_state, ts.obs, ts.key)
            h = None
        elif kind == "state":
            s, _, traj = fn(core, model.from_state, t, env_offset=lo)(
                ts.env_state, ts.initial_env_state, ts.key)
            h = None
        else:
            s, h, _, traj = fn(core, model.step_from_state, t, env_offset=lo)(
                ts.env_state, ts.initial_env_state, ts.h, ts.key)
        fields = {k: v for k, v in vars(traj).items() if k != "metrics"}
        fields.update({f"metric_{k}": v for k, v in traj.metrics.items()})
        if mesh is not None:  # [T, B, ...] -> gather the env axis
            fields = {k: all_gather_cat(v, mesh.get_group("data"), dim=1)
                      for k, v in fields.items()}
            s = gather_batch(s, mesh)
            h = None if h is None else _whole_h(h, mesh)
        fields.update({f"state_{k}": v for k, v in s.tensors().items()})
        if h is not None:
            fields["h"] = h.float()
        out[kind] = fields
    return out


def run_grads(params_by_family, mesh=None):
    """Gradients of a fixed function of each model's outputs on fixed
    inputs (8 envs x 2 agents; the recurrent model over two steps, so
    that the gradient flows through the carried h), whole."""
    gen = torch.Generator().manual_seed(3)
    b, n, p, w = NUM_ENVS, 2, 8 + WINDOW - 1, WINDOW
    grids = (torch.rand(b, p, p, generator=gen) < 0.3).to(torch.uint8)
    axy = torch.randint(2, p - 2, (b, n, 2), generator=gen, dtype=torch.int32)
    txy = torch.randint(2, p - 2, (b, n, 2), generator=gen, dtype=torch.int32)
    active = torch.ones(b, n, dtype=torch.bool)
    obs = torch.rand(b, n, 3, w, w, generator=gen)
    mix = torch.randn(b, n, 6, generator=gen)
    lo, hi = (0, b) if mesh is None else data_rows(mesh, b)
    out = {}
    for family, params in params_by_family.items():
        model = make_model(family, params)
        if mesh is not None:
            shard_module(model, mesh)
        if family == "conv":
            logits, values = model(obs[lo:hi])
        elif family == "recurrent":
            h = model.initial_carry((hi - lo, n))
            for _ in range(2):
                h, logits, values = model.step_from_state(grids[lo:hi], axy[lo:hi], txy[lo:hi],
                                                          active[lo:hi], h)
        else:
            logits, values = model.from_state(grids[lo:hi], axy[lo:hi], txy[lo:hi], active[lo:hi])
        y = torch.cat([logits, values[..., None]], -1)
        loss = (y * mix[lo:hi]).sum() + (y * y).sum() / 7
        named = dict(model.named_parameters())
        grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
        if mesh is not None:
            group = mesh.get_group("data")
            grads = gather_params({k: all_reduce_sum(g, group) for k, g in grads.items()}, mesh)
        out[family] = grads
    return out


# -- spawning ---------------------------------------------------------------


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(argv, world, timeout):
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join([ROOT, os.path.join(ROOT, "tests"),
                                               os.environ.get("PYTHONPATH", "")]))
        procs.append(subprocess.Popen([sys.executable] + argv, env=env, cwd=ROOT,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs, errors = [], []
    for p in procs:
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
        if p.returncode != 0:
            errors.append(err[-4000:])
    return outs, errors


def spawn(argv, world, timeout=240):
    """Run ``python argv`` as ``world`` ranks (torchrun's environment, a
    free port each time); returns each rank's stdout. Retried once, only
    when the rendezvous timed out (a saturated machine); any other
    failure raises with the ranks' errors."""
    outs, errors = _spawn(argv, world, timeout)
    if errors and any("timed out" in e.lower() or "timeout" in e.lower() for e in errors):
        outs, errors = _spawn(argv, world, timeout)
    if errors:
        raise AssertionError("a rank failed:\n" + "\n----\n".join(errors))
    return outs


def run_workers(tmp_path, world, tasks, params_by_family, flavours=tuple(FLAVOURS),
                cases=None):
    """``tasks`` (of torch_mesh_worker.py) on ``world`` gloo ranks, for
    the meshes ``cases`` (default ``CASES[world]``); returns {(task, data,
    model[, flavour]): result} as rank 0 saved them."""
    params_path = os.path.join(tmp_path, "params.pt")
    torch.save(params_by_family, params_path)
    spec = {"out": str(tmp_path), "params": params_path, "tasks": list(tasks),
            "cases": cases or CASES[world], "flavours": list(flavours)}
    spec_path = os.path.join(tmp_path, f"spec{world}.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    spawn([os.path.join(ROOT, "tests", "torch_mesh_worker.py"), spec_path], world)
    with open(os.path.join(tmp_path, f"index{world}.json")) as f:
        index = json.load(f)
    return {tuple(json.loads(k)): torch.load(v, weights_only=True) for k, v in index.items()}
