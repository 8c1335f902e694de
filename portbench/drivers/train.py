"""The learner: recurrent PPO train steps of the shipped policy, one after
another, on one card or over a data mesh of one rank per card.

Set-up builds one train state and one train step (the program's
``init_recurrent_train_state`` and ``make_recurrent_train_step``, over
``make_mesh(data=ranks)`` when the cell has several cards), and drives
that same step through its first ``check_steps`` steps; the window then
continues the same object. The check runs the reference (one process,
the same global batch) from the same weights and key through as many
steps and works out, as the optimizer sees them (``gaps``):

* ``loss_gap`` / ``loss_gap_first``: each step's loss, |program -
  reference| over max(|reference|, ``LOSS_FLOOR``), the worst step / the
  first;
* ``grad_gap``: the first gradient the optimizer gets (step 1, epoch 0,
  minibatch 0; the global gradient over a mesh), leaf by leaf, the gap
  between the two norms over max(the reference leaf's norm, the median
  leaf's), the worst leaf;
* ``change_gap`` / ``change_gap_median``: each leaf's change over the
  checked steps, measured the same way, the worst / the median of the
  leaves whose reference first gradient is at least ``KEEP`` of the
  median leaf's (a leaf the loss does not reach moves by round-off alone
  under Adam).

The cell's limits file names the numbers it compares.
"""

from __future__ import annotations

import statistics
import time

import torch

from portbench import reference
from portbench.harness import ROOT

RESET = 1
LOSS_FLOOR = 1e-2
KEEP = 1e-3


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.config, self.traffic = ctx.config, ctx.traffic
        g, pol, tr = self.config["grid"], self.config["policy"], self.config["train"]
        self.b, self.n = self.config["num_envs"], g["num_agents"]
        self.shapes = {"B": self.b, "N": self.n, "W": 2 * g["obs_radius"] + 1,
                       "P": g["size"] + 2 * g["obs_radius"], "embed": pol["embed"],
                       "hidden": pol["hidden"], "rollout": tr["rollout_steps"],
                       "epochs": tr["epochs"]}
        # A unit is a whole regen cycle: every env's episode (128 env steps)
        # ends in the second step of T = 64, where regen draws new worlds,
        # so the steps alternate long and short and a window of whole
        # cycles does the same work whatever its length.
        self.steps_per_unit = self.traffic["steps_per_unit"]
        self.work = {"train_env_steps": self.b * tr["rollout_steps"] * self.steps_per_unit,
                     "train_steps": self.steps_per_unit}
        self.weights = str(ROOT / pol["weights"])
        self.dtype = getattr(torch, pol["dtype"])
        mesh = self.traffic["mesh"]
        if mesh["data"] * mesh["model"] != ctx.world:
            raise ValueError(f"mesh {mesh} needs {mesh['data'] * mesh['model']} ranks, the cell "
                             f"runs {ctx.world}")
        self.key = ctx.key(RESET)
        self.phases = {}
        self.patches = []  # planted faults (tests and calibration only)

    def _ppo(self, learner):
        tr = self.config["train"]
        return learner.PPOConfig(rollout_steps=tr["rollout_steps"], epochs=tr["epochs"],
                                 minibatches=tr["minibatches"], lr=tr["lr"],
                                 entropy_coef=tr["entropy_coef"])

    def _phase(self, name):
        self.ctx.sync()
        now = time.perf_counter()
        self.phases.setdefault(name, []).append(now - self._mark)
        self._mark = now

    def setup(self):
        from pogema_torch import GridConfig, PogemaCore
        from pogema_torch.core import collisions
        from pogema_torch.interop import load_policy
        from pogema_torch.parallel import learner, make_mesh
        from pogema_torch.parallel import mesh as mesh_mod

        self.collisions, self.mesh_mod = collisions, mesh_mod
        dev = self.ctx.device
        m = self.traffic["mesh"]
        mesh = make_mesh(m["data"], m["model"], device=dev) if self.ctx.world > 1 else None
        core = PogemaCore(GridConfig(**self.config["grid"]), num_envs=self.b,
                          auto_reset_mode=self.config["train"]["auto_reset_mode"], device=dev)
        model = load_policy(self.weights, device=dev, dtype=self.dtype)
        ppo = self._ppo(learner)
        ts, tx = learner.init_recurrent_train_state(core, model, None, ppo, self.key, mesh=mesh)
        self.first_grad = None
        self.step = learner.make_recurrent_train_step(
            core, model, ppo, tx, grad_hook=self._grad_hook,
            phase_hook=self._phase if self.ctx.trace else None, mesh=mesh)
        self.p0 = {k: v.clone() for k, v in ts.params.items()}
        self.losses = []
        with reference.patched(self.patches):
            for _ in range(self.traffic["check_steps"]):
                ts = self._train(ts)
        self.p_end = {k: v.clone() for k, v in ts.params.items()}
        self.ts = ts
        self.phases = {}

    def _grad_hook(self, epoch, i, loss, grads):
        if self.first_grad is None:
            self.first_grad = {k: g.detach().float().norm() for k, g in grads.items()}

    def _train(self, ts):
        self._mark = time.perf_counter()
        ts, stats = self.step(ts)
        self.losses.append(stats["loss"].detach().clone())
        self.ctx.sync()
        return ts

    def unit(self):
        for _ in range(self.steps_per_unit):
            self.ts = self._train(self.ts)

    def counters(self) -> dict:
        return {"fixpoint_passes": self.collisions.fixpoint.passes,
                "all_reduce_bytes": self.mesh_mod.all_reduce_sum.bytes}

    def traced_slice(self) -> int:
        for _ in range(self.traffic["trace_units"]):
            self.unit()
        return self.traffic["trace_units"]

    def release(self):
        del self.ts, self.step
        if self.ctx.device.startswith("cuda"):
            torch.cuda.empty_cache()

    def readings(self):
        """The program's readings of the checked steps, as host numbers."""
        k = self.traffic["check_steps"]
        return ([float(x) for x in self.losses[:k]],
                {n: float(v) for n, v in self.first_grad.items()},
                {n: float((self.p_end[n] - self.p0[n]).norm()) for n in self.p0})

    def check(self, patches=None) -> list:
        if self.ctx.rank != 0:
            return []
        return limited(self.ctx, gaps_against_reference(self, self.readings(), patches))


def reference_readings(drv, patches=None):
    """The reference's losses, first-gradient norms and changes over the
    checked steps, from the same weights, key and global batch."""
    from portbench.reference.pogema_ref.core import api
    from portbench.reference.pogema_ref.grid_config import GridConfig
    from portbench.reference.pogema_ref.parallel import learner

    dev = drv.ctx.device
    first = {}

    def hook(epoch, i, loss, grads):
        if not first:
            first.update({k: float(g.detach().float().norm()) for k, g in grads.items()})

    with reference.plain_precision(), reference.patched(patches):
        core = api.PogemaCore(GridConfig(**drv.config["grid"]), num_envs=drv.b,
                              auto_reset_mode=drv.config["train"]["auto_reset_mode"], device=dev)
        model = reference.recurrent_model(drv.weights, dev, drv.dtype)
        ppo = drv._ppo(learner)
        ts, tx = learner.init_recurrent_train_state(core, model, None, ppo, drv.key.to(dev))
        step = learner.make_recurrent_train_step(core, model, ppo, tx, grad_hook=hook)
        p0 = {k: v.clone() for k, v in ts.params.items()}
        losses = []
        for _ in range(drv.traffic["check_steps"]):
            ts, stats = step(ts)
            losses.append(float(stats["loss"]))
        change = {k: float((ts.params[k] - p0[k]).norm()) for k in p0}
    return losses, first, change


def gaps(prog, ref) -> dict:
    """Every number the check can compare, from the program's readings and
    the reference's, each ``(losses, first-gradient norms, change
    norms)``: the worst step's loss gap and the first step's, the worst
    leaf's first-gradient gap, and the change gap of the worst and of the
    median kept leaf. A cell's limits file names those it compares."""
    (lp, gp, cp), (lr, gr, cr) = prog, ref
    loss = [abs(a - b) / max(abs(b), LOSS_FLOOR) for a, b in zip(lp, lr)]
    g_med = statistics.median(gr.values())
    kept = [k for k in cr if gr[k] >= KEEP * g_med]
    c_med = statistics.median(cr[k] for k in kept)
    change = [abs(cp[k] - cr[k]) / max(cr[k], c_med) for k in kept]
    return {"loss_gap": max(loss), "loss_gap_first": loss[0],
            "grad_gap": max(abs(gp[k] - gr[k]) / max(gr[k], g_med) for k in gr),
            "change_gap": max(change), "change_gap_median": statistics.median(change)}


NUMBERS = ("loss_gap", "loss_gap_first", "grad_gap", "change_gap", "change_gap_median")


def limited(ctx, numbers: dict) -> list:
    """``(name, value, limit)`` of the numbers the cell's limits name."""
    return [(name, numbers[name], limit) for name, limit in ctx.cell.limits.items()]


def gaps_against_reference(drv, prog, patches=None) -> dict:
    return gaps(prog, reference_readings(drv, patches))


def half_batch_patch():
    """The loss over the first half of each minibatch's envs, its mean
    taken over them alone: half of the batch left out."""
    from pogema_torch.parallel import learner

    whole = learner._ppo_loss_terms

    def half(config, logits, values, actions, old_log_probs, advantages, targets, axis=None):
        h = max(1, logits.shape[1] // 2)
        return whole(config, logits[:, :h], values[:, :h], actions[:, :h], old_log_probs[:, :h],
                     advantages[:, :h], targets[:, :h], axis)

    return [(learner, "_ppo_loss_terms", half)]


def exchange_patch():
    """Every sum over the data ranks left out: each rank keeps its own
    share (the exchange between cards skipped)."""
    from pogema_torch.parallel import learner

    return [(learner, "all_reduce_sum", lambda x, group: x.clone())]


def planted(ctx, impl, seconds, measure):
    """Checks of a planted variant: 'control' (the reference with fp8
    weights in the program's place), 'half_batch' or 'exchange' (the
    program with that fault over its checked steps)."""
    drv = Driver(ctx)
    if impl == "control":
        if ctx.rank != 0:
            return []
        return limited(ctx, gaps_against_reference(drv, reference_readings(
            drv, reference.fp8_patches())))
    drv.patches = {"half_batch": half_batch_patch, "exchange": exchange_patch}[impl]()
    return measure(ctx, seconds, __import__("time").time(), drv)[1]
