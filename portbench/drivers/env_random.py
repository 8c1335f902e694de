"""Batched-env traffic: uniform random actions through
``PogemaCore.step_autoreset``, one step after another.

This is what an RL user's actor loop sends: B envs stepped in lockstep,
each step's actions drawn by a CUDA generator seeded from ``--seed``,
and each step timed until its observation exists. The reset happens
once, in set-up.

The check follows a sample of envs (rows drawn from the seed) through
the reference from the reset up to steps drawn from the seed, with the
same actions, and compares at each such step everything the step
returned for those rows: the state after the step (and the cached
auto-reset select with its keys), both observations, rewards, flags,
done and the episode metrics. Env rows are independent, so the
reference steps only the sampled rows. Every compared value must be
equal.
"""

from __future__ import annotations

import torch

from portbench import reference

# Seed streams of this traffic.
RESET, ACTIONS, SAMPLE = 1, 2, 3


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.config, self.traffic = ctx.config, ctx.traffic
        self.b = self.config["num_envs"]
        self.n = self.config["grid"]["num_agents"]
        w = 2 * self.config["grid"]["obs_radius"] + 1
        p = self.config["grid"]["size"] + 2 * self.config["grid"]["obs_radius"]
        self.shapes = {"B": self.b, "N": self.n, "W": w, "P": p}
        self.work = {"env_steps": self.b, "steps": 1}
        rng = ctx.rng(SAMPLE)
        self.rows = sorted(rng.choice(self.b, self.traffic["check_envs"], replace=False).tolist())
        warm = self.traffic["warmup_steps"]
        self.checkpoints = sorted(
            warm + 1 + rng.choice(self.traffic["check_within_steps"],
                                  self.traffic["check_steps"], replace=False)).copy()
        self.checkpoints = [int(c) for c in self.checkpoints]
        self.saved = {}
        self.control = False  # the reference in the program's place (calibration)

    # -- the system under test -----------------------------------------

    def _package(self):
        """(GridConfig, PogemaCore) of the program, or of the reference in
        the control's place."""
        if self.control:
            from portbench.reference.pogema_ref.core import api
            from portbench.reference.pogema_ref.grid_config import GridConfig

            return GridConfig, api.PogemaCore
        from pogema_torch import GridConfig, PogemaCore

        return GridConfig, PogemaCore

    def setup(self):
        from pogema_torch.core import collisions
        from pogema_torch.ops import cuda_windows

        self.collisions, self.k1b = collisions, cuda_windows.packed_observation_cuda
        grid_config, core_cls = self._package()
        cfg = self.config
        self.core = core_cls(grid_config(**cfg["grid"]), num_envs=self.b, maze=cfg["maze"],
                             auto_reset_mode=cfg["auto_reset_mode"], obs_layout=cfg["obs_layout"],
                             device=self.ctx.device)
        self.key = self.ctx.key(RESET)
        self.state, _ = self.core.reset(self.key)
        self.init = self.state
        self.gen = torch.Generator(device=self.ctx.device).manual_seed(self.ctx.torch_seed(ACTIONS))
        self.count = 0
        for _ in range(self.traffic["warmup_steps"]):
            self.unit()

    def _actions(self, gen):
        return torch.randint(0, 5, (self.b, self.n), generator=gen, device=self.ctx.device,
                             dtype=torch.int32)

    def unit(self):
        self.count += 1
        out = self.core.step_autoreset(self.state, self.init, self._actions(self.gen))
        self.state = out[0]
        if self.count in self.checkpoints:
            self.saved[self.count] = _rows(out, torch.tensor(self.rows, device=self.ctx.device))
        self.ctx.sync()

    def counters(self) -> dict:
        return {"fixpoint_passes": self.collisions.fixpoint.passes,
                "k1b_launches": self.k1b.launches}

    def traced_slice(self) -> int:
        for _ in range(self.traffic["trace_steps"]):
            self.unit()
        return self.traffic["trace_steps"]

    def release(self):
        del self.core, self.state, self.init
        torch.cuda.empty_cache() if self.ctx.device.startswith("cuda") else None

    # -- the check -----------------------------------------------------

    def check(self) -> list:
        return [("mismatched_values", compare(self), self.ctx.cell.limits["mismatched_values"])]


def _rows(out, rows) -> dict:
    """Everything one ``step_autoreset`` returned, for ``rows`` only."""
    state, obs, res, done, metrics = out
    got = {f"state.{k}": v.index_select(0, rows) for k, v in state.tensors().items()}
    got["obs"] = obs.index_select(0, rows)
    got["pre_reset_obs"] = res.observations.index_select(0, rows)
    for k in ("rewards", "terminated", "truncated"):
        got[k] = getattr(res, k).index_select(0, rows)
    got["done"] = done.index_select(0, rows)
    for k, v in metrics.items():
        got[f"metrics.{k}"] = v.index_select(0, rows)
    return got


def compare(drv) -> float:
    """Mismatched values between the saved rows and the reference's, over
    every checkpoint the window reached; inf where none was reached."""
    reached = sorted(drv.saved)
    if not reached:
        return float("inf")
    from portbench.reference.pogema_ref.core import api, random as jr
    from portbench.reference.pogema_ref.grid_config import GridConfig

    dev = drv.ctx.device
    cfg = drv.config
    rows = torch.tensor(drv.rows, device=dev)
    with reference.plain_precision():
        core = api.PogemaCore(GridConfig(**cfg["grid"]), num_envs=len(drv.rows),
                              maze=cfg["maze"], auto_reset_mode=cfg["auto_reset_mode"],
                              obs_layout=cfg["obs_layout"], device=dev)
        keys = jr.split(drv.key.to(dev), drv.b).index_select(0, rows)
        state = core._reset_envs(keys)
        init = state
        gen = torch.Generator(device=dev).manual_seed(drv.ctx.torch_seed(ACTIONS))
        bad = 0
        for step in range(1, reached[-1] + 1):
            actions = drv._actions(gen).index_select(0, rows)
            out = core.step_autoreset(state, init, actions)
            state = out[0]
            if step in drv.saved:
                want = _rows(out, torch.arange(len(drv.rows), device=dev))
                bad += reference.mismatches(drv.saved[step], want)
    return float(bad)


def planted(ctx, impl, seconds, measure):
    """Checks of the control ('control': the reference in the program's
    place with its collisions resolved in one parallel pass,
    ``reference.one_pass_priority``), through every checkpoint."""
    if impl != "control":
        raise ValueError(f"no planted variant {impl!r} for env traffic")
    from portbench.reference.pogema_ref.core import collisions

    drv = Driver(ctx)
    drv.control = True
    with reference.patched([(collisions, "resolve_priority", reference.one_pass_priority)]):
        drv.setup()
        while drv.count < drv.checkpoints[-1]:
            drv.unit()
    drv.release()
    return drv.check()
