"""The vector rim's traffic: an external learner stepping
``PogemaVectorEnv`` with numpy actions and reading numpy arrays back.

Set-up builds the env through its public constructor, draws the
learner's actions (``action_arrays`` numpy int32 arrays of B*N actions,
uniform over the 5 actions, from a stream of ``--seed``), resets it
with a seed drawn from ``--seed`` and runs ``warmup_steps`` steps, past
the first step where the episodes end, so that the pinned host blocks
and the terminal copy are warm before the window. A unit is one
``env.step(actions[t % action_arrays])``: it returns once its arrays are
on the host (``fetch`` has waited for the card). Each step's arrays are
kept until the next step returns, as a learner feeding its policy
would, and nothing else is copied. In the window it also times
each step that returned terminal observations (``phases["end_step"]``).

The check follows a sample of envs (drawn from the seed) through the
plain reference adapter (``pogema_ref.integrations.vector``), from their
own reset keys with their own slots' actions, and compares at steps
drawn from the window's first ``check_within_steps`` steps, and at the
window's first step where the episodes end, every array the step
returned for their agent slots: the observation, rewards, flags,
``final_obs`` and its mask, ``_metrics`` and each ``metrics/<k>``;
values, dtypes, and the shapes of the whole arrays. Every compared
value must be equal.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import reference

# Seed streams of this traffic.
RESET, ACTIONS, SAMPLE = 1, 2, 3


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.config, self.traffic = ctx.config, ctx.traffic
        grid = self.config["grid"]
        self.b, self.n = self.config["num_envs"], grid["num_agents"]
        self.shapes = {"B": self.b, "N": self.n, "W": 2 * grid["obs_radius"] + 1,
                       "P": grid["size"] + 2 * grid["obs_radius"]}
        self.work = {"env_steps": self.b, "steps": 1}
        rng = ctx.rng(SAMPLE)
        self.rows = sorted(rng.choice(self.b, self.traffic["check_envs"], replace=False).tolist())
        self.slots = (np.asarray(self.rows)[:, None] * self.n + np.arange(self.n)).reshape(-1)
        warm, period = self.traffic["warmup_steps"], grid["max_episode_steps"]
        drawn = warm + 1 + rng.choice(self.traffic["check_within_steps"],
                                      self.traffic["check_steps"], replace=False)
        # Every env's episode is cut at max_episode_steps: the window's
        # first ending step is the first multiple of it after the warm-up.
        self.first_end = (warm // period + 1) * period
        self.checkpoints = sorted({int(c) for c in drawn} | {self.first_end})
        self.seed = int(ctx.rng(RESET).integers(2**31))
        self.saved = {}
        self.phases = {"end_step": []}
        self.timing = False
        self.control = False  # the reference adapter in the program's place (calibration)

    # -- the system under test -----------------------------------------

    def _make_env(self):
        cfg = self.config
        kw = dict(num_vec_envs=self.b, obs_layout=cfg["obs_layout"],
                  auto_reset_mode=cfg["auto_reset_mode"], maze=cfg["maze"],
                  device=self.ctx.device)
        if self.control:
            from portbench.reference.pogema_ref.grid_config import GridConfig
            from portbench.reference.pogema_ref.integrations.vector import VectorEnv

            return VectorEnv(GridConfig(**cfg["grid"]), **kw)
        from pogema_torch import GridConfig, PogemaVectorEnv

        return PogemaVectorEnv(GridConfig(**cfg["grid"]), **kw)

    def setup(self):
        from pogema_torch.integrations.vector import PogemaVectorEnv
        from pogema_torch.ops import cuda_windows
        from pogema_torch.utils import host

        self.fetch, self.final_obs = host.fetch, PogemaVectorEnv._final_obs
        self.k1b = cuda_windows.packed_observation_cuda
        self.actions = self.ctx.rng(ACTIONS).integers(
            0, 5, size=(self.traffic["action_arrays"], self.b * self.n), dtype=np.int32)
        self.env = self._make_env()
        self.env.reset(seed=self.seed)
        self.count, self.last = 0, None
        for _ in range(self.traffic["warmup_steps"]):
            self.unit()
        self.timing = True

    def unit(self):
        actions = self.actions[self.count % len(self.actions)]
        self.count += 1
        t = time.perf_counter()
        out = self.env.step(actions)
        seconds = time.perf_counter() - t
        self.last = out  # the previous step's arrays were held until now
        if self.timing and "final_obs" in out[4]:
            self.phases["end_step"].append(seconds)
        if self.count in self.checkpoints:
            self.saved[self.count] = _slots(out, self.slots)

    def counters(self) -> dict:
        """K1b's launches, and the rim's copy counters where the program
        has them (a program without them reads nothing there)."""
        out = {"k1b_launches": self.k1b.launches}
        for name, fn, attr in (("fetch_bytes", self.fetch, "bytes"),
                               ("final_obs_rows", self.final_obs, "rows")):
            value = getattr(fn, attr, None)
            if value is not None:
                out[name] = value
        return out

    def traced_slice(self) -> int:
        self.timing = False
        for _ in range(self.traffic["trace_steps"]):
            self.unit()
        return self.traffic["trace_steps"]

    def release(self):
        del self.env, self.last
        torch.cuda.empty_cache() if self.ctx.device.startswith("cuda") else None

    # -- the check -----------------------------------------------------

    def check(self) -> list:
        return [("mismatched_values", compare(self), self.ctx.cell.limits["mismatched_values"])]


def _slots(out, slots, total=None) -> dict:
    """Every array one vector step returned, at ``slots`` (None: all),
    with the shape of each whole array (``total`` rows, or its own)."""
    obs, rewards, terminated, truncated, infos = out
    arrays = {"obs": obs, "rewards": rewards, "terminated": terminated,
              "truncated": truncated, **{f"infos.{k}": v for k, v in infos.items()}}
    got = {}
    for k, v in arrays.items():
        rows = v.shape[0] if total is None else total
        got[f"{k}.shape"] = np.asarray((rows,) + v.shape[1:], np.int64)
        got[k] = np.array(v if slots is None else v[slots])
    return got


def mismatches(got: dict, want: dict) -> int:
    """Elements that differ between two dicts of numpy arrays; a missing
    key, or a shape or dtype that differs, counts every element."""
    bad = 0
    for k in set(got) | set(want):
        a, b = got.get(k), want.get(k)
        if a is None or b is None or a.shape != b.shape or a.dtype != b.dtype:
            bad += max(0 if a is None else a.size, 0 if b is None else b.size, 1)
            continue
        bad += int((a != b).sum())
    return bad


def compare(drv) -> float:
    """Mismatched values between the saved slots and the reference
    adapter's over every checkpoint; inf where the window missed one."""
    if sorted(drv.saved) != drv.checkpoints:
        return float("inf")
    from portbench.reference.pogema_ref.grid_config import GridConfig
    from portbench.reference.pogema_ref.integrations.vector import VectorEnv

    cfg = drv.config
    bad = 0
    with reference.plain_precision():
        env = VectorEnv(GridConfig(**cfg["grid"]), drv.b, obs_layout=cfg["obs_layout"],
                        auto_reset_mode=cfg["auto_reset_mode"], maze=cfg["maze"],
                        device=drv.ctx.device, rows=drv.rows)
        env.reset(seed=drv.seed)
        for step in range(1, drv.checkpoints[-1] + 1):
            actions = drv.actions[(step - 1) % len(drv.actions)].reshape(drv.b, drv.n)
            out = env.step(actions[drv.rows].reshape(-1))
            if step in drv.saved:
                bad += mismatches(drv.saved[step], _slots(out, None, drv.b * drv.n))
    return float(bad)


def in_place(ctx, patches) -> list:
    """The check of the reference adapter run in the program's place with
    ``patches`` applied, through every checkpoint."""
    drv = Driver(ctx)
    drv.control = True
    with reference.patched(patches):
        drv.setup()
        while drv.count < drv.checkpoints[-1]:
            drv.unit()
    drv.release()
    return drv.check()


def post_reset_final_obs() -> list:
    """The classic auto-reset fault, planted in the reference: the
    terminal observation an ended env hands back is that of its new
    episode. Patches for :func:`reference.patched`."""
    from portbench.reference.pogema_ref.core import api

    whole = api.PogemaCore.step_autoreset

    def step_autoreset(self, state, initial_state, actions, with_obs=True):
        out = whole(self, state, initial_state, actions, with_obs)
        out[2].observations = out[1]
        return out

    return [(api.PogemaCore, "step_autoreset", step_autoreset)]


def planted(ctx, impl, seconds, measure):
    """Checks of the control ('control': the reference adapter in the
    program's place with the rim's SAME_STEP guarantee broken,
    :func:`post_reset_final_obs`)."""
    if impl != "control":
        raise ValueError(f"no planted variant {impl!r} for vector traffic")
    return in_place(ctx, post_reset_final_obs())
