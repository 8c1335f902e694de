"""Batched-env traffic with a new world every episode: uniform random
actions through ``PogemaCore.step_autoreset`` under
``auto_reset_mode='regen'``, one step after another.

This is ``drivers/env_random.py``'s actor loop (the same actions, seed
streams, sampled rows and check) on a core that regenerates every ended
env's maze and placement inside the step, as an RL learner that trains
on fresh worlds pays for it. With random actions no env finishes its
agents, so every env's episode is cut at ``max_episode_steps`` and the
whole batch is regenerated on every such step. The warm-up runs past
the first of them, so that the window pays no first regeneration's
warm-up; in the window the driver also times each step on which an env
ended (``phases["regen_step"]``), to the sync the unit makes.

The check is ``env_random``'s over the sampled rows, against the
reference's own regen reset, at the drawn steps and always at the first
ending step and the step after it: the regenerated world, both
observations of the ending step and the first step on the new world.
"""

from __future__ import annotations

import time

import torch

from portbench import harness, reference

env_random = harness.load_module("drivers", "env_random")


class Driver(env_random.Driver):
    def __init__(self, ctx):
        super().__init__(ctx)
        # Every env's episode is cut at max_episode_steps, so the first
        # ending step is that step from the reset.
        self.first_end = self.config["grid"]["max_episode_steps"]
        self.checkpoints = sorted(set(self.checkpoints) | {self.first_end, self.first_end + 1})
        self.phases = {"regen_step": []}
        self.timing = False

    def setup(self):
        from pogema_torch.core import api, generator

        self.regen, self.generate = api.PogemaCore._regen_reset, generator.generate_env
        super().setup()
        self.timing = True

    def unit(self):
        self.count += 1
        t = time.perf_counter()
        out = self.core.step_autoreset(self.state, self.init, self._actions(self.gen))
        self.state = out[0]
        if self.count in self.checkpoints:
            self.saved[self.count] = env_random._rows(out, torch.tensor(self.rows,
                                                                        device=self.ctx.device))
        self.ctx.sync()
        seconds = time.perf_counter() - t
        if self.timing and bool(out[3].any()):
            self.phases["regen_step"].append(seconds)

    def counters(self) -> dict:
        """K1b's launches, and the regen counters where the program has
        them (a program without them reads nothing there)."""
        out = {"k1b_launches": self.k1b.launches}
        for name, fn, attr in (("regen_envs", self.regen, "envs"),
                               ("unplaced", self.generate, "unplaced")):
            value = getattr(fn, attr, None)
            if value is not None:
                out[name] = value
        return out

    def traced_slice(self) -> int:
        self.timing = False
        return super().traced_slice()

    def check(self) -> list:
        ends = {self.first_end, self.first_end + 1}
        value = env_random.compare(self) if ends <= set(self.saved) else float("inf")
        return [("mismatched_values", value, self.ctx.cell.limits["mismatched_values"])]


def planted(ctx, impl, seconds, measure):
    """Checks of a planted variant, the reference in the program's place
    with one patch, through every checkpoint: 'control' gives an ended
    env its reset-time world back (the cached reset in place of the regen
    reset), 'stale_key' regenerates it from its key as it was, not
    advanced."""
    from portbench.reference.pogema_ref.core import api

    patches = {"control": [(api.PogemaCore, "_regen_reset", api.PogemaCore._cached_reset)],
               "stale_key": [(api, "_advance_key", lambda keys: keys)]}.get(impl)
    if patches is None:
        raise ValueError(f"no planted variant {impl!r} for regen traffic")
    drv = Driver(ctx)
    drv.control = True
    with reference.patched(patches):
        drv.setup()
        while drv.count < drv.checkpoints[-1]:
            drv.unit()
    drv.release()
    return drv.check()
