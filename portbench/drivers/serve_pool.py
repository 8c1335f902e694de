"""Checkpoint evaluation on a pool of maps: ``drivers/serve.py``'s greedy
episodes, one after another, each from a new key drawn from (``--seed``,
episode index), its reset included, with every world drawn from a map
bank.

Set-up builds the bank once, from the configuration's ``map_bank``
(a pool function of ``pogema_torch.maps`` and its arguments), as it
loads the served weights once, and hands that one array to the program
and to the reference. The check is ``serve.compare`` with the bank given
to the reference's core, and nothing else changed. The counters add the
generator's flood-fill sweeps and placement tries to the collisions'
passes and K1b's launches.
"""

from __future__ import annotations

import functools
import time

import torch

from portbench import reference
from portbench.harness import load_module

serve = load_module("drivers", "serve")


class Driver(serve.Driver):
    def setup(self):
        """``serve.Driver.setup`` with the bank built and handed to the
        core, and the configuration's observation layout."""
        from pogema_torch import GridConfig, PogemaCore, maps
        from pogema_torch.core import collisions, generator
        from pogema_torch.interop import load_policy
        from pogema_torch.ops import cuda_windows
        from pogema_torch.parallel import make_policy_evaluator

        spec = dict(self.config["map_bank"])
        self.bank = getattr(maps, spec.pop("pool"))(**spec)
        self.collisions, self.k1b = collisions, cuda_windows.packed_observation_cuda
        self.generator = generator
        dev = self.ctx.device
        self.core = PogemaCore(GridConfig(**self.config["grid"]), num_envs=self.b,
                               map_bank=self.bank, device=dev,
                               obs_layout=self.config["obs_layout"])
        self.rows_t = torch.tensor(self.rows, device=dev)
        self.recorder = serve._Recorder(load_policy(self.weights, device=dev, dtype=self.dtype),
                                        self.rows_t)
        self.run = make_policy_evaluator(self.core, self.recorder,
                                         greedy=self.traffic["greedy"])
        for _ in range(self.traffic["warmup_episodes"]):
            self._episode(self.ctx.key(serve.RESET), keep=False)

    def counters(self) -> dict:
        """The served cell's counters, and the generator's where the
        program counts them (a program without them reads nothing)."""
        out = super().counters()
        for name, fn in (("sweeps", self.generator.connected_components),
                         ("tries", self.generator.generate_env)):
            value = getattr(fn, name, None)
            if value is not None:
                out[name] = value
        return out

    def check(self) -> list:
        lim = self.ctx.cell.limits
        err, gap, bad = compare(self, self.checked_episodes(), self.control)
        return [("logit_err_max", err, lim["logit_err_max"]),
                ("served_gap_max", gap, lim["served_gap_max"]),
                ("state_mismatches", bad, lim["state_mismatches"])]


def compare(drv, episodes, control=None) -> tuple:
    """``serve.compare``, with the reference's core drawing every world
    from the bank that set-up built, as the program's does."""
    from portbench.reference.pogema_ref.core import api

    core = functools.partial(api.PogemaCore, map_bank=drv.bank)
    with reference.patched([(api, "PogemaCore", core)]):
        return serve.compare(drv, episodes, control)


def planted(ctx, impl, seconds, measure):
    """Checks of the control ('control': the reference's bf16 policy with
    fp8 weights in the program's place, at the served states and actions
    of a short window)."""
    if impl != "control":
        raise ValueError(f"no planted variant {impl!r} for served traffic")
    drv = Driver(ctx)
    drv.control = reference.fp8_patches()
    return measure(ctx, seconds, time.time(), drv)[1]
