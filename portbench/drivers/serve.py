"""Checkpoint evaluation: greedy episodes of the shipped recurrent policy
through ``make_policy_evaluator``, one after another, each from a new
key drawn from (``--seed``, episode index), its reset included.

The harness hands the evaluator the loaded policy behind a thin
recorder that keeps, at every policy step, the logits of a sample of
envs (rows drawn from the seed), and keeps those rows of each episode's
final state and metrics. The check takes episodes drawn from the seed
among those the window finished and runs the reference over the same
rows: its own reset from the episode's key, its own bf16 policy from
the shipped weights, and the env step driven by the program's served
(greedy) actions. It compares at every step the program's logits with
the reference's (``logit_err_max``) and how far the reference's logit
of the served action lies below its best (``served_gap_max``), and at
the end the final state and the episode metrics exactly
(``state_mismatches``).
"""

from __future__ import annotations

import torch

from portbench import reference
from portbench.harness import ROOT

RESET, SAMPLE = 1, 3
EPISODE_STREAM = 1000  # episode e draws its key from stream 1000 + e


class _Recorder:
    """The policy as the evaluator sees it, keeping the logits of ``rows``."""

    def __init__(self, model, rows):
        self.model, self.rows = model, rows
        self.logits = None

    def initial_carry(self, batch_shape, device=None):
        self.logits = []
        return self.model.initial_carry(batch_shape, device=device)

    def step_from_state(self, *args):
        h, logits, value = self.model.step_from_state(*args)
        self.logits.append(logits.index_select(0, self.rows))
        return h, logits, value


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.config, self.traffic = ctx.config, ctx.traffic
        g = self.config["grid"]
        self.b, self.n, self.t = self.config["num_envs"], g["num_agents"], g["max_episode_steps"]
        pol = self.config["policy"]
        self.shapes = {"B": self.b, "N": self.n, "W": 2 * g["obs_radius"] + 1,
                       "P": g["size"] + 2 * g["obs_radius"], "embed": pol["embed"],
                       "hidden": pol["hidden"]}
        self.work = {"env_steps": self.b * self.t, "steps": self.t}
        self.rows = sorted(ctx.rng(SAMPLE).choice(self.b, self.traffic["check_envs"],
                                                  replace=False).tolist())
        self.weights = str(ROOT / pol["weights"])
        self.dtype = getattr(torch, pol["dtype"])
        self.episodes = []  # per episode: (key, logits [T, R, N, 5], final rows, metric rows)
        self.control = None  # patches of the reference that take the program's place (calibration)

    def setup(self):
        from pogema_torch import GridConfig, PogemaCore
        from pogema_torch.core import collisions
        from pogema_torch.interop import load_policy
        from pogema_torch.ops import cuda_windows
        from pogema_torch.parallel import make_policy_evaluator

        self.collisions, self.k1b = collisions, cuda_windows.packed_observation_cuda
        dev = self.ctx.device
        self.core = PogemaCore(GridConfig(**self.config["grid"]), num_envs=self.b, device=dev)
        self.rows_t = torch.tensor(self.rows, device=dev)
        self.recorder = _Recorder(load_policy(self.weights, device=dev, dtype=self.dtype),
                                  self.rows_t)
        self.run = make_policy_evaluator(self.core, self.recorder,
                                         greedy=self.traffic["greedy"])
        for _ in range(self.traffic["warmup_episodes"]):
            self._episode(self.ctx.key(RESET), keep=False)

    def _episode(self, key, keep=True):
        state, metrics = self.run(key)
        if keep:
            rows = self.rows_t
            self.episodes.append((key, torch.stack(self.recorder.logits),
                                  {k: v.index_select(0, rows) for k, v in state.tensors().items()},
                                  {k: v.index_select(0, rows) for k, v in metrics.items()}))
        self.ctx.sync()

    def unit(self):
        self._episode(self.ctx.key(EPISODE_STREAM + len(self.episodes)))

    def counters(self) -> dict:
        return {"fixpoint_passes": self.collisions.fixpoint.passes,
                "k1b_launches": self.k1b.launches}

    def traced_slice(self) -> int:
        for _ in range(self.traffic["trace_episodes"]):
            self.unit()
        return self.traffic["trace_episodes"]

    def release(self):
        del self.core, self.recorder, self.run
        if self.ctx.device.startswith("cuda"):
            torch.cuda.empty_cache()

    def checked_episodes(self) -> list:
        """Episodes drawn from the seed among those the window finished."""
        k = min(self.traffic["check_episodes"], len(self.episodes))
        idx = self.ctx.rng(SAMPLE + 1).choice(len(self.episodes), k, replace=False)
        return [self.episodes[i] for i in sorted(idx.tolist())]

    def check(self) -> list:
        lim = self.ctx.cell.limits
        err, gap, bad = compare(self, self.checked_episodes(), self.control)
        return [("logit_err_max", err, lim["logit_err_max"]),
                ("served_gap_max", gap, lim["served_gap_max"]),
                ("state_mismatches", bad, lim["state_mismatches"])]


def compare(drv, episodes, control=None) -> tuple:
    """(largest |program logit - reference logit|, largest gap of a served
    action's reference logit below the reference's best, mismatched
    values of the final state and metrics). With ``control`` (patches
    of the reference, ``reference.fp8_patches()``), the patched
    reference's logits take the program's place in the first two
    readings, at the same states and served actions."""
    if not episodes:
        return float("inf"), float("inf"), float("inf")
    from portbench.reference.pogema_ref.core import api, metrics as metrics_mod
    from portbench.reference.pogema_ref.core import random as jr, step as step_mod
    from portbench.reference.pogema_ref.grid_config import GridConfig

    dev = drv.ctx.device
    rows = torch.tensor(drv.rows, device=dev)
    err = gap = 0.0
    bad = 0
    with reference.plain_precision(), torch.no_grad():
        core = api.PogemaCore(GridConfig(**drv.config["grid"]), num_envs=len(drv.rows),
                              device=dev)
        cfg = core.cfg
        model = reference.recurrent_model(drv.weights, dev, drv.dtype)
        for key, logits_prog, final, final_metrics in episodes:
            state = core._reset_envs(jr.split(key.to(dev), drv.b).index_select(0, rows))
            h = model.initial_carry((len(drv.rows), cfg.num_agents), device=dev)
            hc = h.clone()
            for t in range(cfg.max_episode_steps):
                done = step_mod.episode_done(cfg, state)
                args = (state.obstacles, state.agents_xy, state.targets_xy, state.active)
                h, ref, _ = model.step_from_state(*args, h)
                served = logits_prog[t].to(dev)
                if control is not None:
                    with reference.patched(control):
                        hc, cand, _ = model.step_from_state(*args, hc)
                else:
                    cand = served
                act = served.argmax(dim=-1)
                first = cand.argmax(dim=-1)
                err = max(err, float((cand - ref).abs().max()))
                gap = max(gap, float((ref.max(dim=-1).values
                                      - ref.gather(-1, first[..., None])[..., 0]).max()))
                new_state, _ = step_mod.step(cfg, state, act.to(torch.int32), with_obs=False)
                state = api.select_state(done, state, new_state)
            bad += reference.mismatches(final, state.tensors())
            bad += reference.mismatches(final_metrics, metrics_mod.episode_metrics(cfg, state))
    return err, gap, float(bad)


def planted(ctx, impl, seconds, measure):
    """Checks of the control ('control': the reference's bf16 policy with
    fp8 weights in the program's place, at the served states and
    actions of a short window)."""
    if impl != "control":
        raise ValueError(f"no planted variant {impl!r} for served traffic")
    drv = Driver(ctx)
    drv.control = reference.fp8_patches()
    return measure(ctx, seconds, __import__("time").time(), drv)[1]
