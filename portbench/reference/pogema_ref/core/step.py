"""Environment semantics for B envs at once: reset, step, episode end.

Counterpart of ``pogema_tpu/core/step.py`` (which works on one env under
vmap). One step:
  1. collision-resolved movement (``collisions.resolve_moves``);
  2. the ``on_target`` rule:
       'finish'  — reward 1.0 on arrival, the agent is hidden
                   (deactivated) and terminated;
       'nothing' — no reward; everyone terminates when all agents stand
                   on their goals at once;
       'restart' — reward 1.0 per goal, the next goal is read from the
                   agent's pre-drawn queue at its head pointer (LifeLong);
  3. the step counter and truncation at max_episode_steps;
  4. observations of the new state (``observe_state``).
"""

from __future__ import annotations

import torch

from ..grid_config import StaticConfig
from . import collisions, generator, random as jr
from .obs import observe
from .types import EnvState, StepResult


def _queue_len(cfg: StaticConfig) -> int:
    # One goal per step at most, so max_episode_steps entries suffice;
    # longer episodes wrap the queue (its seam is built distinct).
    return min(cfg.max_episode_steps, 64)


def reset(cfg: StaticConfig, keys, fixed_map=None, fixed_agents_xy=None,
          fixed_targets_xy=None, maze: bool = False, map_bank=None) -> EnvState:
    """Fresh EnvState for B envs, one key each (int64[B, 2])."""
    k = jr.split(keys, 3)
    key, gen_key, queue_key = k[:, 0], k[:, 1], k[:, 2]
    grid, agents_xy, targets_xy, comps, ok = generator.generate_env(
        cfg, gen_key, fixed_map, fixed_agents_xy, fixed_targets_xy, maze, map_bank)
    b = keys.shape[0]
    n = cfg.num_agents
    dev = keys.device
    target_queue = None
    if cfg.on_target == "restart":
        p = cfg.padded_size
        table = generator.build_respawn_table(comps, p)
        target_queue = generator.build_target_queue(
            queue_key, table, comps, generator.xy_to_cells(targets_xy, p),
            _queue_len(cfg), p)
    return EnvState(
        obstacles=grid.contiguous(),
        agents_xy=agents_xy.contiguous(),
        targets_xy=targets_xy.contiguous(),
        target_queue=target_queue,
        active=torch.ones(b, n, dtype=torch.bool, device=dev),
        terminated=torch.zeros(b, n, dtype=torch.bool, device=dev),
        on_goal_ever=torch.zeros(b, n, dtype=torch.bool, device=dev),
        goals_achieved=torch.zeros(b, n, dtype=torch.int32, device=dev),
        step_count=torch.zeros(b, dtype=torch.int32, device=dev),
        key=key.contiguous(),
        placement_ok=ok,
    )


def observe_state(cfg: StaticConfig, state: EnvState):
    return observe(cfg, state.obstacles, state.agents_xy, state.targets_xy, state.active)


def step(cfg: StaticConfig, state: EnvState, actions, with_obs: bool = True):
    """One step of B envs. actions: int[B, N] in [0, 5). Returns
    (EnvState, StepResult); the observations are None with
    ``with_obs=False``."""
    p = cfg.padded_size
    n = cfg.num_agents
    new_xy = collisions.resolve_moves(cfg, state.obstacles, state.agents_xy,
                                      state.active, actions)
    at_goal = (new_xy == state.targets_xy).all(dim=-1)
    on_goal = at_goal & state.active

    active = state.active
    terminated = state.terminated
    targets_xy = state.targets_xy
    goals_achieved = state.goals_achieved + on_goal.to(torch.int32)
    on_goal_ever = state.on_goal_ever | on_goal

    if cfg.on_target == "finish":
        rewards = on_goal.to(torch.float32)
        terminated = terminated | on_goal
        active = active & ~on_goal
    elif cfg.on_target == "nothing":
        rewards = torch.zeros(on_goal.shape, dtype=torch.float32, device=on_goal.device)
        terminated = at_goal.all(dim=-1, keepdim=True).expand(-1, n).clone()
    else:  # 'restart' (LifeLong): the k-th goal is queue[(k-1) mod Q]
        rewards = on_goal.to(torch.float32)
        queue = state.target_queue
        head = torch.remainder(goals_achieved.long() - 1, queue.shape[-1])
        new_cells = queue.gather(2, head[..., None])[..., 0].long()
        new_targets = generator.cells_to_xy(new_cells, p)
        targets_xy = torch.where(on_goal[..., None], new_targets, targets_xy)

    step_count = state.step_count + 1
    truncated = (step_count >= cfg.max_episode_steps)[:, None].expand(-1, n).clone()

    new_state = state.replace(
        agents_xy=new_xy,
        targets_xy=targets_xy,
        active=active,
        terminated=terminated,
        on_goal_ever=on_goal_ever,
        goals_achieved=goals_achieved,
        step_count=step_count,
    )
    obs = observe_state(cfg, new_state) if with_obs else None
    return new_state, StepResult(observations=obs, rewards=rewards,
                                 terminated=terminated, truncated=truncated)


def episode_done(cfg: StaticConfig, state: EnvState) -> torch.Tensor:
    """bool[B]: all agents terminated or the time limit hit."""
    timeout = state.step_count >= cfg.max_episode_steps
    if cfg.on_target == "restart":
        return timeout
    return state.terminated.all(dim=-1) | timeout
