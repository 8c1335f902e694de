"""Cells of BENCHMARK.json cut to sizes a CPU test can hold (the
configuration's kinds and the traffic's driver unchanged)."""

from portbench import harness

TINY = {
    "C.random": dict(num_envs=16, grid=dict(size=16, num_agents=32, obs_radius=2,
                                              max_episode_steps=16),
                     traffic=dict(check_within_steps=40, check_envs=8, trace_steps=4)),
    "D.serve": dict(num_envs=8, grid=dict(size=12, num_agents=8, max_episode_steps=32),
                    traffic=dict(check_envs=8)),
    "D.train": dict(num_envs=8, grid=dict(size=10, num_agents=4, max_episode_steps=16),
                    train=dict(rollout_steps=4, minibatches=2)),
}


# Cells whose files the benchmark keeps but BENCHMARK.json leaves out
# (their end-to-end rate spreads wider than any bound allows; PERF.md):
# their drivers, checks and readers are still tested here.
SHELVED = {
    "D.train": {"name": "D.train", "config": "D_lifelong64_a128", "traffic": "train",
                "chips": 1, "why": "recurrent PPO steps on 1024 envs"},
}


def cell(name: str, manifest=None) -> harness.Cell:
    manifest = manifest or harness.load_manifest()
    if name in SHELVED and name not in {w["name"] for w in manifest["workloads"]}:
        manifest = dict(manifest, workloads=manifest["workloads"] + [SHELVED[name]])
    c = harness.Cell(manifest, name)
    t = TINY[name]
    c.config["num_envs"] = t["num_envs"]
    c.config["grid"].update(t["grid"])
    if "train" in t:
        c.config["train"].update(t["train"])
    c.traffic.update(t.get("traffic", {}))
    return c


def run(c, seed=2**31 + 17, trace=False, seconds=0.3, driver=None, world=1, rank=0):
    ctx = harness.Context(c, seed, "cpu", trace, rank=rank, world=world)
    return harness.measure(ctx, seconds, 0.0, driver(ctx) if driver else None)


def correct(checks) -> bool:
    return bool(checks) and all(v <= lim for _, v, lim in checks)
