"""Rollout, PPO learner and optimizer of the reference."""
