"""Adapters of the reference that hand its envs to a learner."""
