"""Batched evaluation of policies on one device."""

from .evaluator import make_policy_evaluator

__all__ = ["make_policy_evaluator"]
