"""Window ops (plain PyTorch) and the hand-written CUDA kernels."""

from .windows import extract_windows, neighborhoods3x3, pairwise_agent_windows

__all__ = ["extract_windows", "neighborhoods3x3", "pairwise_agent_windows"]
