"""Plain PyTorch ops and the hand-written CUDA kernels.

``<name>.py`` (``windows``, ``threefry``, ``collisions``) is a plain
version in PyTorch. ``cuda_<name>.py`` is the wrapper of its kernels in
``csrc/<name>.cu``: it refuses what a kernel does not take, returns the
plain version for CPU tensors and launches the kernel for CUDA ones.
``launch.py`` is the seam every wrapper launches through (binding, the
launch on the current stream, the refusals they share); ``build.py``
compiles ``csrc/*.cu`` with nvcc.
"""

from .windows import extract_windows, neighborhoods3x3, pairwise_agent_windows

__all__ = ["extract_windows", "neighborhoods3x3", "pairwise_agent_windows"]
