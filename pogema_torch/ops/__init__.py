"""Plain PyTorch ops and the hand-written CUDA kernels.

``<name>.py`` (``windows``, ``threefry``, ``collisions``, ``components``,
``placement``) is a plain version in PyTorch. ``cuda_<name>.py`` is the wrapper of its
kernels in ``csrc/<name>.cu``: it refuses what a kernel does not take,
returns the plain version for CPU tensors and launches the kernel for
CUDA ones.
``cuda_policy.py``'s plain version is the model's own step
(``RecurrentEmbedActorCritic.step_from_obs``), which it calls and does
not import. ``launch.py`` is the seam every wrapper launches through (binding, the
launch on the current stream, the refusals they share); ``build.py``
compiles ``csrc/*.cu`` with nvcc (``csrc/threefry.cuh``, the hash's device
function, is shared by the threefry and placement kernels).
"""

from .windows import extract_windows, neighborhoods3x3, pairwise_agent_windows

__all__ = ["extract_windows", "neighborhoods3x3", "pairwise_agent_windows"]
