"""K1: the packed obstacle-window kernel, in CUDA for Hopper.

Port of the Pallas TPU kernel
``pogema_tpu/ops/pallas_windows.py::extract_windows_packed``. The kernel
is ``csrc/windows.cu`` (one block per env, the env's grid in shared
memory, coalesced f32 stores; its bound and design are in the source
note), built with nvcc at first use and called through ctypes.

``extract_windows_packed(grid, xy, w)`` returns f32[B, M, L] with each
window flattened row-major into lanes [0, w*w) and zeros after,
``L = 128 * ceil(w*w / 128)`` (128 for w <= 11, the TPU kernel's
contract). For tensors on the CPU it returns the plain version
``ops.windows.extract_windows_packed_ref``; for CUDA tensors it launches
the kernel or raises. ``extract_windows_packed.launches`` counts the
launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .windows import extract_windows_packed_ref, packed_lanes

# Largest dynamic shared memory a Hopper block can take (227 KB).
MAX_SMEM = 232448


def _lib():
    lib = build.load("windows")
    fn = lib.pogema_packed_windows
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def extract_windows_packed(grid: torch.Tensor, xy: torch.Tensor, w: int) -> torch.Tensor:
    """grid: u8[B, P, P], xy: i32[B, M, 2], w: odd window size.
    Returns f32[B, M, packed_lanes(w)]."""
    if grid.device.type == "cpu" and xy.device.type == "cpu":
        return extract_windows_packed_ref(grid, xy, w)
    if grid.device.type != "cuda" or xy.device != grid.device:
        raise ValueError(f"grid and xy must lie on one CUDA device, got {grid.device} and {xy.device}")
    if grid.dtype != torch.uint8 or xy.dtype != torch.int32:
        raise TypeError(f"need u8 grid and i32 xy, got {grid.dtype} and {xy.dtype}")
    if grid.dim() != 3 or grid.shape[1] != grid.shape[2]:
        raise ValueError(f"grid must be [B, P, P], got {tuple(grid.shape)}")
    if xy.dim() != 3 or xy.shape[0] != grid.shape[0] or xy.shape[2] != 2:
        raise ValueError(f"xy must be [B, M, 2] for B={grid.shape[0]}, got {tuple(xy.shape)}")
    if not (grid.is_contiguous() and xy.is_contiguous()):
        raise ValueError("grid and xy must be contiguous")
    if w < 1 or w % 2 == 0:
        raise ValueError(f"window must be odd and positive, got {w}")
    b, p, _ = grid.shape
    m = xy.shape[1]
    lanes = packed_lanes(w)
    if 8 * m + 4 * lanes + p * p > MAX_SMEM:
        raise ValueError(f"a {p}x{p} grid with {m} agents exceeds the 227 KB of shared memory of a block")
    out = torch.empty(b, m, lanes, dtype=torch.float32, device=grid.device)
    if b == 0 or m == 0:  # nothing to launch (and nothing counted)
        return out
    fn = _lib()
    with torch.cuda.device(grid.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(grid.data_ptr(), xy.data_ptr(), out.data_ptr(), b, p, m, w, lanes, stream)
    if rc != 0:
        raise RuntimeError(f"packed_windows_kernel launch failed: CUDA error {rc}")
    extract_windows_packed.launches += 1
    return out


extract_windows_packed.launches = 0
