"""The observation kernels, in CUDA for Hopper: K1 and K1b.

Both live in ``csrc/windows.cu`` (design and bounds in its source note),
are built with nvcc at first use and launched through ``ops/launch.py``.

``extract_windows_packed(grid, xy, w)`` (K1) is the port of the Pallas
TPU kernel ``pogema_tpu/ops/pallas_windows.py::extract_windows_packed``:
f32[B, M, L] with each obstacle window flattened row-major into lanes
[0, w*w) and zeros after, ``L = 128 * ceil(w*w / 128)`` (128 for
w <= 11, the TPU kernel's contract).

``packed_observation_cuda(grid, agents_xy, targets_xy, active, w)`` (K1b)
is the whole packed 'default' observation in one launch, f32[B, N,
3*w*w]: the function of ``pogema_tpu/core/obs.py::observe`` with
``obs_layout='packed'``.

For tensors on the CPU a wrapper returns its plain version
(``ops.windows.extract_windows_packed_ref`` /
``ops.windows.packed_observation_ref``); for CUDA tensors it launches the
kernel or raises. Either way it first refuses what the kernel does not
take (dtype, shape, contiguity, tensors on different devices), so a
caller's fault shows on the CPU too. ``<wrapper>.launches`` counts the
launches.

A block owns one env and a chunk of its centres; :func:`centres_per_block`
picks the chunk from B, M and the card's SM count.
"""

from __future__ import annotations

import torch

from . import launch
from .launch import I32, PTR
from .windows import extract_windows_packed_ref, packed_lanes, packed_observation_ref

# Launch parameters read off the ``k1_shapes`` phase of ``chip_smoke.py``
# on an H100 (its table is in PERF.md), per kernel: a block should write at
# least AMORTISE times the bytes of the grid it loads (a smaller chunk
# spends its time loading grids), and beyond that chunks grow only while
# the launch keeps FILL blocks per SM.
K1_AMORTISE, K1_FILL = 3, 32
K1B_AMORTISE, K1B_FILL = 8, 8
# K1b counts the active agents of a cell in the 8 high bits of a 16-bit
# cell up to K1B_NARROW_AGENTS agents per env, and in a 16-bit count array
# beside the obstacle bytes above (the split layout, csrc/windows.cu).
K1B_NARROW_AGENTS = 255
K1B_MAX_AGENTS = 65535
# An H100's shared memory per SM, and what the card holds back per
# resident block (CUDA occupancy rules for compute capability 9.0).
SMEM_PER_SM, SMEM_PER_BLOCK_RESERVED = 233472, 1024

_U8, _I32, _BOOL = (torch.uint8,), (torch.int32,), (torch.bool,)
_fns: dict = {}  # the shared-memory queries of csrc/windows.cu, bound by _prepare
_devices: dict = {}  # device index -> (_fns, SM count, most shared memory of a block)


def _prepare(device):
    """(the shared-memory queries, SM count, most dynamic shared memory of
    a block) for ``device``, which is made ready for launches the first
    time: large dynamic shared memory allowed, once and not per launch."""
    ready = _devices.get(device.index)
    if ready is None:
        init = launch.bind("windows", "pogema_windows_init")
        with torch.cuda.device(device):
            rc = init()
        if rc != 0:
            raise RuntimeError(f"cudaFuncSetAttribute failed: CUDA error {rc}")
        for name, args in (("pogema_packed_windows_smem", (I32,) * 2),
                           ("pogema_packed_observation_smem", (I32,) * 4)):
            _fns[name] = launch.bind("windows", name, *args)
        ready = (_fns, torch.cuda.get_device_properties(device).multi_processor_count,
                 launch.bind("windows", "pogema_windows_max_smem")())
        _devices[device.index] = ready
    return ready


def centres_per_block(b: int, m: int, sms: int, grid_bytes: int, row_bytes: int,
                      amortise: int, fill: int, multiple: int = 1) -> int:
    """Centres that one block of an env handles, a multiple of
    ``multiple`` and at most ``m``: at least as many as make the block's
    output ``amortise`` times the grid it loads, more while the launch
    still has ``fill`` blocks on each of ``sms`` SMs (a large batch reads
    each grid once or twice), and fewer only when the launch would leave
    SMs without a block (a batch of one or two envs)."""
    def rounded(mc):
        return min(m, max(multiple, mc // multiple * multiple))

    pays = -(-amortise * grid_bytes // row_bytes)
    fills = m // max(1, -(-fill * sms // max(b, 1)))
    mc = rounded(max(-(-pays // multiple) * multiple, fills))
    if b * -(-m // mc) < sms:
        mc = rounded(max(1, m // -(-sms // max(b, 1))))
    return mc


def observation_wide(n: int) -> bool:
    """K1b's cell layout for N agents per env: the split layout (16-bit
    counts) where an 8-bit count could overflow, the 16-bit cell where it
    cannot."""
    return n > K1B_NARROW_AGENTS


def observation_smem_bytes(p: int, w: int, mc: int, wide: bool) -> int:
    """Dynamic shared memory of a K1b block, as
    ``csrc/windows.cu::observation_smem_bytes`` reckons it: 2 bytes a cell
    (with room to skew), 16 per agent of the chunk and one more, the row's
    decode table, and for the split layout the obstacle bytes too."""
    def up16(v):
        return -(-v // 16) * 16

    return (up16(2 * (p * p + 4)) + 16 * (mc + 1) + up16(4 * 3 * w * w)
            + (p * p + 16 if wide else 0))


def observation_fill(p: int, w: int, n: int) -> int:
    """Blocks per SM that K1b's chunk picker aims for: K1B_FILL, or fewer
    where shared memory holds fewer blocks of the largest chunk (N agents)."""
    block = observation_smem_bytes(p, w, n, observation_wide(n)) + SMEM_PER_BLOCK_RESERVED
    return max(1, min(K1B_FILL, SMEM_PER_SM // block))


def _check_shapes(grid, per_agent, w: int):
    """Refuse the shapes neither kernel takes. ``per_agent``: (name,
    tensor, trailing shape) of each [B, N, ...] input."""
    if grid.dim() != 3 or grid.shape[1] != grid.shape[2]:
        raise ValueError(f"grid must be [B, P, P], got {tuple(grid.shape)}")
    lead = (grid.shape[0], per_agent[0][1].shape[1] if per_agent[0][1].dim() > 1 else -1)
    for name, t, tail in per_agent:
        if tuple(t.shape) != lead + tail:
            raise ValueError(f"{name} must be [B, N{''.join(f', {d}' for d in tail)}] with "
                             f"B={lead[0]} and the same N as the others, got {tuple(t.shape)}")
    if w < 1 or w % 2 == 0:
        raise ValueError(f"window must be odd and positive, got {w}")


def _launch_windows(grid, xy, w: int, mc: int) -> torch.Tensor:
    """One K1 launch with ``mc`` centres per block, on inputs that
    :func:`extract_windows_packed` has checked."""
    b, p, _ = grid.shape
    m = xy.shape[1]
    lanes = packed_lanes(w)
    fns, _, max_smem = _prepare(grid.device)
    if not 1 <= mc <= m:
        raise ValueError(f"centres per block must be in [1, {m}], got {mc}")
    if fns["pogema_packed_windows_smem"](p, mc) > max_smem:
        raise ValueError(f"a {p}x{p} grid with {mc} centres per block exceeds the 227 KB of "
                         f"shared memory of a block")
    out = torch.empty(b, m, lanes, dtype=torch.float32, device=grid.device)
    _K1(grid.device, grid.data_ptr(), xy.data_ptr(), out.data_ptr(), b, p, m, w, lanes, mc)
    return out


def extract_windows_packed(grid: torch.Tensor, xy: torch.Tensor, w: int) -> torch.Tensor:
    """K1. grid: u8[B, P, P], xy: i32[B, M, 2], w: odd window size.
    Returns f32[B, M, packed_lanes(w)]."""
    launch.check(("grid", grid, _U8), ("xy", xy, _I32))
    _check_shapes(grid, (("xy", xy, (2,)),), w)
    if grid.device.type == "cpu":
        return extract_windows_packed_ref(grid, xy, w)
    b, p, _ = grid.shape
    m = xy.shape[1]
    if b == 0 or m == 0:  # nothing to launch (and nothing counted)
        return torch.empty(b, m, packed_lanes(w), dtype=torch.float32, device=grid.device)
    sms = _prepare(grid.device)[1]
    return _launch_windows(grid, xy, w, centres_per_block(b, m, sms, p * p, 4 * packed_lanes(w),
                                                          K1_AMORTISE, K1_FILL))


_K1 = launch.Kernel("windows", "pogema_packed_windows", (PTR,) * 3 + (I32,) * 6,
                    "packed_windows_kernel", extract_windows_packed)


def _launch_observation(grid, agents_xy, targets_xy, active, w: int, mc: int) -> torch.Tensor:
    """One K1b launch with ``mc`` agents per block, on inputs that
    :func:`packed_observation_cuda` has checked."""
    b, p, _ = grid.shape
    n = agents_xy.shape[1]
    wide = observation_wide(n)
    fns, _, max_smem = _prepare(grid.device)
    if not 1 <= mc <= n:
        raise ValueError(f"agents per block must be in [1, {n}], got {mc}")
    if fns["pogema_packed_observation_smem"](p, w, mc, wide) > max_smem:
        raise ValueError(f"a {p}x{p} grid with {mc} agents per block exceeds the 227 KB of "
                         f"shared memory of a block")
    out = torch.empty(b, n, 3 * w * w, dtype=torch.float32, device=grid.device)
    _K1B(grid.device, grid.data_ptr(), agents_xy.data_ptr(), targets_xy.data_ptr(),
         active.data_ptr(), out.data_ptr(), b, p, n, w, mc, int(wide))
    return out


def packed_observation_cuda(grid: torch.Tensor, agents_xy: torch.Tensor,
                            targets_xy: torch.Tensor, active: torch.Tensor, w: int) -> torch.Tensor:
    """K1b. grid: u8[B, P, P]; agents_xy, targets_xy: i32[B, N, 2];
    active: bool[B, N]; w: odd window size. Returns f32[B, N, 3*w*w], the
    [obstacles | agents | target] blocks back to back.

    Precondition on the card: every active agent lies inside the P x P
    grid (states of the env keep every agent inside the padded border).
    The kernel counts agents into a grid, so an active agent outside the
    grid is seen by nobody, while the plain version, which compares
    agents pairwise as the JAX package does, would still show it to a
    neighbour that is outside as well. Up to 255 agents per env a cell's
    count has 8 bits, above that 16 (:func:`observation_wide`): on the
    card more than 65535 agents per env are refused."""
    launch.check(("grid", grid, _U8), ("agents_xy", agents_xy, _I32),
                 ("targets_xy", targets_xy, _I32), ("active", active, _BOOL))
    _check_shapes(grid, (("agents_xy", agents_xy, (2,)), ("targets_xy", targets_xy, (2,)),
                         ("active", active, ())), w)
    if grid.device.type == "cpu":
        return packed_observation_ref(grid, agents_xy, targets_xy, active, w)
    b, p, _ = grid.shape
    n = agents_xy.shape[1]
    if w > 255:
        raise ValueError(f"window must be at most 255, got {w}")
    if n > K1B_MAX_AGENTS:
        raise ValueError(f"the kernel counts at most {K1B_MAX_AGENTS} agents on a cell and so "
                         f"takes at most {K1B_MAX_AGENTS} agents per env, got {n}")
    if b == 0 or n == 0:
        return torch.empty(b, n, 3 * w * w, dtype=torch.float32, device=grid.device)
    sms = _prepare(grid.device)[1]
    # Chunks of four agents start on 16-byte boundaries of the output.
    return _launch_observation(grid, agents_xy, targets_xy, active, w,
                               centres_per_block(b, n, sms, p * p, 12 * w * w, K1B_AMORTISE,
                                                 observation_fill(p, w, n), multiple=4))


_K1B = launch.Kernel("windows", "pogema_packed_observation", (PTR,) * 5 + (I32,) * 6,
                     "packed_observation_kernel", packed_observation_cuda)
