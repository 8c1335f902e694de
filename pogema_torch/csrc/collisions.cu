// K2, priority_kernel: the 'priority' collision rule of the port's step
// (pogema_torch/core/collisions.py), for NVIDIA Hopper (sm_90a).
//
// It replaces no Pallas kernel. The JAX package resolves 'priority' in
// pogema_tpu/core/collisions.py: propose (the obstacle check, through
// nibble-packed one-hot matmuls on the TPU), _priority_fixpoint_setup
// (bit-packed [N, N] conflict matrices) and _peel_then_fixpoint (a
// while_loop of Jacobi passes), all inside resolve_priority. The port's
// plain version iterates the same fixpoint over bool [B, N, N] matrices
// and tests convergence on the host once a pass: 3 to 4.5 host syncs and
// about 1-3.5 ms of device time a step at the benchmark's shapes.
//
// What it computes, for B envs of N agents on P x P grids: the rule whose
// unique fixpoint that iteration finds, stated sequentially. Agents are
// taken in index order; agent i moves to its proposed cell iff it is
// active, its action lies in [1, 5) (0 stays, any other value too), the
// cell is not an obstacle (a cell outside the grid is not one, as in the
// plain version; the padded border keeps every proposal inside), and no
// active agent occupies the cell at i's turn: agents j < i on the cells
// they ended on, agents j > i on their old cells. Inactive agents block
// nothing. out[b, i] is the proposed cell where i moved, else its cell.
//
// Bound: launch latency. The least bytes are each agent's row read and
// written (8 bytes of position, 1 of the active flag, 4 or 8 of its
// action, 8 written) and one 32-byte sector of the grid at its target:
// 13.9 MB at B = 4096, N = 64 and at B = 1024, N = 256, so about 4 us at
// 3.35 TB/s. The work is about N^2 / 32 compares a lane, a few thousand
// cycles at N = 256, and one launch a step.
//
// Design: one warp per env, and no occupancy grid to clear, so nothing
// but the grid reads depends on P. Each lane owns the agents
// j = lane + 32m and keeps two int32 for each: the flat cell it holds
// now, f (EMPTY while inactive), and the flat cell it proposes, t (EMPTY
// where it does not move). Up to 256 agents an env (8 a lane) they live
// in registers, above that in shared memory, and in a global scratch
// buffer where they outgrow a block's default 48 KB. A lane first loads
// the rows of its agents (in batches, so that their loads are in flight
// together), reads the grid at each mover's target and writes the
// proposed cell for every mover. Then the agents are taken in index
// order, movers only: the owner lane broadcasts t[i] by a shuffle, every
// lane compares it with the f of its own agents, and a vote decides; if
// no agent holds the cell, the owner sets f[i] = t[i]. Comparing against
// f[i] itself is harmless, since a mover's t[i] differs from its own
// cell. Each slot is read and written by its own lane only, so the warp
// needs no barrier. Last, each mover that stayed blocked writes its own
// cell back.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kRegisterChunks = 8;     // up to 256 agents an env in registers
constexpr int kSmemBytes = 48 * 1024;  // dynamic shared memory without an opt-in
constexpr int32_t kEmpty = -2147483647 - 1;  // no cell: a flat cell lies in [-P, P*P + P)
constexpr unsigned kFull = 0xFFFFFFFFu;

// A lane's slots of one quantity: the agents lane + 32m, m < chunks. In
// registers where K > 0 (every index a constant once the loops over m
// unroll), else in memory with the lane's slots 32 int32 apart.
template <int K>
struct Slots {
  int32_t v[K];
  __device__ __forceinline__ void bind(int32_t*) {}
  __device__ __forceinline__ int32_t& operator[](int m) { return v[m]; }
};

template <>
struct Slots<0> {
  int32_t* v;
  __device__ __forceinline__ void bind(int32_t* lane_base) { v = lane_base; }
  __device__ __forceinline__ int32_t& operator[](int m) { return v[32 * m]; }
};

// MOVES: 0 stay, 1 up (-1, 0), 2 down (1, 0), 3 left (0, -1), 4 right (0, 1);
// any other action stays.
__device__ __forceinline__ long long action_at(const void* actions, bool actions_i64,
                                               long long row) {
  return actions_i64 ? static_cast<const int64_t*>(actions)[row]
                     : static_cast<long long>(static_cast<const int32_t*>(actions)[row]);
}

// K > 0: N <= 32K agents an env, slots in registers. K = 0: any N, slots
// in shared memory, or in `scratch` (int32[B, 2, 32 * chunks]) if given.
template <int K>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
priority_kernel(const uint8_t* __restrict__ obstacles, const int32_t* __restrict__ xy,
                const uint8_t* __restrict__ active, const void* __restrict__ actions,
                bool actions_i64, int32_t* __restrict__ out, int32_t* __restrict__ scratch,
                int b, int n, int p, int warps) {
  extern __shared__ int32_t smem[];
  constexpr int kBatch = K > 0 ? K : 4;  // agents a lane loads before it waits
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int env = blockIdx.x * warps + warp;
  if (env >= b) return;  // the whole warp
  const int chunks = K > 0 ? K : (n + 31) / 32;
  const long long first = static_cast<long long>(env) * n;
  const uint8_t* grid = obstacles + static_cast<long long>(env) * p * p;
  // f: the cell an agent holds now (kEmpty while inactive); t: the cell it
  // proposes (kEmpty where it does not move). Slots past N hold kEmpty.
  Slots<K> f, t;
  if (K == 0) {
    int32_t* base = scratch != nullptr ? scratch + 64LL * chunks * env : smem + 64 * chunks * warp;
    f.bind(base + lane);
    t.bind(base + 32 * chunks + lane);
  }

#pragma unroll
  for (int m0 = 0; m0 < chunks; m0 += kBatch) {
    int x[kBatch], y[kBatch], dx[kBatch], dy[kBatch];
    bool on[kBatch], hit[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const long long j = lane + 32 * (m0 + u);
      on[u] = m0 + u < chunks && j < n;
      long long act = 0;
      x[u] = y[u] = 0;
      if (on[u]) {
        x[u] = xy[2 * (first + j)];
        y[u] = xy[2 * (first + j) + 1];
        on[u] = active[first + j] != 0;
        act = action_at(actions, actions_i64, first + j);
      }
      dx[u] = act == 1 ? -1 : (act == 2 ? 1 : 0);
      dy[u] = act == 3 ? -1 : (act == 4 ? 1 : 0);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int px = x[u] + dx[u], py = y[u] + dy[u];
      hit[u] = on[u] && (dx[u] | dy[u]) != 0 && px >= 0 && px < p && py >= 0 && py < p &&
               grid[px * p + py] != 0;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int m = m0 + u;
      if (m >= chunks) continue;
      const long long j = lane + 32 * m;
      const int32_t cur = x[u] * p + y[u], des = cur + dx[u] * p + dy[u];
      const bool moving = on[u] && !hit[u] && des != cur;
      f[m] = on[u] ? cur : kEmpty;
      t[m] = moving ? des : kEmpty;
      // The proposed cell for every mover: those that stay blocked are
      // written back to their own cell at the end.
      if (j < n) {
        reinterpret_cast<int2*>(out)[first + j] =
            moving ? make_int2(x[u] + dx[u], y[u] + dy[u]) : make_int2(x[u], y[u]);
      }
    }
  }

#pragma unroll
  for (int c = 0; c < chunks; ++c) {
    const int32_t tc = t[c];
    for (unsigned todo = __ballot_sync(kFull, tc != kEmpty); todo != 0; todo &= todo - 1) {
      const int k = __ffs(todo) - 1;
      const int32_t tk = __shfl_sync(kFull, tc, k);
      bool held = false;
#pragma unroll
      for (int m = 0; m < chunks; ++m) held |= f[m] == tk;
      if (!__any_sync(kFull, held) && lane == k) f[c] = tk;
    }
  }

#pragma unroll
  for (int m = 0; m < chunks; ++m) {
    if (t[m] != kEmpty && f[m] != t[m]) {  // a mover that stayed: f is its own cell
      const int32_t cur = f[m], x = cur / p;
      reinterpret_cast<int2*>(out)[first + lane + 32 * m] = make_int2(x, cur - x * p);
    }
  }
}

}  // namespace

// Agents per env above which the kernel keeps its slots in `scratch`
// (int32[B, 64 * ceil(N / 32)]) instead of shared memory.
extern "C" int pogema_collisions_smem_agents() { return kSmemBytes / 8; }

// obstacles: u8[B, P, P] (nonzero = obstacle); agents_xy: i32[B, N, 2],
// every agent inside the grid; active: bool[B, N]; actions: i32 or
// (actions_i64) i64 [B, N]; out: i32[B, N, 2], 8-byte aligned; scratch:
// as above where N exceeds pogema_collisions_smem_agents(), else null.
// Returns cudaGetLastError() of the launch.
extern "C" int pogema_collisions(const void* obstacles, const void* agents_xy, const void* active,
                                 const void* actions, int actions_i64, void* out, void* scratch,
                                 int b, int n, int p, void* stream) {
  if (b < 0 || n < 0 || p < 1 || (actions_i64 != 0 && actions_i64 != 1) ||
      (n > pogema_collisions_smem_agents() && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || n == 0) return 0;
  const int chunks = (n + 31) / 32;
  int warps = kWarpsPerBlock;
  size_t smem = 0;
  if (chunks > kRegisterChunks && n <= pogema_collisions_smem_agents()) {
    scratch = nullptr;
    if (256LL * chunks * warps > kSmemBytes) warps = 1;
    smem = 256 * static_cast<size_t>(chunks) * warps;
  }
  const dim3 blocks((b + warps - 1) / warps), threads(32 * warps);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* o = static_cast<const uint8_t*>(obstacles);
  const auto* xy = static_cast<const int32_t*>(agents_xy);
  const auto* on = static_cast<const uint8_t*>(active);
  auto* dst = static_cast<int32_t*>(out);
  auto* tmp = static_cast<int32_t*>(scratch);
  const bool i64 = actions_i64 != 0;
  if (chunks == 1) {
    priority_kernel<1><<<blocks, threads, 0, s>>>(o, xy, on, actions, i64, dst, tmp, b, n, p, warps);
  } else if (chunks == 2) {
    priority_kernel<2><<<blocks, threads, 0, s>>>(o, xy, on, actions, i64, dst, tmp, b, n, p, warps);
  } else if (chunks <= 4) {
    priority_kernel<4><<<blocks, threads, 0, s>>>(o, xy, on, actions, i64, dst, tmp, b, n, p, warps);
  } else if (chunks <= kRegisterChunks) {
    priority_kernel<8><<<blocks, threads, 0, s>>>(o, xy, on, actions, i64, dst, tmp, b, n, p, warps);
  } else {
    priority_kernel<0><<<blocks, threads, smem, s>>>(o, xy, on, actions, i64, dst, tmp, b, n, p,
                                                      warps);
  }
  return static_cast<int>(cudaGetLastError());
}
