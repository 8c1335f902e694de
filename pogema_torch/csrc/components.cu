// K4, components_kernel: the 4-connected component labels of the port's
// reset (pogema_torch/core/generator.py connected_components), for NVIDIA
// Hopper (sm_90a).
//
// It replaces no Pallas kernel. The JAX package labels components in
// pogema_tpu/core/generator.py connected_components: a lax.while_loop of
// sweeps, each four segmented scans (rows both ways, then columns both
// ways) of a min-label flood fill. The port's plain version
// (pogema_torch/ops/components.py) runs the same sweeps as segmented
// cumsum / cummax scans over [B, P, P] int64 and tests for the fixpoint
// on the host once a sweep. The slowest env of the batch sets the number
// of sweeps, and it grows with how winding a map is: 34 on config E's
// braided 128 x 128 pool (P = 138), each a host sync.
//
// What it computes, for B envs of P x P cells (any nonzero cell an
// obstacle): out[b, i] is the minimum flat index of the 4-connected
// component of free cell i, and P*P for an obstacle.
//
// Bound: bytes. The grids read once and the i64 labels written once:
// B * P * P * 9 bytes, 175.5 MB at B = 1024, P = 138 and 50.5 MB at
// P = 74, so about 0.052 / 0.015 ms at 3.35 TB/s. The work between is
// union-find in shared memory, whose dependent loads, bank conflicts and
// barriers set the time (about a fifth of the bound at P = 138).
//
// Design: one block an env, union-find over the env's labels (after
// Playne and Hawick, IEEE TPDS 2018, and Allegretti, Bolelli and Grana,
// IEEE TPDS 2020). The labels live in shared memory as int32 where P*P of
// them fit beside the warps' queues (P <= 236), else in the env's own
// output row as int64. A label is a cell's parent, and lab[x] <= x always
// holds; a label below P*P marks a free cell, P*P an obstacle. The cells
// are taken in chunks of 32 flat indices, one chunk a warp, so a chunk may
// span the end of one row and the start of the next.
//  1. Runs: each free cell points at the first cell of its run of free
//     cells within its chunk and row (ballots of the chunk's obstacles and
//     row starts). An obstacle holds P*P.
//  2. Merge: first each chunk's first cell with its free west neighbour,
//     so that a row's runs are one tree each; then the rows in rounds that
//     join strips pairwise (rows 2k and 2k + 1, then strips of two, of
//     four, ...): a free cell above a seam with its free south neighbour,
//     unless the pair west of it is free too (that pair joins the same two
//     trees). A round's unions meet only the trees beside its seams, so
//     finds stay short and few unions contend for one root. A union finds
//     both roots, halving the paths it walks, and links the larger root
//     under the smaller with atomicMin; where another thread linked that
//     root first, it takes the root it was linked to and tries again.
//  3. Each run's first cell takes its root.
//  4. Every cell writes its run's first cell's root (or P*P), one
//     coalesced i64 store a cell.
// The sparse work of passes 2 and 3 (unions at about a quarter of the
// seams' cells, finds at the runs' first cells) goes through a queue of
// 64 ints a warp, so that 32 lanes do 32 items together.
// Every root is the smallest index of its tree, since parents only ever
// point down, so the labels equal the plain version's whatever order the
// atomics take: the output is a function of the grid alone. The passes are
// fixed, with log2(P) + 3 barriers: how winding a maze is changes only how
// far a find walks. Nothing syncs the host.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kUnroll = 4;  // chunks a warp loads at once in pass 1
constexpr int kRing = 64;   // ints of a warp's queue, a power of two
constexpr int kQueueInts = kRing * (kThreads / 32);
constexpr int kMaxSmem = 232448;  // 227 KB, the most a Hopper block can take
constexpr unsigned kFull = 0xFFFFFFFFu;

// The largest P whose P*P int32 labels fit in kMaxSmem beside the queues.
constexpr int smem_side() {
  int p = 1;
  while (4LL * (kQueueInts + (p + 1LL) * (p + 1)) <= kMaxSmem) ++p;
  return p;
}

// Division and remainder by P of an index below 2**32 by one 64-bit
// multiply each (Lemire, Kaser and Kurz, 2019); the quotient needs P > 1.
struct DivP {
  unsigned long long m;
  unsigned p;
  __device__ __forceinline__ explicit DivP(unsigned p) : m(~0ULL / p + 1), p(p) {}
  __device__ __forceinline__ int div(unsigned i) const { return static_cast<int>(__umul64hi(m, i)); }
  __device__ __forceinline__ int mod(unsigned i) const {
    return static_cast<int>(__umul64hi(m * i, p));
  }
};

template <typename T>
__device__ __forceinline__ T find_root(volatile T* lab, T x) {
  for (T up = lab[x]; up != x; up = lab[x]) x = up;
  return x;
}

// find_root that points each cell it passes at its grandparent (path
// halving). A store changes only a cell that is no root, to an ancestor
// of it, so every label stays a cell of the same tree below its own index.
template <typename T>
__device__ __forceinline__ T find_halving(volatile T* lab, T x) {
  for (T up = lab[x]; up != x; up = lab[x]) {
    const T top = lab[up];
    if (top != up) lab[x] = top;
    x = up;
  }
  return x;
}

template <typename T>
__device__ __forceinline__ void unite(volatile T* lab, T a, T b) {
  a = find_halving(lab, a);
  b = find_halving(lab, b);
  while (a != b) {
    if (a < b) {
      const T t = a;
      a = b;
      b = t;
    }
    const T old = atomicMin(const_cast<T*>(lab) + a, b);  // link root a under b
    if (old == a) return;
    a = find_halving(lab, old);  // a was linked under old first: join old's root and b's
    b = find_halving(lab, b);
  }
}

// Work items gathered 32 at a time: a warp's ring of kRing ints in shared
// memory; `head` and `count` are the same in all the warp's lanes.
struct WarpQueue {
  int* ring;
  int lane, head = 0, count = 0;

  // Every lane calls it; lanes with `take` append `item`, and whenever 32
  // are queued, every lane runs `work` on one of them.
  template <typename F>
  __device__ __forceinline__ void push(bool take, int item, F work) {
    const unsigned m = __ballot_sync(kFull, take);
    if (take) ring[(head + count + __popc(m & ((1u << lane) - 1))) & (kRing - 1)] = item;
    count += __popc(m);
    if (count >= 32) {
      __syncwarp();
      const int mine = ring[(head + lane) & (kRing - 1)];
      __syncwarp();
      head += 32;
      count -= 32;
      work(mine);
    }
  }
  // The rest, fewer than 32.
  template <typename F>
  __device__ __forceinline__ void flush(F work) {
    __syncwarp();
    if (lane < count) work(ring[(head + lane) & (kRing - 1)]);
    count = 0;
  }
};

// T: int with the labels in shared memory, long long with them in `out`.
template <typename T, bool kShared>
__global__ void __launch_bounds__(kThreads)
components_kernel(const uint8_t* __restrict__ grids, long long* __restrict__ out, int p) {
  extern __shared__ int smem[];
  const int big = p * p;
  const uint8_t* grid = grids + static_cast<size_t>(blockIdx.x) * big;
  long long* row = out + static_cast<size_t>(blockIdx.x) * big;
  int* ring = smem + kRing * (threadIdx.x >> 5);
  T* lab = kShared ? reinterpret_cast<T*>(smem + kQueueInts) : reinterpret_cast<T*>(row);
  volatile T* vlab = lab;
  const int lane = threadIdx.x & 31;
  const DivP byp(p);

  // 1. Runs, kUnroll chunks a warp at once (their grid loads in flight
  // together).
  for (int base = threadIdx.x - lane; base < big; base += kThreads * kUnroll) {
    bool free[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * kThreads + lane;
      free[u] = i < big && grid[i] == 0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * kThreads + lane;
      const unsigned walls = __ballot_sync(kFull, !free[u]) & ((1u << lane) - 1);
      const unsigned row_starts = __ballot_sync(kFull, byp.mod(i) == 0) & (2u * (1u << lane) - 1);
      const int after_wall = walls ? 32 - __clz(walls) : 0;
      const int row_start = row_starts ? 31 - __clz(row_starts) : 0;
      if (i < big) {
        lab[i] = free[u] ? static_cast<T>(i - lane + max(after_wall, row_start)) : static_cast<T>(big);
      }
    }
  }
  __syncthreads();

  // 2. Merge: the runs of each row, then the seams between strips of rows.
  for (int i = 32 * threadIdx.x; i < big; i += 32 * kThreads) {
    if (byp.mod(i) > 0 && vlab[i] < big && vlab[i - 1] < big) {
      unite(vlab, static_cast<T>(i - 1), static_cast<T>(i));
    }
  }
  __syncthreads();
  const auto join = [&](int i) { unite(vlab, static_cast<T>(i), static_cast<T>(i + p)); };
  for (int step = 1; step < p; step *= 2) {
    const int cells = ((p - 1 - step) / (2 * step) + 1) * p;  // seams at rows step, 3 step, ...
    WarpQueue queue{ring, lane};
    for (int t0 = threadIdx.x - lane; t0 < cells; t0 += kThreads) {
      const int t = t0 + lane;
      int i = 0;
      bool take = false;
      if (t < cells) {
        const int seam = byp.div(t), c = t - seam * p;
        i = (step * (2 * seam + 1) - 1) * p + c;  // the cell above the seam
        take = vlab[i] < big && vlab[i + p] < big &&
               !(c > 0 && vlab[i - 1] < big && vlab[i - 1 + p] < big);
      }
      queue.push(take, i, join);
    }
    queue.flush(join);
    __syncthreads();
  }

  // 3. Each run's first cell takes its root.
  const auto settle = [&](int i) { vlab[i] = find_root(vlab, static_cast<T>(i)); };
  WarpQueue queue{ring, lane};
  for (int i0 = threadIdx.x - lane; i0 < big; i0 += kThreads) {
    const int i = i0 + lane;
    const bool free = i < big && vlab[i] < big;
    const unsigned frees = __ballot_sync(kFull, free);
    const bool first = free && (lane == 0 || ((frees >> (lane - 1)) & 1u) == 0 || byp.mod(i) == 0);
    queue.push(first, i, settle);
  }
  queue.flush(settle);
  __syncthreads();

  // 4. In place where the labels are the row: a cell's store changes only
  // its own label, or a run start's to the root it already holds.
  for (int i = threadIdx.x; i < big; i += kThreads) {
    const T up = lab[i];
    row[i] = up < big ? static_cast<long long>(lab[up]) : static_cast<long long>(big);
  }
}

}  // namespace

// The largest side whose labels the kernel keeps in shared memory; above
// it they live in the output rows.
extern "C" int pogema_components_smem_side() { return smem_side(); }

// grids: u8[B, P, P] (nonzero = obstacle); out: i64[B, P * P]; P * P
// below 2**31. Returns cudaGetLastError() of the launch.
extern "C" int pogema_components(const void* grids, void* out, int b, int p, void* stream) {
  if (b < 0 || p < 1 || p > 46340) return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* g = static_cast<const uint8_t*>(grids);
  auto* o = static_cast<long long*>(out);
  if (p > smem_side()) {
    components_kernel<long long, false><<<b, kThreads, 4 * kQueueInts, s>>>(g, o, p);
    return static_cast<int>(cudaGetLastError());
  }
  // The opt-in above 48 KB of shared memory, once a device.
  static bool configured[64] = {};
  int device = 0;
  cudaError_t rc = cudaGetDevice(&device);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (device >= 64 || !configured[device]) {
    rc = cudaFuncSetAttribute(components_kernel<int, true>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    if (device < 64) configured[device] = true;
  }
  const size_t smem = 4 * (kQueueInts + static_cast<size_t>(p) * p);
  components_kernel<int, true><<<b, kThreads, smem, s>>>(g, o, p);
  return static_cast<int>(cudaGetLastError());
}
