// Egocentric observation kernels for NVIDIA Hopper (sm_90a).
//
// K1, packed_windows_kernel: the obstacle windows in the layout of the
// Pallas TPU kernel it replaces,
// pogema_tpu/ops/pallas_windows.py::extract_windows_packed.
//
//   out[b, n, k] = grid[b, x_n - r + k / w, y_n - r + k % w] for k < w*w,
//   0 for w*w <= k < L (L = lanes, a multiple of 128), and 0 for cells
//   outside the P x P grid. grid is u8[B, P, P], xy is i32[B, M, 2] and
//   out is f32[B, M, L], all contiguous.
//
// K1b, packed_observation_kernel: the whole packed 'default' observation
// of pogema_tpu/core/obs.py::observe (obs_layout='packed') in one launch,
//
//   out[b, n, 0:ww]     the obstacle window of agent n        (as K1),
//   out[b, n, ww:2ww]   the count of active agents per window cell, the
//                       agent itself included when it is active
//                       (ops/windows.py::pairwise_agent_windows),
//   out[b, n, 2ww:3ww]  1 at the agent's own target, clamped per axis
//                       onto the window border (core/obs.py::target_channel),
//
// from grid u8[B, P, P], agents_xy and targets_xy i32[B, N, 2] and active
// bool[B, N]; out is f32[B, N, 3*w*w]. No TPU kernel stands behind K1b:
// the JAX package composes those three functions, and the TPU's form of
// the agents block (an [N, N] pairwise one-hot contraction) exists only
// because gathers serialize there.
//
// Design for this card, both kernels. The TPU version selects rows with a
// one-hot matmul and aligns columns with a barrel rotate; here a window
// cell is one shared-memory read at a computed address.
//  * A block owns (env, chunk of `mc` centres). The wrapper picks `mc`
//    from B, M, the grid's and a row's bytes and the SM count (measured
//    rule, ops/cuda_windows.py::centres_per_block): a block writes at
//    least 3 (K1) or 8 (K1b) times the bytes of the grid it loads, which
//    is 32-33 centres at P = 74, w = 11, and more only while the launch
//    keeps 32 (K1) or 8 (K1b) blocks per SM. So the recurrent update's
//    B = 128 gives 512 blocks where one block per env gave 128, and
//    B = 4096 gives 8192 (K1) or 4096 (K1b). A block of an env after the
//    first finds the grid in L2 (5.5 KB at P = 74). Re-reading costs L2
//    traffic of chunks * B * P * P bytes beside an output of B * M * L * 4:
//    at B = 128, M = 128 four chunks read 2.8 MB beside 8.4 MB written, at
//    B = 4096 two chunks read 44.9 MB beside 268.4 MB; none of it counts
//    in the bound, which reads every input once. Smaller chunks lose: a
//    block's fixed cost (grid load, barrier) then outweighs its stores
//    (8 centres per block take twice the time of 32 at every batch).
//  * Resident blocks, from ptxas (-Xptxas -v) and the launch: K1 uses
//    40 registers a thread and 6.0 KB of shared memory at mc = 64,
//    P = 74, so 6 blocks of 256 threads per SM (registers bind;
//    forcing 32 registers spills and gains nothing); K1b uses 32
//    registers and 13.5 KB at mc = 64, so 8 blocks per SM, all 2048
//    threads (16-bit cells; the split layout of N > 255 is held to what
//    shared memory allows: the wrapper's observation_fill).
//  * K1 copies the grid with 16-byte cp.async while each thread computes
//    the window offsets of its four lanes into registers (a thread keeps
//    its lanes for every centre, so there is no lane table in shared
//    memory). An env's grid starts at b * P * P bytes, which is 16-byte
//    aligned only when P * P is a multiple of 16: the shared copy is
//    skewed to the same alignment as the source, the aligned body goes by
//    cp.async and the head and tail go byte by byte.
//  * K1b keeps, per grid cell, the obstacle byte and the count of active
//    agents there (zeroed with the obstacle bytes, then one shared-memory
//    atomic add per active agent of the env). The obstacle and the agents
//    block are then the same window read, the target block is one
//    comparison, and nothing of size [B, N, N] exists. A chunk needs all N
//    agents of its env for the counts. The occupancy form looks at the
//    grid's bounds where the pairwise form does not: an active agent
//    outside the P x P grid is seen by nobody here (a precondition of the
//    wrapper; real states keep every agent inside the padded border).
//    The layout is chosen at launch from N (the wrapper's
//    observation_wide): a cell can never count more than N agents.
//     - N <= 255 (configs C and D), PackedCells: one 16-bit cell, the
//       obstacle byte below and an 8-bit count above; 2 bytes a cell,
//       13.5 KB at P = 74.
//     - N > 255 (config E: 256 agents, P = 138), SplitCells: the obstacle
//       bytes as they lie in the grid, and a separate array of 16-bit
//       counts (N <= 65535). 3 bytes a cell: 62 KB at P = 138, w = 11 and
//       256 agents per block, so three blocks per SM. A 32-bit cell (the
//       byte and a 24-bit count) would take 4 bytes, 80 KB and two blocks
//       per SM, and its byte-by-byte widening of the grid would stay; here
//       the obstacle bytes go by 16-byte cp.async as K1's grid does (skewed
//       to the source's alignment), the counts are zeroed by 16-byte
//       stores, and both window blocks still read one shared value each.
//       Shared atomics are 32 bits wide: a count adds 1 or 0x10000 to the
//       word of the cell pair, from the base of the array, which is
//       16-byte aligned.
//  * Stores are whole float4s in output order (a warp writes 512
//    consecutive bytes), streaming (__stcs, evict-first: nothing here
//    reads the output back; measured against plain stores on an H100 they
//    gain up to 25% for K1 at B = 1024 and 0-7% for K1b, and lose 3% for
//    K1 at B = 4096). K1's rows are L * 4 bytes; K1b's are 3*w*w*4 =
//    1452 bytes at w = 11, so K1b vectorises over the chunk's flat range
//    when chunk starts are 16-byte aligned and stores scalars otherwise.
//  * A centre whose whole window lies inside the grid (every agent of a
//    real state) skips the per-cell bounds test. u8 -> f32 is an OR and an
//    FADD (exact below 2^23), not a conversion instruction.
//
// Bound: memory, for both. The functions must read B*P*P bytes of grid
// and the coordinates and write the output, which dominates: K1 at
// B=4096, P=74, M=128, L=128 moves 22.4 + 4.2 + 268.4 MB, 88 us at
// 3.35 TB/s; K1b at B=4096, N=64, w=11 moves 22.4 + 4.5 + 380.6 MB,
// 122 us; K1b at config E's serving shape (B=1024, N=256, P=138) moves
// 19.5 + 4.5 + 380.6 MB, 121 us. wgmma does not apply (there is no product) and TMA has nothing
// to tile (the reads are a gather, the stores are plain rows).

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;  // 227 KB, the most a Hopper block can take

__host__ __device__ inline int round_up(int v, int to) { return (v + to - 1) / to * to; }

// Exact for v < 2^23: 0x4B000000 is 2^23 as a float, whose mantissa counts in ones.
__device__ __forceinline__ float small_uint_to_float(unsigned v) {
  return __uint_as_float(0x4B000000u | v) - 8388608.0f;
}

// Is the whole w x w window around (cx, cy) inside the p x p grid?
__device__ __forceinline__ bool window_inside(int cx, int cy, int r, int p, int w) {
  return p >= w && static_cast<unsigned>(cx - r) <= static_cast<unsigned>(p - w) &&
         static_cast<unsigned>(cy - r) <= static_cast<unsigned>(p - w);
}

// For the four lanes k0..k0+3 of a packed window: is the lane a window
// cell (k < w*w), and the cell's offset from the centre in a p-wide grid.
__device__ __forceinline__ void lane_offsets(int k0, int w, int r, int p, int (&off)[4],
                                             bool (&lane)[4]) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int k = k0 + u;
    lane[u] = k < w * w;
    const int i = lane[u] ? k / w : r;
    const int j = lane[u] ? k - i * w : r;
    off[u] = (i - r) * p + (j - r);
  }
}

__host__ __device__ inline int windows_smem_bytes(int p, int mc) {
  return round_up(8 * mc, 16) + p * p + 16;
}

__global__ void __launch_bounds__(kThreads)
packed_windows_kernel(const uint8_t* __restrict__ grid,
                      const int32_t* __restrict__ xy,
                      float* __restrict__ out,
                      int p, int m, int w, int lanes, int mc) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int chunks = (m + mc - 1) / mc;
  const int b = blockIdx.x / chunks;
  const int n0 = (blockIdx.x - b * chunks) * mc;
  const int cnt = min(mc, m - n0);
  const int cells = p * p;
  const int r = w >> 1;
  const int ww = w * w;

  const uint8_t* g = grid + static_cast<size_t>(b) * cells;
  const int skew = static_cast<int>(reinterpret_cast<uintptr_t>(g) & 15);
  int32_t* s_xy = reinterpret_cast<int32_t*>(smem);     // [mc, 2]
  uint8_t* s_grid = smem + round_up(8 * mc, 16) + skew;  // s_grid[i] = g[i], aligned as g is

  // The grid: 16-byte pieces asynchronously, the unaligned ends by bytes.
  const int head = min((16 - skew) & 15, cells);
  const int body = (cells - head) >> 4;
  for (int i = tid; i < body; i += kThreads)
    __pipeline_memcpy_async(s_grid + head + 16 * i, g + head + 16 * i, 16);
  __pipeline_commit();
  if (tid < head) s_grid[tid] = g[tid];
  for (int i = head + 16 * body + tid; i < cells; i += kThreads) s_grid[i] = g[i];
  const int32_t* c = xy + (static_cast<size_t>(b) * m + n0) * 2;
  for (int i = tid; i < 2 * cnt; i += kThreads) s_xy[i] = c[i];

  // A thread keeps the same four lanes for every centre it writes: qt
  // threads span a row's float4s, rpp rows are written per pass.
  const int quads = lanes >> 2;
  const int qt = min(quads, kThreads);
  const int rpp = kThreads / qt;
  const int r0 = tid / qt;
  float4* o = reinterpret_cast<float4*>(out + (static_cast<size_t>(b) * m + n0) * lanes);

  int q = tid - r0 * qt;
  int off[4];
  bool lane[4];
  lane_offsets(q << 2, w, r, p, off, lane);  // overlaps the grid's copy
  __pipeline_wait_prior(0);
  __syncthreads();
  if (r0 >= rpp) return;  // threads past the last whole row of a pass

  for (bool first = true; q < quads; q += qt, first = false) {
    const int k0 = q << 2;
    if (!first) lane_offsets(k0, w, r, p, off, lane);
    if (k0 >= ww) {  // padding lanes only
      for (int n = r0; n < cnt; n += rpp)
        __stcs(o + n * quads + q, make_float4(0.f, 0.f, 0.f, 0.f));
      continue;
    }
#pragma unroll 4
    for (int n = r0; n < cnt; n += rpp) {
      const int cx = s_xy[2 * n];
      const int cy = s_xy[2 * n + 1];
      float v[4];
      if (window_inside(cx, cy, r, p, w)) {
        const uint8_t* centre = s_grid + cx * p + cy;
#pragma unroll
        for (int u = 0; u < 4; ++u)
          v[u] = lane[u] ? small_uint_to_float(centre[off[u]]) : 0.f;
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int k = k0 + u;
          const int x = cx - r + k / w;
          const int y = cy - r + k % w;
          v[u] = (lane[u] && static_cast<unsigned>(x) < static_cast<unsigned>(p) &&
                  static_cast<unsigned>(y) < static_cast<unsigned>(p))
                     ? small_uint_to_float(s_grid[x * p + y]) : 0.f;
        }
      }
      __stcs(o + n * quads + q, make_float4(v[0], v[1], v[2], v[3]));
    }
  }
}

// -- K1b -----------------------------------------------------------------

// N above which K1b counts in 16 bits (SplitCells), and the most agents
// per env that those counts hold.
constexpr int kNarrowAgents = 255;
constexpr int kMaxAgents = 65535;

struct __align__(16) Agent {
  int ax, ay;   // window origin: centre - r
  int target;   // lane of the clamped target inside the target block
  int inside;   // whole window inside the grid
};

// Shared memory of a block: the cells (2 bytes each, with room to skew
// them), mc + 1 agents, the row's decode table, and for the split layout
// the obstacle bytes (with room to skew them to the grid's alignment).
__host__ __device__ inline int observation_smem_bytes(int p, int w, int mc, int wide) {
  return round_up(2 * (p * p + 4), 16) + 16 * (mc + 1) + round_up(4 * 3 * w * w, 16) +
         (wide ? p * p + 16 : 0);
}

// The two cell layouts, each read as (channel 0: obstacle byte, channel
// 1: count) at one cell; `ok` false reads 0 (a cell outside the grid).
struct PackedCells {  // N <= 255: obstacle byte | count << 8
  const uint16_t* cell;
  __device__ __forceinline__ unsigned read(int at, int c, bool ok) const {
    const unsigned v = ok ? cell[at] : 0u;
    return c == 0 ? (v & 0xFFu) : (v >> 8);
  }
};

struct SplitCells {  // N > 255: obstacle bytes and 16-bit counts apart
  const uint8_t* obstacle;
  const uint16_t* count;
  __device__ __forceinline__ unsigned read(int at, int c, bool ok) const {
    if (!ok) return 0u;
    return c == 0 ? static_cast<unsigned>(obstacle[at]) : static_cast<unsigned>(count[at]);
  }
};

// One element of the packed observation: channel c, window cell (i, j).
template <typename Cells>
__device__ __forceinline__ float observation_value(const Cells& cells, const Agent& a,
                                                   int c, int i, int j, int p, int w) {
  if (c == 2) return (i * w + j == a.target) ? 1.f : 0.f;
  const int x = a.ax + i;
  const int y = a.ay + j;
  const bool ok = a.inside || (static_cast<unsigned>(x) < static_cast<unsigned>(p) &&
                               static_cast<unsigned>(y) < static_cast<unsigned>(p));
  return small_uint_to_float(cells.read(x * p + y, c, ok));
}

// Phase 3 of K1b: the chunk's flat range of the output, in order.
template <typename Cells>
__device__ __forceinline__ void write_observation(const Cells& cells, const Agent* s_agent,
                                                  const uint32_t* s_dec, float* o, int total,
                                                  int row, int p, int w, int vec) {
  const int tid = threadIdx.x;
  if (vec) {  // whole float4s: total % 4 == 0 and o is 16-byte aligned
    const int step = 4 * kThreads;
    const int dn = step / row, drem = step - dn * row;
    int n = (4 * tid) / row, rem = 4 * tid - n * row;
    for (int e = 4 * tid; e < total; e += step) {
      const uint32_t d = s_dec[rem];
      int c = d & 0xFF, i = (d >> 8) & 0xFF, j = d >> 16;
      int nn = n;
      Agent a = s_agent[nn];
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        v[u] = observation_value(cells, a, c, i, j, p, w);
        if (++j == w) {
          j = 0;
          if (++i == w) {
            i = 0;
            if (++c == 3) {
              c = 0;
              a = s_agent[++nn];
            }
          }
        }
      }
      __stcs(reinterpret_cast<float4*>(o + e), make_float4(v[0], v[1], v[2], v[3]));
      n += dn;
      rem += drem;
      if (rem >= row) {
        rem -= row;
        ++n;
      }
    }
  } else {
    const int dn = kThreads / row, drem = kThreads - dn * row;
    int n = tid / row, rem = tid - n * row;
    for (int e = tid; e < total; e += kThreads) {
      const uint32_t d = s_dec[rem];
      __stcs(o + e, observation_value(cells, s_agent[n], d & 0xFF, (d >> 8) & 0xFF, d >> 16,
                                      p, w));
      n += dn;
      rem += drem;
      if (rem >= row) {
        rem -= row;
        ++n;
      }
    }
  }
}

template <bool kWide>
__global__ void __launch_bounds__(kThreads)
packed_observation_kernel(const uint8_t* __restrict__ grid,
                          const int32_t* __restrict__ agents_xy,
                          const int32_t* __restrict__ targets_xy,
                          const uint8_t* __restrict__ active,
                          float* __restrict__ out,
                          int p, int n_agents, int w, int mc, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int chunks = (n_agents + mc - 1) / mc;
  const int b = blockIdx.x / chunks;
  const int n0 = (blockIdx.x - b * chunks) * mc;
  const int cnt = min(mc, n_agents - n0);
  const int cells = p * p;
  const int r = w >> 1;
  const int ww = w * w;
  const int row = 3 * ww;

  const uint8_t* g = grid + static_cast<size_t>(b) * cells;
  Agent* s_agent = reinterpret_cast<Agent*>(smem + round_up(2 * (cells + 4), 16));  // [mc + 1]
  uint32_t* s_dec = reinterpret_cast<uint32_t*>(s_agent + mc + 1);  // [row]: c | i << 8 | j << 16

  // 1. The obstacle bytes; the counts start at 0.
  uint16_t* s_cell = nullptr;   // PackedCells
  uint8_t* s_obst = nullptr;    // SplitCells: s_obst[i] = g[i], aligned as g is
  uint16_t* s_count = nullptr;  // SplitCells, from the 16-byte aligned base of smem
  if constexpr (!kWide) {
    // Cells before g's first 4-byte boundary; the shared cells are skewed
    // so that cell `head` lies on an 8-byte boundary and four cells go out
    // as one 8-byte store.
    const int head = min(static_cast<int>((4 - (reinterpret_cast<uintptr_t>(g) & 3)) & 3), cells);
    s_cell = reinterpret_cast<uint16_t*>(smem) + ((4 - head) & 3);
    const int body = (cells - head) >> 2;
    const uint32_t* g4 = reinterpret_cast<const uint32_t*>(g + head);
    for (int i = tid; i < body; i += kThreads) {
      const uint32_t v = __ldg(g4 + i);
      *reinterpret_cast<uint2*>(s_cell + head + 4 * i) =
          make_uint2((v & 0xFFu) | ((v & 0xFF00u) << 8), ((v >> 16) & 0xFFu) | ((v >> 24) << 16));
    }
    if (tid < head) s_cell[tid] = g[tid];
    for (int i = head + 4 * body + tid; i < cells; i += kThreads) s_cell[i] = g[i];
  } else {
    // 16-byte pieces asynchronously, the unaligned ends by bytes (as K1).
    const int skew = static_cast<int>(reinterpret_cast<uintptr_t>(g) & 15);
    s_obst = reinterpret_cast<uint8_t*>(s_dec) + round_up(4 * row, 16) + skew;
    s_count = reinterpret_cast<uint16_t*>(smem);
    const int head = min((16 - skew) & 15, cells);
    const int body = (cells - head) >> 4;
    for (int i = tid; i < body; i += kThreads)
      __pipeline_memcpy_async(s_obst + head + 16 * i, g + head + 16 * i, 16);
    __pipeline_commit();
    if (tid < head) s_obst[tid] = g[tid];
    for (int i = head + 16 * body + tid; i < cells; i += kThreads) s_obst[i] = g[i];
    uint4* zero = reinterpret_cast<uint4*>(smem);
    for (int i = tid; i < round_up(2 * cells, 16) / 16; i += kThreads)
      zero[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  for (int k = tid; k < row; k += kThreads) {
    const int c = k / ww;
    const int kk = k - c * ww;
    s_dec[k] = c | ((kk / w) << 8) | ((kk % w) << 16);
  }
  const size_t agent0 = static_cast<size_t>(b) * n_agents;
  for (int i = tid; i <= cnt; i += kThreads) {
    Agent a = {0, 0, 0, 0};
    if (i < cnt) {
      const size_t at = (agent0 + n0 + i) * 2;
      const int cx = agents_xy[at], cy = agents_xy[at + 1];
      const int tx = min(max(targets_xy[at] - cx, -r), r) + r;
      const int ty = min(max(targets_xy[at + 1] - cy, -r), r) + r;
      a.ax = cx - r;
      a.ay = cy - r;
      a.target = tx * w + ty;
      a.inside = window_inside(cx, cy, r, p, w);
    }
    s_agent[i] = a;
  }
  if constexpr (kWide) __pipeline_wait_prior(0);
  __syncthreads();

  // 2. Count the env's active agents. Shared atomics are 32 bits wide: add
  // to the word that holds the cell.
  for (int mth = tid; mth < n_agents; mth += kThreads) {
    if (!active[agent0 + mth]) continue;
    const int x = agents_xy[(agent0 + mth) * 2], y = agents_xy[(agent0 + mth) * 2 + 1];
    if (static_cast<unsigned>(x) >= static_cast<unsigned>(p) ||
        static_cast<unsigned>(y) >= static_cast<unsigned>(p)) continue;
    if constexpr (!kWide) {
      const uintptr_t at = reinterpret_cast<uintptr_t>(s_cell + x * p + y);
      atomicAdd(reinterpret_cast<uint32_t*>(at & ~static_cast<uintptr_t>(3)),
                (at & 2) ? 0x1000000u : 0x100u);
    } else {
      const int at = x * p + y;
      atomicAdd(reinterpret_cast<uint32_t*>(s_count) + (at >> 1), (at & 1) ? 0x10000u : 1u);
    }
  }
  __syncthreads();

  // 3. The chunk's flat range of the output, in order.
  float* o = out + (agent0 + n0) * row;
  if constexpr (!kWide)
    write_observation(PackedCells{s_cell}, s_agent, s_dec, o, cnt * row, row, p, w, vec);
  else
    write_observation(SplitCells{s_obst, s_count}, s_agent, s_dec, o, cnt * row, row, p, w, vec);
}

template <typename Kernel>
int allow_large_smem(Kernel kernel) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem));
}

}  // namespace

// Once per device, before the first launch there: lets every kernel of
// this file take up to 227 KB of dynamic shared memory. Kept out of the
// launch functions so that a launch is nothing but a launch (and can be
// captured into a CUDA graph).
extern "C" int pogema_windows_init(void) {
  int e = allow_large_smem(packed_windows_kernel);
  if (e == 0) e = allow_large_smem(packed_observation_kernel<false>);
  return e != 0 ? e : allow_large_smem(packed_observation_kernel<true>);
}

// Dynamic shared memory of a block, in bytes; the wrappers refuse shapes
// that exceed pogema_windows_max_smem().
extern "C" int pogema_windows_max_smem(void) { return kMaxSmem; }
extern "C" int pogema_packed_windows_smem(int p, int mc) { return windows_smem_bytes(p, mc); }
extern "C" int pogema_packed_observation_smem(int p, int w, int mc, int wide) {
  return observation_smem_bytes(p, w, mc, wide);
}

// K1. mc: centres per block (1..m).
extern "C" int pogema_packed_windows(const void* grid, const void* xy, void* out,
                                     int b, int p, int m, int w, int lanes, int mc,
                                     void* stream) {
  if (b == 0 || m == 0) return 0;
  const int blocks = b * ((m + mc - 1) / mc);
  const size_t smem = windows_smem_bytes(p, mc);
  packed_windows_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(grid), static_cast<const int32_t*>(xy),
      static_cast<float*>(out), p, m, w, lanes, mc);
  return static_cast<int>(cudaGetLastError());
}

// K1b. mc: agents per block (1..n); when n > mc and the output is to go
// out as float4s, mc * 3 * w * w must be a multiple of 4. wide: the split
// layout (16-bit counts), which n > 255 needs.
extern "C" int pogema_packed_observation(const void* grid, const void* agents_xy,
                                         const void* targets_xy, const void* active, void* out,
                                         int b, int p, int n, int w, int mc, int wide,
                                         void* stream) {
  if (n > (wide ? kMaxAgents : kNarrowAgents)) return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || n == 0) return 0;
  const int chunks = (n + mc - 1) / mc;
  const long long row = 3LL * w * w;
  // float4 stores need every chunk's first element on a 16-byte boundary
  // and a whole number of float4s per chunk.
  const int vec = (reinterpret_cast<uintptr_t>(out) % 16 == 0) && (n * row) % 4 == 0 &&
                  (chunks == 1 || (mc * row) % 4 == 0);
  const size_t smem = observation_smem_bytes(p, w, mc, wide);
  const auto kernel = wide ? packed_observation_kernel<true> : packed_observation_kernel<false>;
  kernel<<<b * chunks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(grid), static_cast<const int32_t*>(agents_xy),
      static_cast<const int32_t*>(targets_xy), static_cast<const uint8_t*>(active),
      static_cast<float*>(out), p, n, w, mc, vec);
  return static_cast<int>(cudaGetLastError());
}
