// K9, placement_kernel: the placement of a reset's agents and targets
// (pogema_torch/core/generator.py place_agents_and_targets), for NVIDIA
// Hopper (sm_90a).
//
// It replaces no Pallas kernel. The JAX package places agents in
// pogema_tpu/core/generator.py place_agents_and_targets: lax.top_k of the
// masked uniforms of every cell for the agents, then a lax.fori_loop over
// the agents, each drawing u32 bits for every cell and taking the first
// argmax over the free cells of its component that no earlier agent took.
// The port's plain version (pogema_torch/ops/placement.py) runs that loop
// as N passes of masked int64 tensor ops over [B, P*P], each pass with a K7
// hash of every cell of every env: 64, 128 or 256 passes a reset.
//
// What it computes, for B envs with keys int64[B, 2] (u32 words) and the
// component labels int64[B, P*P] of K4 (a free cell's label is its
// component's least flat index, an obstacle's P*P):
//  * k_agents and k_targets are the hashes of counters 0 and 1 under the
//    env's key (jax.random.split).
//  * Agents: cell c's key is (bits(k_agents, c) >> 9) + 1 where c is
//    eligible (free, with a free 4-neighbour; rows and columns wrap as
//    torch.roll does), else 0. The agents are the N largest keys,
//    descending, ties to the lower cell: lax.top_k of the uniforms, which
//    are (bits >> 9) * 2**-23. Fewer than N eligible cells: the rest are
//    the lowest ineligible cells, and agents_ok is false.
//  * Targets, in agent order: agent i draws g(c) = bits(fold_in(k_targets,
//    i), c) over its mask (free, in its component, no earlier target, not
//    its own cell). Its target is the lowest cell of the mask's largest g
//    where that g is above 0, else cell 0 (torch.argmax of where(mask, g,
//    0)); it is found iff that cell is in the mask. Every target joins the
//    used set, found or not. ok = agents_ok and every agent found.
// Here bits(k, c) is x0 ^ x1 of the hash of counter c under key k.
//
// Bound: instruction issue. The draws the semantics cannot skip are one
// hash an eligible cell for the agents' keys and, for each agent, one a
// cell of its own component but its own cell (the argmax needs every draw
// of the mask, and no draw outside it): 72 instructions a hash with its key
// fixed (20 rounds of add, rotate and xor, 12 adds, a xor), at one warp
// instruction a clock in each of an SM's 4 partitions (33.4 T a second at
// 132 SMs and 1.98 GHz). At E.serve's 1024 x 138 x 138 worlds and 256
// agents that is 2.68 G hashes, 5.8 ms. Reading the labels once (8 bytes a
// cell) is a few hundredths of that.
//
// Design: one block an env, 1024 threads, the env's arrays in shared
// memory with 16-bit cells where they fit (P*P below 2**16 and the block
// within 227 KB: P up to 162 at N = 64, 138 at N = 2500), else in device
// memory scratch that the wrapper allocates, with 32-bit cells. The block
// holds the labels, the keys of pass 2 (in the words pass 3 then takes
// for the component offsets), the free cells sorted by component, a bit a
// cell for the used set, a 4096-bin histogram and a few words an agent.
//  1. The labels come in once (narrowed; any label past P*P reads P*P).
//  2. Agents: each cell's key, and a histogram of the eligible keys' top
//     12 bits; the bin that holds the N-th largest key, then the same over
//     the low 12 bits of the keys in that bin, give the N-th key itself.
//     The cells above it are gathered in any order, the first ones that
//     hold it in cell order (a block scan a chunk), and ranked by counting
//     the pairs that order before each.
//  3. The free cells by component: a count a label (one shared atomic a
//     run of equal labels in a warp), a block scan to the components'
//     ends, and a scatter that counts each end down to its start, so that
//     label r's cells lie at [off[r], off[r + 1]) of the list, in no
//     particular order: an argmax over (g, -cell) does not see the order.
//  4. Candidates, one warp an agent, all agents at once: each agent's two
//     best cells by (g, -cell) over its component but its own cell, ignoring
//     the used set. This is all the hashing; no barrier inside.
//  5. One warp walks the agents in order: the first of the two candidates
//     that no earlier target took is the argmax of the mask; if both were
//     taken and the component has more cells, the warp draws the
//     component again with the used set (rare: both of an agent's two best
//     cells already taken as targets). A best draw of 0 gives cell 0, as
//     the plain version's argmax does.
// The result is a function of the inputs alone: the atomics only fill
// counts and unordered lists. Nothing syncs the host.
//
// Where the time goes (clock64 at the pass boundaries on an H100, shares of
// a block's cycles at C.regen's 64 agents on 74 x 74 mazes / D.serve's 128
// on 74 x 74 maps / E.serve's 256 on 138 x 138 worlds): pass 4's hashes
// 72 / 79 / 93%, pass 5's walk in order 12 / 13 / 4% (one warp's dependent
// shared-memory loads while the other warps wait), passes 1-3 the rest.
// Pass 4 runs at about half of the issue-rate bound at E.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 232448;  // 227 KB, the most a Hopper block can take
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint32_t kNone = 0xFFFFFFFFu;
constexpr int kBinBits = 12;
constexpr int kBins = 1 << kBinBits;
static_assert(kWarps == 32, "block_scan scans the warps' sums in one warp");
static_assert(kBins == 4 * kThreads, "select_bin gives each thread four bins");

// Words of the block's `misc` array: the block scan's warp sums, then
// single values.
constexpr int kSums = 0, kBin = 32, kAbove = 33, kCursor = 34, kMiscWords = 64;

// The block's arrays, as offsets in 32-bit words from its base; cells are
// `idx_bytes` wide.
struct Layout {
  long long hist, misc, agent, cand, count, used, off, lab, list, words;
};

__host__ __device__ inline Layout layout(long long p, long long n, long long idx_bytes) {
  const long long big = p * p;
  Layout l{};
  long long w = 0;
  l.hist = w;
  w += kBins;
  l.misc = w;
  w += kMiscWords;
  l.agent = w;  // agent cells in order
  w += n;
  l.cand = w;  // per agent: the two candidates (cell, draw); before pass 4, the selection
  w += 4 * n;
  l.count = w;  // per agent: cells of its component but its own
  w += n;
  l.used = w;  // a bit a cell
  w += (big + 31) / 32;
  l.off = w;  // the keys in pass 2, the components' offsets from pass 3
  w += big + 1;
  l.lab = w;
  w += (big * idx_bytes + 3) / 4;
  l.list = w;  // free cells by component
  w += (big * idx_bytes + 3) / 4;
  l.words = w;
  return l;
}

// Whether the block's arrays fit in shared memory with 16-bit cells.
__host__ __device__ inline bool fits_shared(long long p, long long n) {
  return p * p < 65536 && 4 * layout(p, n, 2).words <= kMaxSmem;
}

__device__ __forceinline__ uint32_t bits(uint32_t k0, uint32_t k1, uint32_t c) {
  uint32_t x0 = 0u, x1 = c;
  threefry2x32(k0, k1, x0, x1);
  return x0 ^ x1;
}

// (g, c) ranks before (h, d): the larger draw, on a tie the lower cell.
__device__ __forceinline__ bool before(uint32_t g, uint32_t c, uint32_t h, uint32_t d) {
  return g > h || (g == h && c < d);
}

// A word that other threads' atomics changed. Atomics on device memory are
// performed in L2, so there the read goes to L2 (__ldcg) and not to a line
// the SM's L1 may hold from before them.
template <bool kShared>
__device__ __forceinline__ uint32_t fresh(const uint32_t* p) {
  if constexpr (kShared) {
    return *p;
  } else {
    return __ldcg(p);
  }
}

__device__ __forceinline__ bool is_used(const uint32_t* used, uint32_t c) {
  return (used[c >> 5] >> (c & 31)) & 1u;
}

// The two first (draw, cell) pairs of those added; (0, kNone) for none,
// which every cell ranks before.
struct Top2 {
  uint32_t g1 = 0u, c1 = kNone, g2 = 0u, c2 = kNone;

  __device__ __forceinline__ void add(uint32_t g, uint32_t c) {
    if (before(g, c, g1, c1)) {
      g2 = g1;
      c2 = c1;
      g1 = g;
      c1 = c;
    } else if (before(g, c, g2, c2)) {
      g2 = g;
      c2 = c;
    }
  }
  // The warp's two first, in every lane (the lanes' pairs are disjoint).
  __device__ __forceinline__ void warp_merge() {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      const uint32_t h1 = __shfl_xor_sync(kFull, g1, d), d1 = __shfl_xor_sync(kFull, c1, d);
      const uint32_t h2 = __shfl_xor_sync(kFull, g2, d), d2 = __shfl_xor_sync(kFull, c2, d);
      add(h1, d1);
      add(h2, d2);
    }
  }
};

// The exclusive prefix sum of v over the block's threads, and in `total`
// the sum of all. Every thread calls it; `sums` holds 32 words.
__device__ uint32_t block_scan(uint32_t v, uint32_t* sums, uint32_t& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t x = v;
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const uint32_t y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    uint32_t s = sums[lane];
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const uint32_t y = __shfl_up_sync(kFull, s, d);
      if (lane >= d) s += y;
    }
    sums[lane] = s;
  }
  __syncthreads();
  total = sums[kWarps - 1];
  const uint32_t prefix = x - v + (warp > 0 ? sums[warp - 1] : 0u);
  __syncthreads();  // before the next call writes `sums`
  return prefix;
}

// Over the bins from the top, the one where the count reaches `need` (at
// least 1): misc[kBin] is that bin and misc[kAbove] the count of the bins
// above it; kNone and the count of all bins if they hold fewer. Every
// thread calls it.
template <bool kShared>
__device__ void select_bin(const uint32_t* hist, uint32_t need, uint32_t* misc) {
  const int top = kBins - 1 - 4 * static_cast<int>(threadIdx.x);
  const uint32_t s = fresh<kShared>(hist + top) + fresh<kShared>(hist + top - 1) +
                     fresh<kShared>(hist + top - 2) + fresh<kShared>(hist + top - 3);
  uint32_t total;
  uint32_t acc = block_scan(s, misc + kSums, total);
  if (acc < need && need <= acc + s) {
    for (int k = 0; k < 4; ++k) {
      const uint32_t h = fresh<kShared>(hist + top - k);
      if (acc + h >= need) {
        misc[kBin] = top - k;
        misc[kAbove] = acc;
        break;
      }
      acc += h;
    }
  }
  if (threadIdx.x == 0 && total < need) {
    misc[kBin] = kNone;
    misc[kAbove] = total;
  }
  __syncthreads();
}

// Idx: uint16_t with the arrays in shared memory, uint32_t with them in
// `scratch` (layout(p, n, 4).words words a block).
template <typename Idx, bool kShared>
__global__ void __launch_bounds__(kThreads)
placement_kernel(const int64_t* __restrict__ keys, const int64_t* __restrict__ labels,
                 int64_t* __restrict__ agents_out, int64_t* __restrict__ targets_out,
                 uint8_t* __restrict__ ok_out, uint32_t* __restrict__ scratch, int p, int n) {
  extern __shared__ uint32_t smem[];
  const int big = p * p;
  const Layout L = layout(p, n, sizeof(Idx));
  const size_t env = blockIdx.x;
  uint32_t* base = smem;
  if constexpr (!kShared) base = scratch + env * L.words;
  uint32_t* hist = base + L.hist;
  uint32_t* misc = base + L.misc;
  uint32_t* agent = base + L.agent;
  uint32_t* cand = base + L.cand;
  uint32_t* count = base + L.count;
  uint32_t* used = base + L.used;
  uint32_t* off = base + L.off;
  Idx* lab = reinterpret_cast<Idx*>(base + L.lab);
  Idx* list = reinterpret_cast<Idx*>(base + L.list);
  uint32_t* sel_key = cand;  // the selection of pass 2, in cand's words
  uint32_t* sel_cell = cand + n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t* row = labels + env * big;

  // The try's two keys: counters 0 and 1 of the env's key.
  const uint32_t k0 = static_cast<uint32_t>(keys[2 * env]);
  const uint32_t k1 = static_cast<uint32_t>(keys[2 * env + 1]);
  uint32_t ka0 = 0u, ka1 = 0u, kt0 = 0u, kt1 = 1u;
  threefry2x32(k0, k1, ka0, ka1);
  threefry2x32(k0, k1, kt0, kt1);

  // 1. The labels in; the histogram, the used set and misc cleared.
  for (int i = tid; i < big; i += kThreads) {
    const unsigned long long v = static_cast<unsigned long long>(row[i]);
    lab[i] = static_cast<Idx>(v < static_cast<unsigned long long>(big) ? v : big);
  }
  for (int i = tid; i < kBins; i += kThreads) hist[i] = 0u;
  for (int i = tid; i < (big + 31) / 32; i += kThreads) used[i] = 0u;
  if (tid < kMiscWords) misc[tid] = 0u;
  __syncthreads();

  // 2. Agents. Each cell's key (0 where not eligible) into `off`, the
  // eligible keys counted by their top 12 bits.
  for (int i = tid; i < big; i += kThreads) {
    uint32_t key = 0u;
    if (lab[i] < big) {
      const int y = i / p, x = i - y * p;
      const int up = y == 0 ? i + big - p : i - p, down = y == p - 1 ? x : i + p;
      const int west = x == 0 ? i + p - 1 : i - 1, east = x == p - 1 ? i - x : i + 1;
      if (lab[up] < big || lab[down] < big || lab[west] < big || lab[east] < big) {
        key = (bits(ka0, ka1, i) >> 9) + 1u;
        atomicAdd(hist + (key >> kBinBits), 1u);
      }
    }
    off[i] = key;
  }
  __syncthreads();

  // The N-th largest key `thr`, and `gt` keys above it; with fewer than N
  // eligible cells thr is 0 and gt counts them all.
  select_bin<kShared>(hist, n, misc);
  const uint32_t hi = misc[kBin];
  uint32_t gt = misc[kAbove], thr = 0u;
  if (hi != kNone) {
    for (int i = tid; i < kBins; i += kThreads) hist[i] = 0u;
    __syncthreads();
    for (int i = tid; i < big; i += kThreads) {
      const uint32_t key = off[i];
      if (key != 0u && (key >> kBinBits) == hi) atomicAdd(hist + (key & (kBins - 1)), 1u);
    }
    __syncthreads();
    select_bin<kShared>(hist, n - gt, misc);
    thr = (hi << kBinBits) | misc[kBin];
    gt += misc[kAbove];
  }

  // The keys above thr in any order, then the first `take` cells holding
  // thr in cell order.
  const uint32_t take = n - gt;
  uint32_t taken = 0u;
  for (int i0 = 0; i0 < big; i0 += kThreads) {
    const int i = i0 + tid;
    const uint32_t key = i < big ? off[i] : 0u;
    if (i < big && key > thr) {
      const uint32_t at = atomicAdd(misc + kCursor, 1u);
      sel_key[at] = key;
      sel_cell[at] = i;
    }
    if (taken < take) {  // the same in every thread
      const bool eq = i < big && key == thr;
      uint32_t chunk;
      const uint32_t at = taken + block_scan(eq ? 1u : 0u, misc + kSums, chunk);
      if (eq && at < take) {
        sel_key[gt + at] = key;
        sel_cell[gt + at] = i;
      }
      taken += chunk;
    }
  }
  __syncthreads();

  // Each selected cell's rank: the selected pairs that order before it.
  for (int j = tid; j < n; j += kThreads) {
    const uint32_t kj = sel_key[j], cj = sel_cell[j];
    int rank = 0;
    for (int k = 0; k < n; ++k) rank += before(sel_key[k], sel_cell[k], kj, cj);
    agent[rank] = cj;
    agents_out[env * n + rank] = cj;
  }
  for (int i = tid; i <= big; i += kThreads) off[i] = 0u;
  __syncthreads();

  // 3. The free cells by component: a count a label, ...
  for (int i0 = warp * 32; i0 < big; i0 += kThreads) {
    const int i = i0 + lane;
    const uint32_t r = i < big ? lab[i] : big;
    const unsigned peers = __match_any_sync(kFull, r);
    if (r < static_cast<uint32_t>(big) && lane == __ffs(peers) - 1) {
      atomicAdd(off + r, static_cast<uint32_t>(__popc(peers)));
    }
  }
  __syncthreads();
  // ... each label's end (an inclusive scan, a run of entries a thread) ...
  {
    const long long per = (big + kThreads) / kThreads;  // ceil((big + 1) / kThreads)
    const long long lo = min(static_cast<long long>(tid) * per, big + 1LL);
    const long long hi_end = min(lo + per, big + 1LL);
    uint32_t s = 0u;
    for (long long e = lo; e < hi_end; ++e) s += fresh<kShared>(off + e);
    uint32_t total;
    uint32_t run = block_scan(s, misc + kSums, total);
    for (long long e = lo; e < hi_end; ++e) {
      run += fresh<kShared>(off + e);
      off[e] = run;
    }
  }
  __syncthreads();
  // ... and the scatter, which counts each end down to its start.
  for (int i0 = warp * 32; i0 < big; i0 += kThreads) {
    const int i = i0 + lane;
    const uint32_t r = i < big ? lab[i] : big;
    const unsigned peers = __match_any_sync(kFull, r);
    const int leader = __ffs(peers) - 1;
    uint32_t end = 0u;
    if (r < static_cast<uint32_t>(big) && lane == leader) {
      end = atomicSub(off + r, static_cast<uint32_t>(__popc(peers)));
    }
    end = __shfl_sync(kFull, end, leader);
    if (r < static_cast<uint32_t>(big)) {
      list[end - 1u - __popc(peers & ((1u << lane) - 1u))] = static_cast<Idx>(i);
    }
  }
  __syncthreads();

  // 4. Candidates: each agent's two first cells of its component but its
  // own, one warp an agent.
  for (int i = warp; i < n; i += kWarps) {
    const uint32_t a = agent[i], r = lab[a];
    Top2 top;
    uint32_t cells = 0u;
    if (r < static_cast<uint32_t>(big)) {  // the same in the whole warp
      uint32_t f0 = 0u, f1 = static_cast<uint32_t>(i);
      threefry2x32(kt0, kt1, f0, f1);  // fold_in(k_targets, i)
      const uint32_t start = fresh<kShared>(off + r), end = fresh<kShared>(off + r + 1);
      cells = end - start - 1u;
      for (uint32_t j = start + lane; j < end; j += 32) {
        const uint32_t c = list[j];
        if (c != a) top.add(bits(f0, f1, c), c);
      }
      top.warp_merge();
    }
    if (lane == 0) {
      cand[4 * i] = top.c1;
      cand[4 * i + 1] = top.g1;
      cand[4 * i + 2] = top.c2;
      cand[4 * i + 3] = top.g2;
      count[i] = cells;
    }
  }
  __syncthreads();

  // 5. The targets in agent order, by warp 0.
  if (warp != 0) return;
  bool ok = thr > 0u;
  for (int i = 0; i < n; ++i) {
    const uint32_t a = agent[i], r = lab[a], cells = count[i];
    uint32_t c = kNone, g = 0u;  // the first cell of the mask
    if (cells >= 1u && !is_used(used, cand[4 * i])) {
      c = cand[4 * i];
      g = cand[4 * i + 1];
    } else if (cells >= 2u && !is_used(used, cand[4 * i + 2])) {
      c = cand[4 * i + 2];
      g = cand[4 * i + 3];
    } else if (cells >= 3u) {
      // Both taken: the component drawn again without the used cells.
      uint32_t f0 = 0u, f1 = static_cast<uint32_t>(i);
      threefry2x32(kt0, kt1, f0, f1);
      const uint32_t end = fresh<kShared>(off + r + 1);
      for (uint32_t j = fresh<kShared>(off + r) + lane; j < end; j += 32) {
        const uint32_t cc = list[j];
        if (cc == a || is_used(used, cc)) continue;
        const uint32_t gg = bits(f0, f1, cc);
        if (before(gg, cc, g, c)) {
          g = gg;
          c = cc;
        }
      }
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) {
        const uint32_t h = __shfl_xor_sync(kFull, g, d), e = __shfl_xor_sync(kFull, c, d);
        if (before(h, e, g, c)) {
          g = h;
          c = e;
        }
      }
    }
    bool found = true;
    if (c == kNone || g == 0u) {  // the argmax of an all-zero row: cell 0
      c = 0u;
      found = r < static_cast<uint32_t>(big) && lab[0] == r && a != 0u && !is_used(used, 0u);
    }
    ok = ok && found;
    __syncwarp();  // every lane has read the used set
    if (lane == 0) {
      used[c >> 5] |= 1u << (c & 31);
      targets_out[env * n + i] = c;
    }
    __syncwarp();
  }
  if (lane == 0) ok_out[env] = ok ? 1 : 0;
}

}  // namespace

// Words of device memory scratch a block needs: 0 where its arrays fit in
// shared memory; -1 for sizes the kernel does not take.
extern "C" long long pogema_placement_scratch_words(int p, int n) {
  if (p < 1 || p > 46340 || n < 1 || n > static_cast<long long>(p) * p) return -1;
  return fits_shared(p, n) ? 0 : layout(p, n, 4).words;
}

// keys: int64[B, 2] (u32 words); labels: int64[B, P * P] in [0, P * P];
// agents, targets: int64[B, N]; ok: bool[B]; scratch: B times
// pogema_placement_scratch_words(p, n) int32 words, or null where that is
// 0. 1 <= N <= P * P, P * P below 2**31. Returns cudaGetLastError() of the
// launch.
extern "C" int pogema_placement(const void* keys, const void* labels, void* agents, void* targets,
                                void* ok, void* scratch, int b, int p, int n, void* stream) {
  const long long words = pogema_placement_scratch_words(p, n);
  if (b < 0 || words < 0 || (words > 0 && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* k = static_cast<const int64_t*>(keys);
  const auto* l = static_cast<const int64_t*>(labels);
  auto* a = static_cast<int64_t*>(agents);
  auto* t = static_cast<int64_t*>(targets);
  auto* o = static_cast<uint8_t*>(ok);
  if (words > 0) {
    placement_kernel<uint32_t, false><<<b, kThreads, 0, s>>>(k, l, a, t, o,
                                                            static_cast<uint32_t*>(scratch), p, n);
    return static_cast<int>(cudaGetLastError());
  }
  // The opt-in above 48 KB of shared memory, once a device.
  static bool configured[64] = {};
  int device = 0;
  cudaError_t rc = cudaGetDevice(&device);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (device >= 64 || !configured[device]) {
    rc = cudaFuncSetAttribute(placement_kernel<uint16_t, true>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    if (device < 64) configured[device] = true;
  }
  const size_t smem = 4 * static_cast<size_t>(layout(p, n, 2).words);
  placement_kernel<uint16_t, true><<<b, kThreads, smem, s>>>(k, l, a, t, o, nullptr, p, n);
  return static_cast<int>(cudaGetLastError());
}
