// K7, threefry_kernel: the threefry2x32-20 hash of the port's random
// stream (pogema_torch/core/random.py), for NVIDIA Hopper (sm_90a).
//
// It replaces no Pallas kernel. The JAX package draws every key, map,
// placement and goal queue from jax.random, whose threefry2x32 XLA fuses
// into one loop over the counters; the plain version of the port
// (ops/threefry.py) spells the same hash as int64 tensor ops, one launch
// per add, mask, shift, or and xor of every round: about 175 launches a
// call, whatever the number of counters.
//
// What it computes, for keys int64[K, 2] holding u32 key words:
//
//   split (layout 0):  out[k, j, :] = threefry(key k, counter offset + j)
//                      as the pair (x0, x1), int64[K, numel, 2];
//   bits (layout 1):   out[k, j]    = x0 ^ x1 of the same hash, int64[K, numel];
//   fold_in (layout 2): out[k, :]   = threefry(key k, counter words
//                      (0, data[k] & 0xFFFFFFFF)), int64[K, 2], for per-key
//                      data. For a scalar the wrapper launches split at
//                      offset data & 0xFFFFFFFF with numel 1: the same words.
//
// For split and bits the 64-bit counter offset + j is split into the
// words (hi, lo) = (c >> 32, c & 0xFFFFFFFF), as jax_threefry_partitionable
// hashes the flat index of an element. Every output value is a u32 held
// in an int64, the layout the callers read.
//
// Bound: the integer ALU. A counter costs 20 rounds of add, rotate and
// xor and 5 key injections, about 80 int32 operations, and writes 8
// (bits) or 16 (split, fold_in) bytes; it reads nothing but its key. At
// the placement's [1024, 74*74] that is 0.45 G operations (0.027 ms at
// 16.7 T int32 operations a second: 132 SMs x 64 lanes x 1.98 GHz) and
// 44.9 MB written (0.013 ms at 3.35 TB/s); measured on an H100 by graph
// replay, 0.0315 ms. At the cached select's [4096, 1] split the launch
// floor is all there is (0.0015 ms measured).
//
// Design: one counter per thread in a grid-stride loop, no shared memory.
// The hash is threefry2x32 of csrc/threefry.cuh (shared with K9): the whole
// 20-round chain stays in u32 registers, each rotation is one funnel shift
// (__funnelshift_l). A thread finds its key row and column
// once by a division and steps both by the stride after that. Stores are
// whole int64 words (bits) or 16-byte pairs (split, fold_in) in output
// order, so a warp writes consecutive bytes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 4096;  // about 4 waves of 8 resident blocks on each of 132 SMs
__global__ void __launch_bounds__(kThreads)
threefry_kernel(const int64_t* __restrict__ keys, const int64_t* __restrict__ data,
                int64_t* __restrict__ out, long long rows, long long numel,
                unsigned long long offset, int layout) {
  const long long total = rows * numel;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= total) return;
  long long row = j / numel, col = j - row * numel;
  const long long row_step = stride / numel, col_step = stride - row_step * numel;
  for (; j < total; j += stride) {
    const uint32_t k0 = static_cast<uint32_t>(keys[2 * row]);
    const uint32_t k1 = static_cast<uint32_t>(keys[2 * row + 1]);
    uint32_t x0, x1;
    if (layout == 2) {
      x0 = 0u;
      x1 = static_cast<uint32_t>(data[row]);
    } else {
      const unsigned long long c = offset + static_cast<unsigned long long>(col);
      x0 = static_cast<uint32_t>(c >> 32);
      x1 = static_cast<uint32_t>(c);
    }
    threefry2x32(k0, k1, x0, x1);
    if (layout == 1) {
      out[j] = static_cast<int64_t>(x0 ^ x1);
    } else {
      reinterpret_cast<longlong2*>(out)[j] =
          make_longlong2(static_cast<long long>(x0), static_cast<long long>(x1));
    }
    row += row_step;
    col += col_step;
    if (col >= numel) {
      col -= numel;
      ++row;
    }
  }
}

}  // namespace

// keys: int64[rows, 2]; data: int64[rows] (layout 2) or null;
// out: int64[rows, numel, 2] (layout 0), [rows, numel] (1) or [rows, 2]
// (2, numel 1), 16-byte aligned. Returns cudaGetLastError() of the launch.
extern "C" int pogema_threefry(const void* keys, const void* data, void* out, long long rows,
                               long long numel, unsigned long long offset, int layout,
                               void* stream) {
  if (layout < 0 || layout > 2 || rows < 0 || numel < 0 ||
      (layout == 2 && (numel != 1 || data == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long total = rows * numel;
  if (total == 0) return 0;
  const long long blocks = (total + kThreads - 1) / kThreads;
  threefry_kernel<<<static_cast<unsigned>(blocks < kMaxBlocks ? blocks : kMaxBlocks), kThreads,
                    0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(keys), static_cast<const int64_t*>(data),
      static_cast<int64_t*>(out), rows, numel, offset, layout);
  return static_cast<int>(cudaGetLastError());
}
