// The threefry2x32-20 hash of the port's random stream (pogema_torch/core/
// random.py) as a device function, shared by K7 (threefry.cu), which hashes
// the counters of a draw, and K9 (placement.cu), which hashes the draws of a
// reset's placement inside its own loops.
//
// The whole 20-round chain stays in u32 registers; each rotation is one
// funnel shift (__funnelshift_l). The functions sit in an unnamed namespace,
// so each source that includes the header has its own inlined copy.

#pragma once

#include <stdint.h>

namespace {

constexpr uint32_t kParity = 0x1BD11BDAu;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int d) { return __funnelshift_l(x, x, d); }

// Four rounds with rotations r0..r3, then the key injection of step `i`.
template <int r0, int r1, int r2, int r3>
__device__ __forceinline__ void rounds(uint32_t& x0, uint32_t& x1, uint32_t ka, uint32_t kb,
                                       uint32_t i) {
  x0 += x1; x1 = rotl(x1, r0) ^ x0;
  x0 += x1; x1 = rotl(x1, r1) ^ x0;
  x0 += x1; x1 = rotl(x1, r2) ^ x0;
  x0 += x1; x1 = rotl(x1, r3) ^ x0;
  x0 += ka;
  x1 += kb + i;
}

// threefry2x32-20 of the counter words (x0, x1) under the key (k0, k1).
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0,
                                             uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ kParity;
  x0 += k0;
  x1 += k1;
  rounds<13, 15, 26, 6>(x0, x1, k1, k2, 1);
  rounds<17, 29, 16, 24>(x0, x1, k2, k0, 2);
  rounds<13, 15, 26, 6>(x0, x1, k0, k1, 3);
  rounds<17, 29, 16, 24>(x0, x1, k1, k2, 4);
  rounds<13, 15, 26, 6>(x0, x1, k2, k0, 5);
}

}  // namespace
