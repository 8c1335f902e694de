// K8, policy_kernel: the served step of the recurrent policy after the
// observation (models/recurrent.py RecurrentEmbedActorCritic.step_from_state
// once K1b has built the packed observation), for NVIDIA Hopper (sm_90a).
//
// It replaces no TPU kernel. The JAX package computes this step with
// flax's Dense and GRUCell, which XLA lowers to plain dots and fused
// elementwise ops. The port's plain version (models/recurrent.py
// step_from_obs) runs each bf16 Dense as an f32 GEMM of bf16-rounded
// operands, so that the CPU stays bit-equal to flax: about 60 launches a
// step on the card, with the casts' copies and f32 SIMT GEMMs where bf16
// tensor cores would do the same products.
//
// What it computes, for R = B * N rows (one agent-step each): from the
// packed observation obs f32[R, K] (K = 3 * W * W <= 384, integer entries)
// and the carried h bf16[R, 128],
//   e  = relu(bf16(sum_k bf16(obs) * bf16(W_e) + f32(bf16(b_e))))
//   r  = sig(bf16(bf16(bf16(x W_ir) + b_ir) + bf16(h W_hr)))
//   z  = sig(bf16(bf16(bf16(x W_iz) + b_iz) + bf16(h W_hz)))
//   n  = bf16(tanh(bf16(bf16(bf16(x W_in) + b_in) + bf16(r * bf16(bf16(h W_hn) + b_hn)))))
//   h' = bf16(bf16(bf16(1 - z) * n) + bf16(z * h))
//   [logits, value] = f32(h') W_head + b_head, in f32
// with x = e, sig(v) = bf16(1 / bf16(1 + bf16(exp(-v)))), every product of
// bf16 operands summed in f32, and each bf16() a round to nearest even of
// an op computed in f32: the rounding points of the plain version, op for
// op, with expf, tanhf and an IEEE division as PyTorch's bf16 kernels use
// them. The gates run in bf16x2 (add, sub, mul with an explicit .rn): a
// bf16 sum or product rounded once equals the same op in f32 rounded.
//
// Only the order of the f32 sums may differ from the plain version, and
// for the GRU's sums not even that where it shows: cuBLAS's f32 GEMM takes
// them one fma a k, k in order, and a bf16 rounding of a tensor-core sum
// lands one ulp from that in about one sum in 10^5. Carried in h through a
// 128-step episode, such flips part the served logits by up to 10 at
// config E. So every GRU sum whose tensor-core value lies within 2^-19 of
// its largest partial sum (at every 32nd k) of a bf16 rounding boundary is
// summed again in k order by its own lane, from the tiles and the weight
// stage in shared memory: about 0.15% of the sums. Over 1.2 * 10^9 served
// h' entries no flip escaped that window, nor one of 2^-20; 2^-21 let one
// through, 2^-22 two hundred. The embedding's sums
// (integer observations times bf16 weights, nearly always exact in f32)
// are left to the tensor cores: their e differs from the plain version's
// in 2 entries in 10^6 at config D.
//
// Bound: the observation's bytes. A row reads 4K bytes of observation and
// 256 of h and writes 256 of h' and 24 of logits and value: 521 MB at
// config E (R = 262,144, K = 363), 0.156 ms at 3.35 TB/s, and 0.078 ms at
// config D (R = 131,072). Its 290,816 FLOPs a row (the bf16 products) take
// 0.077 / 0.039 ms at 989 TFLOP/s. What sets K8's time instead is the
// latency of each warp's dependent work (products, gates, the sums taken
// again) between the block's stage barriers.
//
// Design: a block of 8 warps takes 128 rows, 16 a warp. The weights (295
// KB, prepared once per model in the order the lanes read them,
// ops/cuda_policy.py pack_weights) stream through shared memory in 24
// stages of 12 KB, three buffers deep with cp.async, so each block reads
// them from L2 once; 2 blocks an SM. The embedding: a warp's observation
// fragments come straight from device memory into registers, two k-steps
// ahead of the mma.sync m16n8k16 products (bf16 in, f32 sums), so the
// observation's bytes are read once and never cast in memory; e lands in a
// shared tile beside the block's old h. The GRU runs in 16 chunks of 8
// hidden units: a unit's r, z and n need only its own column of the six
// products, so a chunk's six 16 x 8 products (A fragments from the tiles
// by ldmatrix) give 24 sums a lane, which become h' in registers while the
// next chunk's products run. h' goes to device memory, and the f32 head
// reads the block's rows back.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHidden = 128;
constexpr int kOut = 6;                      // 5 logits and the value
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;           // rows a block
constexpr int kKSteps = 24;                  // the embedding's K padded to 384
constexpr int kMaxK = 16 * kKSteps;
constexpr int kStepsPerStage = 3;            // embedding k-steps a stage
constexpr int kEmbedStages = kKSteps / kStepsPerStage;
constexpr int kChunks = kHidden / 8;         // GRU stages, 8 hidden units each
constexpr int kStages = kEmbedStages + kChunks;
constexpr int kStageWords = 3072;            // 12 KB of bf16 pairs a stage
constexpr int kBuffers = 3;
constexpr int kHStride = kHidden + 8;        // bf16 a row of the e and h tiles
// The f32 side buffer: f32(bf16) biases of the embedding and of ir, iz,
// in, hn; the head's kernel as [128][8] (outputs 6 and 7 zero); its bias [8].
constexpr int kBiasFloats = 5 * kHidden;
constexpr int kHeadFloats = kHidden * 8 + 8;
constexpr int kAuxFloats = kBiasFloats + kHeadFloats;
// A GRU product whose tensor-core sum lies within kWindow times its
// largest partial sum (at every 32nd k) of a bf16 rounding boundary is
// summed again in k order (sequential_sum).
constexpr float kWindow = 1.0f / (1 << 19);
// Shared memory: the weight stages, the tiles of e and of the old h (bf16,
// rows padded to kHStride), the head.
constexpr size_t kSmemBytes = 4 * kBuffers * kStageWords + 2 * 2 * kRows * kHStride +
                              4 * kHeadFloats;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// A 16 x 16 bf16 A fragment from a shared tile: `at` is the lane's own
// address, row lane & 15 and column 8 (lane >> 4) of the fragment.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], const void* at) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(at));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// D += A B for one 16 x 8 x 16 tile: A bf16 row-major in the PTX fragment
// order, B bf16 by columns, f32 sums.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

using bf2 = __nv_bfloat162;

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const bf2 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi(uint32_t v) { return __uint_as_float(v & 0xFFFF0000u); }

__device__ __forceinline__ bf2 as_bf2(uint32_t v) { return *reinterpret_cast<const bf2*>(&v); }
__device__ __forceinline__ uint32_t as_u32(bf2 v) { return *reinterpret_cast<const uint32_t*>(&v); }

// torch.relu of two bf16 (NaN kept).
__device__ __forceinline__ uint32_t relu_bf2(uint32_t v) {
  return as_u32(__hmax2_nan(as_bf2(v), __float2bfloat162_rn(0.0f)));
}

// The gates work on pairs of units in bf16x2. A sum, difference or
// product of two bf16 values rounded once to bf16 (add, sub, mul .rn
// .bf16x2) equals PyTorch's bf16 op, which computes it in f32 and rounds:
// a bf16 product is exact in f32, and a bf16 sum is too unless the operands
// lie more than 16 binades apart, where the smaller stays below a quarter
// of the larger's bf16 ulp either way. The .rn is explicit: without it the
// compiler may fuse a product and a sum into one rounding. exp, the
// reciprocal and tanh run in f32 (expf, an IEEE division, tanhf) and are
// rounded once.
__device__ __forceinline__ uint32_t add2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t sub2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t mul2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

constexpr uint32_t kOnes = 0x3F803F80u;  // bf16x2 (1, 1)

__device__ __forceinline__ uint32_t exp_bf2(uint32_t v) { return pack(expf(lo(v)), expf(hi(v))); }

__device__ __forceinline__ uint32_t recip_bf2(uint32_t v) {
  return pack(1.0f / lo(v), 1.0f / hi(v));
}

__device__ __forceinline__ uint32_t tanh_bf2(uint32_t v) {
  return pack(tanhf(lo(v)), tanhf(hi(v)));
}

// jax.nn.sigmoid as the plain version runs it: 1 / (1 + exp(-v)), each op
// rounded to bf16 (the negation, a flip of the sign bits, is exact).
__device__ __forceinline__ uint32_t sigmoid_bf2(uint32_t v) {
  return recip_bf2(add2(kOnes, exp_bf2(v ^ 0x80008000u)));
}

// Two units of one row, from their six products (bf16x2: ir, iz, in, hr,
// hz, hn), the biases of ir, iz, in, hn (aux) and the old h: h'.
__device__ __forceinline__ uint32_t gru_pair(const uint32_t (&p)[6], const float* aux, int unit,
                                             uint32_t h) {
  const auto bias = [&](int q) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(aux + q * kHidden + unit));
    return pack(v.x, v.y);
  };
  const uint32_t r = sigmoid_bf2(add2(add2(p[0], bias(1)), p[3]));
  const uint32_t z = sigmoid_bf2(add2(add2(p[1], bias(2)), p[4]));
  const uint32_t n = tanh_bf2(add2(add2(p[2], bias(3)), mul2(r, add2(p[5], bias(4)))));
  return add2(mul2(sub2(kOnes, z), n), mul2(z, h));
}

// Whether f32 s, which rounds to the bf16 value b, lies within kWindow * m
// of a boundary between two bf16 values (the midpoints on either side of b;
// a NaN neighbour, past zero, drops out of the min).
__device__ __forceinline__ bool near_midpoint(float s, float b, float m) {
  const uint32_t ub = __float_as_uint(b);
  const float up = __uint_as_float(ub + 0x10000u), down = __uint_as_float(ub - 0x10000u);
  const float d = fminf(fabsf(s - 0.5f * (b + up)), fabsf(s - 0.5f * (b + down)));
  return d < kWindow * m;
}

// The f32 sum of a . w_q[unit] as the plain version's GEMM takes it: one
// fma a k, k = 0 to 127 in order, from 0 (cuBLAS's f32 GEMM does this for
// these shapes; the bf16 products are exact, so each step rounds once).
// a: the row's 128 bf16 as 64 words (shared or device memory); stage: the
// GRU stage of the unit's chunk; q: the product; col: unit - 8c.
__device__ __forceinline__ float sequential_sum(const uint32_t* a, const uint32_t* stage, int q,
                                                int col) {
  const uint32_t* w = stage + 4 * (4 * 32 * q + 4 * col);
  float s = 0.0f;
#pragma unroll 16
  for (int k2 = 0; k2 < 64; ++k2) {  // k = 2 k2 + {0, 1}: sp, js, half, t of the layout
    const uint32_t x = a[k2];
    const uint32_t v = w[4 * (32 * (k2 >> 4) + (k2 & 3)) + 2 * ((k2 >> 3) & 1) + ((k2 >> 2) & 1)];
    s = fmaf(lo(x), lo(v), s);
    s = fmaf(hi(x), hi(v), s);
  }
  return s;
}

// Stage `stage` of the packed weights into buffer stage % kBuffers, as one
// commit group (an empty one past the last stage, so that every thread
// counts the same groups).
__device__ __forceinline__ void issue_stage(uint32_t* wbuf, const uint32_t* wpack, int stage) {
  if (stage < kStages) {
    uint32_t* dst = wbuf + (stage % kBuffers) * kStageWords;
    const uint32_t* src = wpack + static_cast<long long>(stage) * kStageWords;
#pragma unroll
    for (int i = 0; i < kStageWords / (4 * kThreads); ++i) {
      const int word = 4 * (threadIdx.x + i * kThreads);
      cp_async16(dst + word, src + word);
    }
  }
  cp_async_commit();
}

// Wait for stage `stage`, and start the one two ahead into the buffer that
// every warp has finished with. Returns the stage's buffer.
__device__ __forceinline__ const uint32_t* next_stage(uint32_t* wbuf, const uint32_t* wpack,
                                                      int stage) {
  cp_async_wait_one();
  __syncthreads();
  issue_stage(wbuf, wpack, stage + 2);
  return wbuf + (stage % kBuffers) * kStageWords;
}

// An observation entry, with a hint that L2 fetch the 256 bytes around it:
// a row's next k-steps follow.
__device__ __forceinline__ float load_entry(const float* at) {
  float v;
  asm("ld.global.nc.L2::256B.f32 %0, [%1];\n" : "=f"(v) : "l"(at));
  return v;
}

// The observation entries of k-step s a lane holds in its A fragment:
// rows g and g + 8 of the warp's tile, columns 16s + 2t + {0, 1, 8, 9};
// zero past K and past the last row.
__device__ __forceinline__ void load_obs(float (&f)[8], const float* ra, const float* rb, int k,
                                         int s, int t) {
  const int c = 16 * s + 2 * t;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = c + (j & 1) + 8 * (j >> 1);
    f[j] = ra != nullptr && col < k ? load_entry(ra + col) : 0.0f;
    f[4 + j] = rb != nullptr && col < k ? load_entry(rb + col) : 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads, 2)
policy_kernel(const float* __restrict__ obs, int k, const uint32_t* __restrict__ h_in,
              const uint32_t* __restrict__ wpack, const float* __restrict__ aux,
              uint4* __restrict__ h_out, float* __restrict__ out, int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* wbuf = reinterpret_cast<uint32_t*>(smem);
  __nv_bfloat16* etile = reinterpret_cast<__nv_bfloat16*>(wbuf + kBuffers * kStageWords);
  __nv_bfloat16* htile = etile + kRows * kHStride;
  float* head = reinterpret_cast<float*>(htile + kRows * kHStride);
  uint32_t* h_words = reinterpret_cast<uint32_t*>(h_out);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const long long first = static_cast<long long>(blockIdx.x) * kRows;
  const long long row_a = first + 16 * warp + g, row_b = row_a + 8;
  const float* obs_a = row_a < rows ? obs + row_a * k : nullptr;
  const float* obs_b = row_b < rows ? obs + row_b * k : nullptr;

  issue_stage(wbuf, wpack, 0);
  issue_stage(wbuf, wpack, 1);
  for (int i = threadIdx.x; i < kHeadFloats; i += kThreads) head[i] = aux[kBiasFloats + i];
  // The block's old h rows into the h tile (zero past the last row).
  for (int i = threadIdx.x; i < kRows * kHidden / 8; i += kThreads) {
    const int row = i / (kHidden / 8), col = i % (kHidden / 8);
    const uint4 v = first + row < rows
                        ? __ldg(reinterpret_cast<const uint4*>(h_in) + (first + row) * (kHidden / 8) + col)
                        : make_uint4(0u, 0u, 0u, 0u);
    *reinterpret_cast<uint4*>(htile + row * kHStride + 8 * col) = v;
  }

  // The embedding: 16 n-tiles of 8 units, four f32 sums each a lane.
  float acc[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  float f[3][8];
  load_obs(f[0], obs_a, obs_b, k, 0, t);
  load_obs(f[1], obs_a, obs_b, k, 1, t);
  // The stages' loops are not unrolled, so that the kernel's code stays
  // small enough for the instruction caches; k-step s's entries are in
  // ring slot s % 3 = ks.
#pragma unroll 1
  for (int stage = 0; stage < kEmbedStages; ++stage) {
    const uint32_t* w = next_stage(wbuf, wpack, stage);
#pragma unroll
    for (int ks = 0; ks < kStepsPerStage; ++ks) {
      const int s = kStepsPerStage * stage + ks;
      if (s + 2 < kKSteps) load_obs(f[(ks + 2) % 3], obs_a, obs_b, k, s + 2, t);
      const float* v = f[ks];
      const uint32_t a[4] = {pack(v[0], v[1]), pack(v[4], v[5]), pack(v[2], v[3]),
                             pack(v[6], v[7])};
      const uint4* b = reinterpret_cast<const uint4*>(w) + ks * 8 * 32 + lane;
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        const uint4 q = b[32 * p];
        mma(acc[2 * p], a, q.x, q.y);
        mma(acc[2 * p + 1], a, q.z, q.w);
      }
    }
  }
  // e, rounded and rectified, into the e tile.
  uint32_t* ewords = reinterpret_cast<uint32_t*>(etile);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float2 b = __ldg(reinterpret_cast<const float2*>(aux) + 4 * j + t);
    ewords[((16 * warp + g) * kHStride + 8 * j + 2 * t) / 2] =
        relu_bf2(pack(acc[j][0] + b.x, acc[j][1] + b.y));
    ewords[((16 * warp + g + 8) * kHStride + 8 * j + 2 * t) / 2] =
        relu_bf2(pack(acc[j][2] + b.x, acc[j][3] + b.y));
  }

  // The GRU, 8 hidden units a stage: units 8c + 2t + {0, 1} of rows g
  // (sums 0, 1) and g + 8 (sums 2, 3); A fragments from the e and h tiles
  // (the stage's barrier orders their stores before the first reads).
  const uint32_t* hwords = reinterpret_cast<const uint32_t*>(htile);
  // Chunk c's h' waits for chunk c + 1: its gates are then scheduled beside
  // the next chunk's products, which do not depend on them. pk[r][q]:
  // product q of the two units, row g + 8r, bf16x2; prev: chunk c - 1's.
  uint32_t pk[2][6], prev[2][6] = {};
  const auto store_h = [&](int unit, bool on) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long row = r ? row_b : row_a;
      const uint32_t old = hwords[((16 * warp + g + 8 * r) * kHStride + unit) / 2];
      const uint32_t v = gru_pair(prev[r], aux, unit, old);
      if (on && row < rows) h_words[row * (kHidden / 2) + unit / 2] = v;
    }
  };
#pragma unroll 1
  for (int c = 0; c < kChunks; ++c) {
    const int unit = 8 * c + 2 * t;
    const uint32_t* w = next_stage(wbuf, wpack, kEmbedStages + c);
    const uint4* b = reinterpret_cast<const uint4*>(w) + lane;
    // Each side's three products (f32), with the largest |partial sum| at
    // every 32nd k, and a bit (12 side + 4q + e) for each sum near a bf16
    // rounding boundary.
    float sums[2][3][4];
    uint32_t near = 0;
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      float (&sum)[3][4] = sums[side];
      const __nv_bfloat16* tile = (side == 0 ? etile : htile) +
                                  (16 * warp + (lane & 15)) * kHStride + 8 * (lane >> 4);
      float m[3][4];
#pragma unroll
      for (int q = 0; q < 3; ++q) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[q][e] = m[q][e] = 0.0f;
      }
      uint32_t a[8][4];  // the side's A fragments, loaded together
#pragma unroll
      for (int s = 0; s < 8; ++s) ldmatrix_x4(a[s], tile + 16 * s);
#pragma unroll
      for (int sp = 0; sp < 4; ++sp) {
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const uint4 u = b[32 * (4 * (q + 3 * side) + sp)];
          mma(sum[q], a[2 * sp], u.x, u.y);
          mma(sum[q], a[2 * sp + 1], u.z, u.w);
#pragma unroll
          for (int e = 0; e < 4; ++e) m[q][e] = fmaxf(m[q][e], fabsf(sum[q][e]));
        }
      }
      if (side == 1) store_h(c > 0 ? unit - 8 : unit, c > 0);  // chunk c - 1's h'
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        pk[0][q + 3 * side] = pack(sum[q][0], sum[q][1]);
        pk[1][q + 3 * side] = pack(sum[q][2], sum[q][3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t two = pk[e >> 1][q + 3 * side];
          near |= static_cast<uint32_t>(near_midpoint(sum[q][e], (e & 1) ? hi(two) : lo(two),
                                                      m[q][e]))
                  << (12 * side + 4 * q + e);
        }
      }
    }
    // The flagged sums are taken again in the plain version's order, so that
    // the bf16 products equal its own, each by its own lane.
    if (near != 0) {
      for (uint32_t bits = near; bits != 0; bits &= bits - 1) {
        const int i = __ffs(bits) - 1, side = i / 12, e = i % 4;
        const __nv_bfloat16* row = (side == 0 ? etile : htile) +
                                   (16 * warp + g + 8 * (e >> 1)) * kHStride;
        const float v = sequential_sum(reinterpret_cast<const uint32_t*>(row), w, i / 4,
                                       2 * t + (e & 1));
#pragma unroll
        for (int j = 0; j < 24; ++j) {
          float& x = sums[j / 12][(j % 12) / 4][j % 4];
          x = j == i ? v : x;
        }
      }
#pragma unroll
      for (int side = 0; side < 2; ++side) {
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          pk[0][q + 3 * side] = pack(sums[side][q][0], sums[side][q][1]);
          pk[1][q + 3 * side] = pack(sums[side][q][2], sums[side][q][3]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int q = 0; q < 6; ++q) prev[r][q] = pk[r][q];
    }
  }
  store_h(8 * (kChunks - 1) + 2 * t, true);
  __syncthreads();

  // The head in f32, from the block's h' rows (the barrier above makes
  // every thread's stores visible): thread i takes outputs 3 (i & 1) + {0,
  // 1, 2} of row i / 2.
  const long long head_row = first + (threadIdx.x >> 1);
  if (head_row < rows) {
    const int o = 3 * (threadIdx.x & 1);
    const uint4* hrow = h_out + head_row * (kHidden / 8);
    float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
#pragma unroll 4
    for (int u8 = 0; u8 < kHidden / 8; ++u8) {
      const uint4 v = hrow[u8];
      const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float hv = (j & 1) ? hi(words[j >> 1]) : lo(words[j >> 1]);
        const float* wrow = head + 8 * (8 * u8 + j) + o;
        s0 = fmaf(hv, wrow[0], s0);
        s1 = fmaf(hv, wrow[1], s1);
        s2 = fmaf(hv, wrow[2], s2);
      }
    }
    const float* bias = head + 8 * kHidden + o;
    out[head_row * kOut + o] = s0 + bias[0];
    out[head_row * kOut + o + 1] = s1 + bias[1];
    out[head_row * kOut + o + 2] = s2 + bias[2];
  }
}

}  // namespace

// The packed weights in 32-bit words (two bf16, the lower k in the low
// half: 8 stages of the embedding, then 16 of the GRU, 3072 words each) and
// the f32 side buffer's length, as the wrapper checks them.
extern "C" int pogema_policy_weight_words() { return kStages * kStageWords; }
extern "C" int pogema_policy_aux_floats() { return kAuxFloats; }

// obs: f32[rows, k], k <= 384; h_in: bf16[rows, 128]; wpack and aux as
// ops/cuda_policy.py pack_weights makes them; h_out: bf16[rows, 128]; out:
// f32[rows, 6]. wpack, h_in and h_out 16-byte aligned, aux 8, the others 4.
// Returns cudaGetLastError() of the launch.
extern "C" int pogema_policy(const void* obs, int k, const void* h_in, const void* wpack,
                             const void* aux, void* h_out, void* out, int rows, void* stream) {
  const auto at = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr); };
  if (rows < 0 || k < 1 || k > kMaxK || ((at(wpack) | at(h_in) | at(h_out)) & 15) != 0 ||
      (at(aux) & 7) != 0 || ((at(obs) | at(out)) & 3) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return 0;
  // The opt-in above 48 KB of shared memory, once a device.
  static bool configured[64] = {};
  int device = 0;
  cudaError_t rc = cudaGetDevice(&device);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (device >= 64 || !configured[device]) {
    rc = cudaFuncSetAttribute(policy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(kSmemBytes));
    if (rc != cudaSuccess) return static_cast<int>(rc);
    if (device < 64) configured[device] = true;
  }
  const int blocks = (rows + kRows - 1) / kRows;
  policy_kernel<<<blocks, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(obs), k, static_cast<const uint32_t*>(h_in),
      static_cast<const uint32_t*>(wpack), static_cast<const float*>(aux),
      static_cast<uint4*>(h_out), static_cast<float*>(out), rows);
  return static_cast<int>(cudaGetLastError());
}
