// The slab AMP kernel's stage ablation (S4), for Hopper (sm_90a).
//
// Replaces the TPU kernels of scripts/slab_ablation.py (make_kernel,
// make_compact_kernel, make_pair_kernel): the slab form's decode
// (sparc_ldpc_tpu/ops/amp_kernel.py::_amp_kernel_slab, K7, as it stood before
// its scale-free scheme) at T fixed iterations on an observation y given (no
// encode, no noise, no early stop, no pins, no schedule), with one stage
// removed or changed.  The arithmetic is the script's (ops/amp_slab_exp.py):
//
//   coef = (P - |beta|^2 / n) / tau2_prev                 (0 at t = 0)
//   z    = mask y - mask (H(beta) / sqrt(n)) + coef z     (mask 0/1, bf16)
//   tau2 = |z|^2 / n
//   beta = sq softmax_row((sq / tau2) (H(z) / sqrt(n) + beta))
//
// H = H_L (x) H_M, H_M = H_{m_a} (x) H_{m_b} first (x H_{m_b} per column
// block on the tensor cores, bf16 data, then H_{m_a} float32 butterflies),
// then H_L = H_{f_a} (x) H_{f_b} (H_{f_b} times each slab of f_b rows on the
// tensor cores, the H_M stage's result rounded to bf16, then H_{f_a}
// butterflies).  That is where K7's port (amp_slab.cu) rounds, so kernels and
// plain version differ in summation order only; beta is in true scale here
// (K7's port keeps beta sqrt(n) and mask / n; bf16(beta) and bf16(beta
// sqrt(n)) round differently, so that scheme is not reused).
//
// Every variant is K7's design with one thing changed: the state (beta, z,
// the work tile) lives in device memory, f_b = m_b = 128 unless a factoring
// says otherwise, and an iteration is four launches over the batch:
//   C1 (slabx_c1) column stage, one block per (codeword, 32-column strip):
//      H_L of the work tile bf16(H_M bf16(beta)), the residual, the strip's
//      |z|^2 per slab;
//   R2 (slabx_r2) row stage, one block per 16 rows: bf16(H_M bf16(z)) into
//      the work tile;
//   C2 (slabx_c2) column stage: H_L of the work tile into u (float32);
//   R3 (slabx_r3) row stage, one block per slab: u / sqrt(n) + beta, the
//      row softmax, the slab's |beta|^2, the trace, and but at the last
//      iteration bf16(H_M bf16(beta)) into the work tile.
// tau2 is carried from R3 to the next C1 in a (B,) buffer of its own (K7's
// port reads it back from the trace, which no_trace does not store).  A run
// may resume from a state (beta, z, |beta|^2, tau2) and keep its own: one
// R2 launch over beta first rebuilds the work tile.  That lets a check
// start an ablated variant from a decoded state (no_consume from beta = 0
// is NaN throughout, as the script's: its first tau2 is 0).
//
// Per variant: what changes against K7, launches an iteration (4 for all),
// and the bound (chip_smoke.py slab_exp_bound: inputs y, mask, sq read once,
// beta and the trace written once, 8 bytes an element, 1.3 ms at B = 1024,
// T = 32; the least float32 operations at 67 TFLOP/s: 2T - 1 transforms of
// log2(L M) = 19 butterfly adds an element, 12 other operations an element
// and iteration).  Decoding variants compute full's function and have its
// bound; the ablated ones are bounded by what they keep.
//   full        K7's iteration in true scale: 12.7 ms.
//   fold        mask float32 mask / sqrt(n), y masked by its sign: C1 has no
//               scale multiply (and reads a float32 mask): 12.7 ms.
//   fold_hfb    the H_{f_b} fragments hold +-bf16(1 / sqrt(n)) (register
//               bits, no load): neither C1 nor R3 multiplies by the scale:
//               12.7 ms.
//   no_trace    R3 stores no trace (the wrapper hands a zero one): 12.7 ms.
//   exp2        R3's exp as exp2f(x log2(e)): 12.7 ms.
//   bf16_radix  the H_{m_a} (R2, R3) and H_{f_a} (C1, C2) butterflies on
//               bf16 pairs (__hadd2 / __hsub2, each result rounded): 12.7 ms.
//   midbf16     the H_{m_b} products rounded to bf16 and H_{m_a} on bf16
//               pairs (R2, R3); H_{f_a} float32: 12.7 ms.
//   fXmY        f_b = X (the column stage's slab height), m_b = Y (the row
//               stage's column block): f128m256, f128m512, f256m128,
//               f64m128: 12.7 ms.
//   pair        two codewords per block in all four launches, each phase
//               (load, products, butterflies, epilogue) issued for both
//               before the next.  The column block then holds two bf16 (L,
//               32) strips, 160 KB: one block an SM where K7's column stage
//               has two of 80 KB, so the SM holds the same bytes in half the
//               blocks; the row blocks hold two 16-row tiles (33 KB).  Its
//               trace holds every codeword (the wrapper keeps the first of
//               each pair, as the script stores).  Its bits are full's: the
//               residual and the softmax input round each operation on its
//               own, so neither compilation contracts them: 12.7 ms.
//   no_radix    no H_{m_a}, no H_{f_a}: (2T - 1) E 14 + 12 T E: 10.2 ms.
//   no_mm       the products replaced by the bf16 values they would read
//               (loads, no mma); butterflies kept: 5 adds: 5.6 ms.
//   no_softmax  R3: beta = (sq / tau2) s 1e-3 (no max, exp, sums): 8 other
//               operations: 11.7 ms.
//   no_consume  C1: z = H(beta) (no y, mask, z reads); R3 as no_softmax: 5
//               other operations: 10.9 ms.
//   sched       tau2 = 0.36: C1 takes no |z|^2 partials, R3 sums none: 10
//               other operations: 12.2 ms.
//   fold_sched  fold and sched: 12.2 ms.
//   compact, compact32 (csub = 128, 32): the support is the first csub
//               rows.  C1 sums the f_a slabs of each row of the strip's
//               float32 H_M (R3 stores it float32: the script sums before
//               it rounds) in slab order, rounds to bf16 and multiplies by
//               H_{f_b}[0:csub, :]; the residual and |z|^2 on csub rows.
//               R2 takes H_M of the csub rows, C2 multiplies by H_{f_b}[:,
//               0:csub] into one (f_b, M) slab per codeword, R3 adds that
//               slab to every slab's beta.  Bound by the rows produced:
//               6.4 ms (128), 6.2 ms (32).  No real operator has this
//               support: timing only.
//
// Shapes: L = 1024, M = 512 (the script's), B up to 65535 (even for pair).
// Determinism: no float atomics; per-codeword sums are fixed-order trees in
// a block and a fixed-order pass over the per-block partials.
//
// Built by sparc_ldpc_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// and called through ctypes (plain C interface below).

#include <string.h>

#include "amp_common.cuh"
#include "amp_mma.cuh"

namespace {

// the variants, in the order of ops/amp_slab_exp.py BASE_MODES
enum Mode {
  kFull, kNoRadix, kNoMm, kNoSoftmax, kNoConsume, kBf16Radix, kMidBf16,
  kFold, kFoldSched, kFoldHfb, kNoTrace, kExp2, kSched, kCompact, kPair,
  kModes
};

constexpr int kL = 1024, kM = 512;      // the script's shape
constexpr int kNS = kM / kStrip;        // strips (|z|^2 partials) a slab
constexpr int kCW = 8;                  // warps of a column block
constexpr int kCT = 32 * kCW;
constexpr int kRT = 256;                // threads of a row block
constexpr float kSchedTau2 = 0.36f;
constexpr float kLog2e = 1.4426950408889634f;

// How a radix factor runs: float32 butterflies, not at all, or on bf16.
enum Radix { kRadixF32, kRadixNone, kRadixBf16 };

__host__ __device__ constexpr int row_radix(int m) {
  return m == kNoRadix ? kRadixNone
         : (m == kBf16Radix || m == kMidBf16) ? kRadixBf16 : kRadixF32;
}
__host__ __device__ constexpr int col_radix(int m) {
  return m == kNoRadix    ? kRadixNone
         : m == kBf16Radix ? kRadixBf16 : kRadixF32;
}
__host__ __device__ constexpr bool has_products(int m) {
  return m != kNoMm;
}
// the mode whose transforms (R2, C2, R3's H_M) a mode runs
__host__ __device__ constexpr int xform(int m) {
  return (m == kNoRadix || m == kNoMm || m == kBf16Radix || m == kMidBf16)
             ? m : kFull;
}
// the mode whose C1 a mode runs (those that change R3 only run full's)
__host__ __device__ constexpr int c1_mode(int m) {
  return (m == kNoSoftmax || m == kNoTrace || m == kExp2) ? kFull : m;
}
__host__ __device__ constexpr bool is_fold(int m) {
  return m == kFold || m == kFoldSched;
}
__host__ __device__ constexpr bool is_sched(int m) {
  return m == kSched || m == kFoldSched;
}
__host__ __device__ constexpr bool is_linear(int m) {
  return m == kNoSoftmax || m == kNoConsume;
}

// bf16 bits of c H[r][k] and c H[r][k + 1] (low half first), pos the bits of
// +c: 0x3F80 for the +-1 factor, bf16(1 / sqrt(n)) for fold_hfb.
__device__ __forceinline__ uint32_t h_pair_c(int r, int k, uint32_t pos) {
  const uint32_t lo = (__popc(r & k) & 1) ? pos ^ 0x8000u : pos;
  const uint32_t hi = (__popc(r & (k + 1)) & 1) ? pos ^ 0x8000u : pos;
  return lo | (hi << 16);
}

__device__ __forceinline__ float2 bf16x2_at(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// tile_fwht on bf16 values: each input rounded to bf16, every butterfly's
// sum and difference rounded to bf16 (stride 1 first); a no-op for N = 1,
// as the script's radix returns a lone tile unrounded.
template <int N>
__device__ __forceinline__ void tile_fwht_bf16(float (&v)[N][4]) {
  if constexpr (N > 1) {
    __nv_bfloat162 h[N][2];
#pragma unroll
    for (int a = 0; a < N; ++a) {
      h[a][0] = __floats2bfloat162_rn(v[a][0], v[a][1]);
      h[a][1] = __floats2bfloat162_rn(v[a][2], v[a][3]);
    }
#pragma unroll
    for (int s = 1; s < N; s <<= 1) {
#pragma unroll
      for (int a = 0; a < N; ++a) {
        if ((a & s) == 0) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const __nv_bfloat162 x = h[a][e], w = h[a + s][e];
            h[a][e] = __hadd2(x, w);
            h[a + s][e] = __hsub2(x, w);
          }
        }
      }
    }
#pragma unroll
    for (int a = 0; a < N; ++a) {
      const float2 lo = __bfloat1622float2(h[a][0]);
      const float2 hi = __bfloat1622float2(h[a][1]);
      v[a][0] = lo.x;
      v[a][1] = lo.y;
      v[a][2] = hi.x;
      v[a][3] = hi.y;
    }
  }
}

template <int RADIX, int N>
__device__ __forceinline__ void radix(float (&v)[N][4]) {
  if constexpr (RADIX == kRadixF32) {
    tile_fwht<N>(v);
  } else if constexpr (RADIX == kRadixBf16) {
    tile_fwht_bf16<N>(v);
  }
}

// ------------------------------------------------------------- row H_M
//
// As amp_mma.cuh slab_hm_apply, with m_b = MB a parameter of its own
// (SlabRows fixes m_b = min(128, M)) and C codewords a block: per column
// block X H_{MB} on the tensor cores (or, for no_mm, the data itself), then
// H_{M / MB} across the blocks in the mode's radix (for midbf16 and
// bf16_radix the products are rounded to bf16 as the butterflies take them,
// and the store rounds a lone block); each thread hands its
// results to store(c, row, col, v[col], v[col + 1]) (row < 16, col even).

template <int MB>
struct XRows {
  static constexpr int MA = kM / MB;            // m_a
  static constexpr int NT = MB / 8;             // 8-column tiles of a block
  static constexpr int NW = NT < 8 ? NT : 8;    // warps
  static constexpr int NPW = NT / NW;           // tiles of a block per warp
  static constexpr int LDA = kM + 8;            // padded bf16 row
  static constexpr int SA = kTile * LDA;        // one codeword's tile
  static_assert(32 * NW == kRT, "a row block has kRT threads");
};

template <int MODE, int MB, int C, typename Store>
__device__ __forceinline__ void x_hm(const __nv_bfloat16* sA, Store store) {
  using S = XRows<MB>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const uint32_t b0 = h_pair(g, 2 * q), b1 = h_pair(g, 2 * q + 8);
#pragma unroll
  for (int s = 0; s < S::NPW; ++s) {
    const int n0 = 8 * (warp + S::NW * s);
    const uint32_t f = (n0 & 8) ? kNeg : 0u;
    float acc[C][S::MA][4];
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int jb = 0; jb < S::MA; ++jb) {
        if constexpr (has_products(MODE)) {
          acc[c][jb][0] = acc[c][jb][1] = acc[c][jb][2] = acc[c][jb][3] = 0.f;
        } else {
          const __nv_bfloat16* pa =
              sA + c * S::SA + g * S::LDA + jb * MB + n0 + 2 * q;
          const float2 lo = bf16x2_at(pa), hi = bf16x2_at(pa + 8 * S::LDA);
          acc[c][jb][0] = lo.x;
          acc[c][jb][1] = lo.y;
          acc[c][jb][2] = hi.x;
          acc[c][jb][3] = hi.y;
        }
      }
    }
    if constexpr (has_products(MODE)) {
#pragma unroll
      for (int jb = 0; jb < S::MA; ++jb) {
#pragma unroll
        for (int k0 = 0; k0 < MB; k0 += kTile) {
          const uint32_t sg = (__popc(k0 & n0) & 1) ? kNeg : 0u;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const __nv_bfloat16* pa =
                sA + c * S::SA + g * S::LDA + jb * MB + k0 + 2 * q;
            const uint32_t a0 = *reinterpret_cast<const uint32_t*>(pa);
            const uint32_t a1 =
                *reinterpret_cast<const uint32_t*>(pa + 8 * S::LDA);
            const uint32_t a2 = *reinterpret_cast<const uint32_t*>(pa + 8);
            const uint32_t a3 =
                *reinterpret_cast<const uint32_t*>(pa + 8 * S::LDA + 8);
            mma_bf16(acc[c][jb][0], acc[c][jb][1], acc[c][jb][2],
                     acc[c][jb][3], a0, a1, a2, a3, b0 ^ sg, b1 ^ sg ^ f);
          }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) radix<row_radix(MODE), S::MA>(acc[c]);
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int jb = 0; jb < S::MA; ++jb) {
        const int col = jb * MB + n0 + 2 * q;
        store(c, g, col, acc[c][jb][0], acc[c][jb][1]);
        store(c, g + 8, col, acc[c][jb][2], acc[c][jb][3]);
      }
    }
  }
}

// Rows [r0, r0 + 16) of x (rows rows a codeword, kM columns) of codeword b
// into sA as bf16.
__device__ __forceinline__ void load_rows_bf16(const float* __restrict__ x,
                                               __nv_bfloat16* sA, int lda,
                                               size_t base) {
  for (int e = threadIdx.x; e < kTile * kM / 4; e += blockDim.x) {
    const int r = e / (kM / 4), c4 = e % (kM / 4);
    const float4 v =
        *reinterpret_cast<const float4*>(x + base + (size_t)r * kM + 4 * c4);
    *reinterpret_cast<uint2*>(sA + r * lda + 4 * c4) =
        make_uint2(bf16_pair(v.x, v.y), bf16_pair(v.z, v.w));
  }
}

// R2: out = bf16(H_M bf16(z)) for every row of z (B, rows, kM), 16 rows a
// block, C codewords a block.
template <int MODE, int MB, int C>
__global__ void __launch_bounds__(kRT)
slabx_r2_kernel(const float* __restrict__ z, __nv_bfloat16* __restrict__ out,
                int rows) {
  using S = XRows<MB>;
  __shared__ __align__(16) __nv_bfloat16 sA[C * S::SA];
  const size_t r0 = (size_t)blockIdx.x * kTile;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const size_t b = (size_t)blockIdx.y * C + c;
    load_rows_bf16(z, sA + c * S::SA, S::LDA, (b * rows + r0) * kM);
  }
  __syncthreads();
  x_hm<MODE, MB, C>(sA, [=](int c, int r, int col, float v0, float v1) {
    const size_t b = (size_t)blockIdx.y * C + c;
    *reinterpret_cast<uint32_t*>(out + (b * rows + r0 + r) * kM + col) =
        bf16_pair(v0, v1);
  });
}

// ---------------------------------------------------------------- columns
//
// K7's column stage (amp_slab.cu slab_col_kernel) at L = 1024 with FB rows a
// slab (FAL = 1024 / FB slabs) and C codewords a block: the strips' bf16
// tiles in shared memory (kLdX bf16 a row), warp w computes the (16-row tile
// i, 8-column tile j) pairs p = w + 8 s of every slab; the A operand of the
// mma is c H_{FB}[16 i + r][16 kk + k] (c = 1, or bf16(1 / sqrt(n))), the B
// operand the strip's X[16 kk + k][8 j + n].  D holds rows 16 i + g and + 8,
// columns 8 j + 2 q and + 1; H_{FAL} across the slabs is in registers.

struct ColArgs {
  const __nv_bfloat16* work;  // (B, kL, kM): bf16(H_M bf16(.))
  float* u;                   // C2: (B, kL, kM) H(z)
  const float* y;             // (B, kL, kM) the observation
  float* z;                   // (B, kL, kM)
  const void* mask;           // (kL, kM): bf16 0/1, float mask / sqrt(n)
  float* zpart;               // (B, FAL, kNS)
  const float* bpart;         // (B, FAL)
  const float* tau2c;         // (B,)
  int t;
  float P, n, inv_sqrt_n;
  uint32_t hpos;              // bf16 bits of H_{f_b}'s +1 entry
};

// the C strips' bf16 tiles of `rows` rows from work into sx
template <int C>
__device__ __forceinline__ void load_strips(
    const __nv_bfloat16* __restrict__ work, __nv_bfloat16* sx, int rows,
    int b0, int m0) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const size_t base = (size_t)(b0 + c) * rows * kM;
    for (int e = threadIdx.x; e < rows * 4; e += kCT) {
      const int r = e >> 2, part = e & 3;
      *reinterpret_cast<uint4*>(sx + (c * rows + r) * kLdX + 8 * part) =
          *reinterpret_cast<const uint4*>(work + base + (size_t)r * kM + m0 +
                                          8 * part);
    }
  }
}

// acc += c H_{f_b}[16 i .. + 16][rows kk < KT of X] X, X the bf16 tile at sx
// (rows 16 kk + k, columns 8 j + n).
template <int KT>
__device__ __forceinline__ void hfb_mma(float (&acc)[4],
                                        const __nv_bfloat16* sx, int i, int j,
                                        const uint32_t (&ha)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    const uint32_t sg = (__popc(i & kk) & 1) ? kNeg : 0u;
    const __nv_bfloat16* px = sx + (kTile * kk + 2 * q) * kLdX + 8 * j + g;
    const uint32_t b0 = bf16_bits(px[0]) | (bf16_bits(px[kLdX]) << 16);
    const uint32_t b1 =
        bf16_bits(px[8 * kLdX]) | (bf16_bits(px[9 * kLdX]) << 16);
    mma_bf16(acc[0], acc[1], acc[2], acc[3], ha[0] ^ sg, ha[1] ^ sg,
             ha[2] ^ sg, ha[3] ^ sg, b0, b1);
  }
}

__device__ __forceinline__ void h_frag(uint32_t (&ha)[4], uint32_t pos) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  ha[0] = h_pair_c(g, 2 * q, pos);
  ha[1] = h_pair_c(g + 8, 2 * q, pos);
  ha[2] = h_pair_c(g, 2 * q + 8, pos);
  ha[3] = h_pair_c(g + 8, 2 * q + 8, pos);
}

// coef = (P - |beta|^2 / n) / tau2_prev of codeword b (0 at t = 0)
template <int FAL>
__device__ __forceinline__ float onsager(const ColArgs& a, int b) {
  if (a.t == 0) return 0.f;
  float bn = 0.f;
#pragma unroll 1
  for (int s = 0; s < FAL; ++s) bn += a.bpart[(size_t)b * FAL + s];
  return (a.P - bn / a.n) / a.tau2c[b];
}

// The residual of two neighbouring elements at (l, col) of codeword b, from
// w = H(beta) there (unscaled but for fold_hfb).  Every product and sum is
// rounded on its own (__fmul_rn, __fadd_rn: no contraction into an FMA), in
// the plain version's order, so the residual does not depend on how the
// compiler schedules a variant.
template <int MODE>
__device__ __forceinline__ float2 residual(const ColArgs& a, size_t off,
                                           int l, int col, float w0,
                                           float w1, float coef) {
  if constexpr (MODE == kNoConsume) return make_float2(w0, w1);
  const float2 yv = *reinterpret_cast<const float2*>(a.y + off);
  float z0, z1;
  if constexpr (is_fold(MODE)) {
    const float2 mf = *reinterpret_cast<const float2*>(
        static_cast<const float*>(a.mask) + (size_t)l * kM + col);
    z0 = __fsub_rn(mf.x > 0.f ? yv.x : 0.f, __fmul_rn(mf.x, w0));
    z1 = __fsub_rn(mf.y > 0.f ? yv.y : 0.f, __fmul_rn(mf.y, w1));
  } else {
    const float2 mk = bf16x2_at(static_cast<const __nv_bfloat16*>(a.mask) +
                                (size_t)l * kM + col);
    if constexpr (MODE != kFoldHfb) {
      w0 = __fmul_rn(w0, a.inv_sqrt_n);
      w1 = __fmul_rn(w1, a.inv_sqrt_n);
    }
    z0 = __fsub_rn(__fmul_rn(mk.x, yv.x), __fmul_rn(mk.x, w0));
    z1 = __fsub_rn(__fmul_rn(mk.y, yv.y), __fmul_rn(mk.y, w1));
  }
  if (a.t > 0) {
    const float2 zo = *reinterpret_cast<const float2*>(a.z + off);
    z0 = __fadd_rn(z0, __fmul_rn(coef, zo.x));
    z1 = __fadd_rn(z1, __fmul_rn(coef, zo.y));
  }
  return make_float2(z0, z1);
}

// C1 (RESID) and C2 of MODE with slabs of FB rows, C codewords a block.
template <int MODE, int FB, int C, bool RESID>
__device__ __forceinline__ void col_body(const ColArgs& a) {
  constexpr int FAL = kL / FB;
  constexpr int PPW = (FB / kTile) * (kStrip / 8) / kCW;
  static_assert(PPW >= 1, "a warp owns at least one tile pair");
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sx = reinterpret_cast<__nv_bfloat16*>(smem);
  __shared__ float red[kCW][C][FAL];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int b0 = blockIdx.y * C, strip = blockIdx.x, m0 = strip * kStrip;
  // beta = 0 before the first iteration: no forward transform there
  const bool transform = !RESID || a.t > 0;
  float coef[C];
#pragma unroll
  for (int c = 0; c < C; ++c) coef[c] = RESID ? onsager<FAL>(a, b0 + c) : 0.f;
  if (transform) {
    load_strips<C>(a.work, sx, kL, b0, m0);
    __syncthreads();
  }
  uint32_t ha[4];
  h_frag(ha, a.hpos);
  float zz[C][FAL];
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int s = 0; s < FAL; ++s) zz[c][s] = 0.f;
#pragma unroll 1
  for (int s = 0; s < PPW; ++s) {
    const int p = warp + kCW * s;
    const int i = p >> 2, j = p & 3;
    float acc[C][FAL][4];
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int f = 0; f < FAL; ++f)
        acc[c][f][0] = acc[c][f][1] = acc[c][f][2] = acc[c][f][3] = 0.f;
    if (transform) {
      if constexpr (has_products(MODE)) {
#pragma unroll
        for (int f = 0; f < FAL; ++f)
#pragma unroll
          for (int c = 0; c < C; ++c)
            hfb_mma<FB / kTile>(acc[c][f], sx + (c * kL + f * FB) * kLdX, i,
                                j, ha);
      } else {  // no_mm: the values the product would read
#pragma unroll
        for (int c = 0; c < C; ++c) {
#pragma unroll
          for (int f = 0; f < FAL; ++f) {
            const __nv_bfloat16* px =
                sx + (c * kL + f * FB + kTile * i + g) * kLdX + 8 * j + 2 * q;
            const float2 lo = bf16x2_at(px), hi = bf16x2_at(px + 8 * kLdX);
            acc[c][f][0] = lo.x;
            acc[c][f][1] = lo.y;
            acc[c][f][2] = hi.x;
            acc[c][f][3] = hi.y;
          }
        }
      }
#pragma unroll
      for (int c = 0; c < C; ++c) radix<col_radix(MODE), FAL>(acc[c]);
    }
    const int col = m0 + 8 * j + 2 * q;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const size_t base = (size_t)(b0 + c) * kL * kM;
#pragma unroll
      for (int f = 0; f < FAL; ++f) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int l = f * FB + kTile * i + g + 8 * h;
          const size_t off = base + (size_t)l * kM + col;
          const float w0 = acc[c][f][2 * h], w1 = acc[c][f][2 * h + 1];
          if constexpr (RESID) {
            const float2 zn = residual<MODE>(a, off, l, col, w0, w1, coef[c]);
            *reinterpret_cast<float2*>(a.z + off) = zn;
            zz[c][f] += zn.x * zn.x + zn.y * zn.y;
          } else {
            *reinterpret_cast<float2*>(a.u + off) = make_float2(w0, w1);
          }
        }
      }
    }
  }
  if constexpr (RESID && !is_sched(MODE)) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int f = 0; f < FAL; ++f) {
        const float v = warp_sum(zz[c][f]);
        if (lane == 0) red[warp][c][f] = v;
      }
    }
    __syncthreads();
    if (threadIdx.x < C * FAL) {
      const int c = threadIdx.x / FAL, f = threadIdx.x % FAL;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kCW; ++w) sum += red[w][c][f];
      a.zpart[((size_t)(b0 + c) * FAL + f) * kNS + strip] = sum;
    }
  }
}

template <int MODE, int FB, int C>
__global__ void __launch_bounds__(kCT, C == 1 ? 2 : 1)
slabx_c1_kernel(ColArgs a) {
  col_body<MODE, FB, C, true>(a);
}

template <int MODE, int FB, int C>
__global__ void __launch_bounds__(kCT, C == 1 ? 2 : 1)
slabx_c2_kernel(ColArgs a) {
  col_body<MODE, FB, C, false>(a);
}

// compact C1: the strip's float32 H_M of beta (work as float (B, kL, kM))
// summed over the slabs in slab order, rounded to bf16 (FB rows), times
// H_{FB}[0:CSUB, :]; the residual and |z|^2 on the CSUB rows (z (B, CSUB,
// kM)); zpart (B, 1, kNS).
template <int FB, int CSUB>
__global__ void __launch_bounds__(kCT)
slabx_c1_compact_kernel(ColArgs a) {
  constexpr int FAL = kL / FB, NP = (CSUB / kTile) * (kStrip / 8);
  __shared__ __align__(16) __nv_bfloat16 sx[FB * kLdX];
  __shared__ float red[kCW];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int b = blockIdx.y, strip = blockIdx.x, m0 = strip * kStrip;
  const float coef = onsager<FAL>(a, b);
  const float* hm = reinterpret_cast<const float*>(a.work);
  const size_t base = (size_t)b * kL * kM;
  if (a.t > 0) {
    for (int e = threadIdx.x; e < FB * 8; e += kCT) {
      const int r = e >> 3, part = e & 7;
      const float* p = hm + base + (size_t)r * kM + m0 + 4 * part;
      float4 s = *reinterpret_cast<const float4*>(p);
#pragma unroll 1
      for (int f = 1; f < FAL; ++f) {
        const float4 v =
            *reinterpret_cast<const float4*>(p + (size_t)f * FB * kM);
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      }
      *reinterpret_cast<uint2*>(sx + r * kLdX + 4 * part) =
          make_uint2(bf16_pair(s.x, s.y), bf16_pair(s.z, s.w));
    }
    __syncthreads();
  }
  uint32_t ha[4];
  h_frag(ha, a.hpos);
  float zz = 0.f;
  for (int p = warp; p < NP; p += kCW) {
    const int i = p >> 2, j = p & 3;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    if (a.t > 0) hfb_mma<FB / kTile>(acc, sx, i, j, ha);
    const int col = m0 + 8 * j + 2 * q;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int l = kTile * i + g + 8 * h;
      const size_t zoff = ((size_t)b * CSUB + l) * kM + col;
      const float2 yv =
          *reinterpret_cast<const float2*>(a.y + base + (size_t)l * kM + col);
      const float2 mk = bf16x2_at(static_cast<const __nv_bfloat16*>(a.mask) +
                                  (size_t)l * kM + col);
      float z0 = __fsub_rn(__fmul_rn(mk.x, yv.x),
                           __fmul_rn(mk.x, __fmul_rn(acc[2 * h],
                                                     a.inv_sqrt_n)));
      float z1 = __fsub_rn(__fmul_rn(mk.y, yv.y),
                           __fmul_rn(mk.y, __fmul_rn(acc[2 * h + 1],
                                                     a.inv_sqrt_n)));
      if (a.t > 0) {
        const float2 zo = *reinterpret_cast<const float2*>(a.z + zoff);
        z0 = __fadd_rn(z0, __fmul_rn(coef, zo.x));
        z1 = __fadd_rn(z1, __fmul_rn(coef, zo.y));
      }
      *reinterpret_cast<float2*>(a.z + zoff) = make_float2(z0, z1);
      zz += z0 * z0 + z1 * z1;
    }
  }
  const float sum = block_sum<kCW>(zz, red);
  if (threadIdx.x == 0) a.zpart[(size_t)b * kNS + strip] = sum;
}

// compact C2: u (B, FB, kM) = H_{FB}[:, 0:CSUB] times the strip of R2's
// bf16(H_M bf16(z)) (work as bf16 (B, CSUB, kM)).
template <int FB, int CSUB>
__global__ void __launch_bounds__(kCT)
slabx_c2_compact_kernel(ColArgs a) {
  constexpr int NP = (FB / kTile) * (kStrip / 8);
  __shared__ __align__(16) __nv_bfloat16 sx[CSUB * kLdX];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int b = blockIdx.y, m0 = blockIdx.x * kStrip;
  load_strips<1>(a.work, sx, CSUB, b, m0);
  __syncthreads();
  uint32_t ha[4];
  h_frag(ha, a.hpos);
  for (int p = warp; p < NP; p += kCW) {
    const int i = p >> 2, j = p & 3;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    hfb_mma<CSUB / kTile>(acc, sx, i, j, ha);
    const int col = m0 + 8 * j + 2 * q;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int l = kTile * i + g + 8 * h;
      *reinterpret_cast<float2*>(a.u + ((size_t)b * FB + l) * kM + col) =
          make_float2(acc[2 * h], acc[2 * h + 1]);
    }
  }
}

// ------------------------------------------------------------------- rows

struct RowArgs {
  const float* u;        // (B, kL, kM) H(z); compact: (B, FB, kM)
  float* beta;           // (B, kL, kM) true scale
  void* work;            // H_M of the new beta: bf16, compact float
  const float* zpart;    // (B, FAL or 1, kNS)
  float* bpart;          // (B, FAL)
  float* trace;          // (T, B)
  float* tau2c;          // (B,)
  const float* sq;       // (kL,)
  int B, t, tr, last;    // iteration, its trace row, no next iteration
  float n, inv_sqrt_n;
};

// R3 of iteration t, one block per (slab, C codewords), the slab's FB rows
// 16 at a time, one warp per row at a time (lane i holds columns i + 32 e).
template <int MODE, int FB, int MB, int C>
__global__ void __launch_bounds__(kRT)
slabx_r3_kernel(RowArgs a) {
  using S = XRows<MB>;
  constexpr int EPL = kM / 32, FAL = kL / FB;
  constexpr bool kCompactRows = MODE == kCompact;
  constexpr int ZP = kCompactRows ? 1 : FAL;
  __shared__ __align__(16) __nv_bfloat16 sA[C * S::SA];
  __shared__ float red[S::NW];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slab = blockIdx.x, b0 = blockIdx.y * C;
  float tau2[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if constexpr (is_sched(MODE)) {
      tau2[c] = kSchedTau2;
    } else {
      // each slab's strips, then the slabs in slab order
      float zz = 0.f;
#pragma unroll 1
      for (int sl = 0; sl < ZP; ++sl) {
        float zs = 0.f;
#pragma unroll
        for (int k = 0; k < kNS; ++k)
          zs += a.zpart[((size_t)(b0 + c) * ZP + sl) * kNS + k];
        zz += zs;
      }
      tau2[c] = zz / a.n;
    }
  }
  float bb[C];
#pragma unroll
  for (int c = 0; c < C; ++c) bb[c] = 0.f;
#pragma unroll 1
  for (int tile = 0; tile < FB / kTile; ++tile) {
    const int l0 = slab * FB + kTile * tile;
    for (int r = warp; r < kTile; r += S::NW) {
      const int l = l0 + r;
      float v[C][EPL];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const size_t b = b0 + c;
        const size_t off = (b * kL + l) * kM + lane;
        const size_t uoff =
            kCompactRows ? (b * FB + (l - slab * FB)) * kM + lane : off;
#pragma unroll
        for (int e = 0; e < EPL; ++e) {  // rounded as the residual
          float s = a.u[uoff + 32 * e];
          if constexpr (MODE != kFoldHfb) s = __fmul_rn(s, a.inv_sqrt_n);
          if (a.t > 0) s = __fadd_rn(s, a.beta[off + 32 * e]);
          v[c][e] = s;
        }
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float ai = a.sq[l] / tau2[c];
        if constexpr (is_linear(MODE)) {
#pragma unroll
          for (int e = 0; e < EPL; ++e) v[c][e] = ai * v[c][e] * 1e-3f;
        } else {
          float mx = -INFINITY;
#pragma unroll
          for (int e = 0; e < EPL; ++e) {
            v[c][e] = __fmul_rn(ai, v[c][e]);
            mx = fmaxf(mx, v[c][e]);
          }
          mx = warp_max(mx);
          float se = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) {
            const float x = v[c][e] - mx;
            v[c][e] = MODE == kExp2 ? exp2f(x * kLog2e) : expf(x);
            se += v[c][e];
          }
          se = warp_sum(se);
          const float so = a.sq[l] / se;
#pragma unroll
          for (int e = 0; e < EPL; ++e) v[c][e] = so * v[c][e];
        }
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const size_t off = ((size_t)(b0 + c) * kL + l) * kM + lane;
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          a.beta[off + 32 * e] = v[c][e];
          if (!a.last) {
            bb[c] += v[c][e] * v[c][e];
            sA[c * S::SA + r * S::LDA + lane + 32 * e] =
                __float2bfloat16_rn(v[c][e]);
          }
        }
      }
    }
    if (!a.last) {  // uniform per block
      __syncthreads();
      const size_t r0 = (size_t)l0;
      if constexpr (kCompactRows) {
        float* out = static_cast<float*>(a.work);
        x_hm<xform(MODE), MB, C>(sA, [=](int c, int r, int col, float v0,
                                         float v1) {
          const size_t b = b0 + c;
          *reinterpret_cast<float2*>(out + (b * kL + r0 + r) * kM + col) =
              make_float2(v0, v1);
        });
      } else {
        __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.work);
        x_hm<xform(MODE), MB, C>(sA, [=](int c, int r, int col, float v0,
                                         float v1) {
          const size_t b = b0 + c;
          *reinterpret_cast<uint32_t*>(out + (b * kL + r0 + r) * kM + col) =
              bf16_pair(v0, v1);
        });
      }
      __syncthreads();  // sA is refilled by the next tile
    }
  }
  if (!a.last) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float sum = block_sum<S::NW>(bb[c], red);
      if (threadIdx.x == 0) a.bpart[(size_t)(b0 + c) * FAL + slab] = sum;
    }
  }
  if (slab == 0 && threadIdx.x == 0) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      a.tau2c[b0 + c] = tau2[c];
      if constexpr (MODE != kNoTrace)
        a.trace[(size_t)a.tr * a.B + b0 + c] = tau2[c];
    }
  }
}

// ------------------------------------------------------------- launchers

struct RunArgs {
  const float* y;
  const void* mask;
  const float* sq;
  float *beta, *trace, *z, *u;
  void *work, *workz;
  float *zpart, *bpart, *tau2c;
  int B, t0, T, keep;
  float P, n, inv_sqrt_n;
  uint32_t hpos;
};

ColArgs col_args(const RunArgs& r, const void* work, int t) {
  return ColArgs{static_cast<const __nv_bfloat16*>(work),
                 r.u,
                 r.y,
                 r.z,
                 r.mask,
                 r.zpart,
                 r.bpart,
                 r.tau2c,
                 t,
                 r.P,
                 r.n,
                 r.inv_sqrt_n,
                 r.hpos};
}

// iteration t of the run: the trace row t - t0, and no work tile or
// |beta|^2 after the run's last iteration unless the state is kept
RowArgs row_args(const RunArgs& r, int t) {
  const int last = !r.keep && t == r.t0 + r.T - 1;
  return RowArgs{r.u,     r.beta, r.work, r.zpart, r.bpart, r.trace,
                 r.tau2c, r.sq,   r.B,    t,       t - r.t0, last,
                 r.n,     r.inv_sqrt_n};
}

template <typename K>
int col_launch(K kernel, int C, int gy, const ColArgs& a, cudaStream_t st) {
  const int bytes = C * kL * kLdX * (int)sizeof(__nv_bfloat16);
  int rc = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc) return rc;
  kernel<<<dim3(kNS, gy), kCT, bytes, st>>>(a);
  return (int)cudaGetLastError();
}

// T iterations of MODE (f_b = FB, m_b = MB, C codewords a block)
template <int MODE, int FB, int MB, int C>
int run_decode(const RunArgs& r, cudaStream_t st) {
  constexpr int FAL = kL / FB;
  const int gy = r.B / C;
  __nv_bfloat16* work = static_cast<__nv_bfloat16*>(r.work);
  if (r.t0 > 0) {  // resume: the work tile R3 would have left, from beta
    slabx_r2_kernel<xform(MODE), MB, 1><<<dim3(kL / kTile, r.B), kRT, 0, st>>>(
        r.beta, work, kL);
    const int rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  for (int t = r.t0; t < r.t0 + r.T; ++t) {
    const ColArgs ca = col_args(r, work, t);
    int rc = col_launch(slabx_c1_kernel<c1_mode(MODE), FB, C>, C, gy, ca, st);
    if (rc) return rc;
    slabx_r2_kernel<xform(MODE), MB, C><<<dim3(kL / kTile, gy), kRT, 0, st>>>(
        r.z, work, kL);
    rc = (int)cudaGetLastError();
    if (rc) return rc;
    rc = col_launch(slabx_c2_kernel<xform(MODE), FB, C>, C, gy, ca, st);
    if (rc) return rc;
    slabx_r3_kernel<MODE, FB, MB, C><<<dim3(FAL, gy), kRT, 0, st>>>(
        row_args(r, t));
    rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  return 0;
}

// T iterations of compact with support rows [0, CSUB) (f_b = m_b = 128):
// work holds the float32 H_M of beta, workz the bf16 H_M of z.
template <int CSUB>
int run_compact(const RunArgs& r, cudaStream_t st) {
  constexpr int FB = 128, FAL = kL / FB;
  for (int t = 0; t < r.T; ++t) {
    slabx_c1_compact_kernel<FB, CSUB><<<dim3(kNS, r.B), kCT, 0, st>>>(
        col_args(r, r.work, t));
    int rc = (int)cudaGetLastError();
    if (rc) return rc;
    slabx_r2_kernel<kFull, 128, 1><<<dim3(CSUB / kTile, r.B), kRT, 0, st>>>(
        r.z, static_cast<__nv_bfloat16*>(r.workz), CSUB);
    rc = (int)cudaGetLastError();
    if (rc) return rc;
    slabx_c2_compact_kernel<FB, CSUB><<<dim3(kNS, r.B), kCT, 0, st>>>(
        col_args(r, r.workz, t));
    rc = (int)cudaGetLastError();
    if (rc) return rc;
    slabx_r3_kernel<kCompact, FB, 128, 1><<<dim3(FAL, r.B), kRT, 0, st>>>(
        row_args(r, t));
    rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  return 0;
}

// the bf16 bits (round to nearest even) of a finite float, on the host
uint32_t bf16_bits_host(float x) {
  uint32_t u;
  memcpy(&u, &x, sizeof(u));
  u += 0x7FFFu + ((u >> 16) & 1u);
  return u >> 16;
}

int dispatch(int mode, int fb, int mb, int csub, const RunArgs& r,
             cudaStream_t st) {
  const bool std_f = fb == 128 && mb == 128;
  if (mode == kCompact) {
    if (!std_f || r.t0 || r.keep) return kBadShape;
    if (csub == 128) return run_compact<128>(r, st);
    if (csub == 32) return run_compact<32>(r, st);
    return kBadShape;
  }
  if (mode == kFull) {
    if (std_f) return run_decode<kFull, 128, 128, 1>(r, st);
    if (fb == 128 && mb == 256) return run_decode<kFull, 128, 256, 1>(r, st);
    if (fb == 128 && mb == 512) return run_decode<kFull, 128, 512, 1>(r, st);
    if (fb == 256 && mb == 128) return run_decode<kFull, 256, 128, 1>(r, st);
    if (fb == 64 && mb == 128) return run_decode<kFull, 64, 128, 1>(r, st);
    return kBadShape;
  }
  if (!std_f) return kBadShape;
  switch (mode) {
    case kNoRadix: return run_decode<kNoRadix, 128, 128, 1>(r, st);
    case kNoMm: return run_decode<kNoMm, 128, 128, 1>(r, st);
    case kNoSoftmax: return run_decode<kNoSoftmax, 128, 128, 1>(r, st);
    case kNoConsume: return run_decode<kNoConsume, 128, 128, 1>(r, st);
    case kBf16Radix: return run_decode<kBf16Radix, 128, 128, 1>(r, st);
    case kMidBf16: return run_decode<kMidBf16, 128, 128, 1>(r, st);
    case kFold: return run_decode<kFold, 128, 128, 1>(r, st);
    case kFoldSched: return run_decode<kFoldSched, 128, 128, 1>(r, st);
    case kFoldHfb: return run_decode<kFoldHfb, 128, 128, 1>(r, st);
    case kNoTrace: return run_decode<kNoTrace, 128, 128, 1>(r, st);
    case kExp2: return run_decode<kExp2, 128, 128, 1>(r, st);
    case kSched: return run_decode<kSched, 128, 128, 1>(r, st);
    case kPair:
      if (r.B % 2) return kBadShape;
      return run_decode<kFull, 128, 128, 2>(r, st);
    default: return kBadShape;
  }
}

}  // namespace

extern "C" {

// Variant `mode` (the order of ops/amp_slab_exp.py BASE_MODES) with slab
// height fb, column block mb and, for compact, support rows csub, for B
// codewords and T fixed iterations at L = 1024, M = 512.  Inputs: y (B, L,
// M) the observation (masked here); mask (L, M) bfloat16 0/1, or float
// mask / sqrt(n) for fold and fold_sched; sq (L,) sqrt(n P_l).  Outputs:
// beta (B, L, M) true scale; trace (T, B), not written by no_trace.
// Scratch: z (B, L, M) float (compact: (B, csub, M)); u (B, L, M) float
// (compact: (B, 128, M)); work (B, L, M) bfloat16 (compact: float); workz
// (B, csub, M) bfloat16 (compact only); zpart (B, L / fb, M / 32) (compact:
// (B, 1, M / 32)); bpart (B, L / fb); tau2c (B,).  hscale: H_{f_b}'s
// entries are +-bf16(hscale) (1, or 1 / sqrt(n) for fold_hfb).  Iterations
// t0 .. t0 + T - 1 run, trace row t - t0.  t0 = 0 starts from beta = 0;
// t0 >= 1 resumes from the state in beta, z (the last residual), bpart
// (whose row sums are |beta|^2) and tau2c (the last tau2).  keep = 1 leaves
// that state after the last iteration (compact: neither).  Returns 0, a
// cudaError_t, or -1 for an unsupported shape or variant.
int amp_slab_exp_run(int mode, int fb, int mb, int csub, const float* y,
                     const void* mask, const float* sq, float* beta,
                     float* trace, float* z, float* u, void* work,
                     void* workz, float* zpart, float* bpart, float* tau2c,
                     int B, int t0, int T, int keep, float P, float n,
                     float inv_sqrt_n, float hscale, void* stream) {
  if (B < 1 || B > 65535 || T < 1 || t0 < 0 || mode < 0 || mode >= kModes)
    return kBadShape;
  const RunArgs r{y,     mask,  sq,    beta,  trace, z,
                  u,     work,  workz, zpart, bpart, tau2c,
                  B,     t0,    T,     keep,  P,     n,
                  inv_sqrt_n,   bf16_bits_host(hscale)};
  return dispatch(mode, fb, mb, csub, r, static_cast<cudaStream_t>(stream));
}

const char* amp_slab_exp_error_string(int code) {
  if (code == kBadShape) return "unsupported shape or variant";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
