// Tensor-core pieces shared by the slab form (amp_k7.cuh: K7 and its
// ablation S4) and the split kernel's experiments (amp_exp.cu): mma.sync on
// bf16 data (the strip operand through ldmatrix.trans) with +-1 Hadamard
// fragments made in registers from the parity of popcount (no factor is
// loaded), butterflies across the tiles a thread holds, and the row
// stage's H_M = H_{m_a} (x) H_{m_b} of 16 bf16 rows in shared memory.  The
// H stages take a compile-time form (HStage): K7's (products, float32
// butterflies), or S4's ablations of it.

#pragma once

#include "amp_common.cuh"

namespace {

constexpr int kTile = 16;             // rows of an mma tile
constexpr int kLdX = kStrip + 8;      // padded bf16 row of a strip tile
constexpr uint32_t kNeg = 0x80008000u;  // the sign bits of two bf16

// D (16 x 8) += A (16 x 16) B (16 x 8), bf16 data, float32 sums.
__device__ __forceinline__ void mma_bf16(float& d0, float& d1, float& d2,
                                         float& d3, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// D (16 x 8) += A (16 x 8) B (8 x 8), bf16 data, float32 sums: a0 holds
// A[g][2q .. 2q + 1], a1 A[g + 8][..], b0 B[2q .. 2q + 1][g]; d0, d1 are
// D[g][2q .. 2q + 1], d2, d3 D[g + 8][..] (g = lane / 4, q = lane % 4).
__device__ __forceinline__ void mma_bf16_k8(float& d0, float& d1, float& d2,
                                            float& d3, uint32_t a0,
                                            uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
      : "r"(a0), "r"(a1), "r"(b0));
}

// Four 8 x 8 bf16 matrices from shared memory, transposed: lanes 8 r ..
// 8 r + 7 give the row addresses of matrix r; thread (g, q) receives
// elements [2 q][g] and [2 q + 1][g] of each, the mma's B fragment.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// bf16 bits of H[r][k] and H[r][k + 1] (low half first), H[r][k] =
// (-1)^popc(r & k).
__device__ __forceinline__ uint32_t h_pair(int r, int k) {
  const uint32_t lo = (__popc(r & k) & 1) ? 0xBF80u : 0x3F80u;
  const uint32_t hi = (__popc(r & (k + 1)) & 1) ? 0xBF80u : 0x3F80u;
  return lo | (hi << 16);
}

// bf16 bits of c H[r][k] and c H[r][k + 1] (low half first), pos the bits
// of +c (0x3F80 for the +-1 factor): h_pair scaled.
__device__ __forceinline__ uint32_t h_pair_c(int r, int k, uint32_t pos) {
  const uint32_t lo = (__popc(r & k) & 1) ? pos ^ 0x8000u : pos;
  const uint32_t hi = (__popc(r & (k + 1)) & 1) ? pos ^ 0x8000u : pos;
  return lo | (hi << 16);
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t bf16_bits(__nv_bfloat16 x) {
  return __bfloat16_as_ushort(x);
}

__device__ __forceinline__ float2 bf16x2_at(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// The form of an H stage (H_L in the column launches, H_M in the row
// launch): the 128-wide factor's products and the radix factor's float32
// butterflies (K7's); products without the butterflies; the butterflies on
// the bf16 values the products would read (no mma); products and the
// butterflies on bf16 (each input and each result rounded).
enum HStage { kHProducts = 0, kHNoRadix, kHNoMm, kHBf16Radix };

// Butterflies over the first index of v[N][4] (stride 1 first): the
// Hadamard factor H_N across N tiles held by one thread.
template <int N>
__device__ __forceinline__ void tile_fwht(float (&v)[N][4]) {
#pragma unroll
  for (int h = 1; h < N; h <<= 1) {
#pragma unroll
    for (int a = 0; a < N; ++a) {
      if ((a & h) == 0) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = v[a][e], w = v[a + h][e];
          v[a][e] = x + w;
          v[a + h][e] = x - w;
        }
      }
    }
  }
}

// tile_fwht on bf16 values: each input rounded to bf16, every butterfly's
// sum and difference rounded to bf16 (stride 1 first); a no-op for N = 1.
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

// The radix factor across the N tiles of v in the form HS.
template <int HS, int N>
__device__ __forceinline__ void radix_fwht(float (&v)[N][4]) {
  if constexpr (HS == kHProducts || HS == kHNoMm) {
    tile_fwht<N>(v);
  } else if constexpr (HS == kHBf16Radix) {
    tile_fwht_bf16<N>(v);
  }
}

// ------------------------------------------------------------- row H_M
//
// A row block holds 16 rows as bf16 in shared memory (M + 8 a row).  Warp w
// computes the 8-column tiles n0 = 8 (w + NW s) of every column block jb:
// for the mma the A operand is the data, X[g][jb m_b + 16 kk + 2 q ..], the
// B operand H_{m_b}[16 kk + k][n0 + n], whose parity is popc(16 kk & n0) +
// bit3(k) bit3(n0) + popc(k & n) (amp_mono.cu hm_mma): a base fragment with
// two signs.

template <int M, int MB_ = (M > 128 ? 128 : M)>
struct SlabRows {
  static constexpr int MB = MB_;                // m_b (K7: 128 divides M > 128)
  static constexpr int MA = M / MB;             // m_a
  static constexpr int NT = MB / 8;             // 8-column tiles of a block
  static constexpr int NW = NT < 8 ? NT : 8;    // warps
  static constexpr int NPW = NT / NW;           // tiles of a block per warp
  static constexpr int THREADS = 32 * NW;
  static constexpr int LDA = M + 8;             // padded bf16 row
};

// The H_M stage of the 16 bf16 rows in sA (rows of LDA = M + 8): per
// column block of m_b = MB X H_{m_b} on the tensor cores, then H_{m_a}
// across the blocks in float32 (K7's form; HS another form); each thread
// hands its results to store(row, col, v[col], v[col + 1]) (row < 16, col
// even).
template <int M, int MB = SlabRows<M>::MB, int HS = kHProducts,
          typename Store>
__device__ __forceinline__ void slab_hm_apply(const __nv_bfloat16* sA,
                                              Store store) {
  using S = SlabRows<M, MB>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const uint32_t b0 = h_pair(g, 2 * q), b1 = h_pair(g, 2 * q + 8);
#pragma unroll
  for (int s = 0; s < S::NPW; ++s) {
    const int n0 = 8 * (warp + S::NW * s);
    const uint32_t f = (n0 & 8) ? kNeg : 0u;
    float acc[S::MA][4];
    if constexpr (HS == kHNoMm) {  // the values the products would read
#pragma unroll
      for (int jb = 0; jb < S::MA; ++jb) {
        const __nv_bfloat16* pa = sA + g * S::LDA + jb * S::MB + n0 + 2 * q;
        const float2 lo = bf16x2_at(pa), hi = bf16x2_at(pa + 8 * S::LDA);
        acc[jb][0] = lo.x;
        acc[jb][1] = lo.y;
        acc[jb][2] = hi.x;
        acc[jb][3] = hi.y;
      }
    } else {
#pragma unroll
      for (int jb = 0; jb < S::MA; ++jb)
        acc[jb][0] = acc[jb][1] = acc[jb][2] = acc[jb][3] = 0.f;
#pragma unroll
      for (int jb = 0; jb < S::MA; ++jb) {
#pragma unroll
        for (int k0 = 0; k0 < S::MB; k0 += kTile) {
          const __nv_bfloat16* pa = sA + g * S::LDA + jb * S::MB + k0 + 2 * q;
          const uint32_t a0 = *reinterpret_cast<const uint32_t*>(pa);
          const uint32_t a1 =
              *reinterpret_cast<const uint32_t*>(pa + 8 * S::LDA);
          const uint32_t a2 = *reinterpret_cast<const uint32_t*>(pa + 8);
          const uint32_t a3 =
              *reinterpret_cast<const uint32_t*>(pa + 8 * S::LDA + 8);
          const uint32_t sg = (__popc(k0 & n0) & 1) ? kNeg : 0u;
          mma_bf16(acc[jb][0], acc[jb][1], acc[jb][2], acc[jb][3], a0, a1,
                   a2, a3, b0 ^ sg, b1 ^ sg ^ f);
        }
      }
    }
    radix_fwht<HS, S::MA>(acc);  // H_{m_a} across the column blocks
#pragma unroll
    for (int jb = 0; jb < S::MA; ++jb) {
      const int col = jb * S::MB + n0 + 2 * q;
      store(g, col, acc[jb][0], acc[jb][1]);
      store(g + 8, col, acc[jb][2], acc[jb][3]);
    }
  }
}

// out (16 rows, row stride M) = bf16 of the H_M stage of the 16 bf16 rows
// in sA.
template <int M, int MB = SlabRows<M>::MB, int HS = kHProducts>
__device__ __forceinline__ void slab_hm(const __nv_bfloat16* sA,
                                        __nv_bfloat16* __restrict__ out) {
  slab_hm_apply<M, MB, HS>(sA, [out](int r, int col, float v0, float v1) {
    *reinterpret_cast<uint32_t*>(out + (size_t)r * M + col) =
        bf16_pair(v0, v1);
  });
}

}  // namespace
