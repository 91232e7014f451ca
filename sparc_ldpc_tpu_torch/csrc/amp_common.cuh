// Device code shared by the whole-trial AMP kernels, amp_split.cu (the
// split form, K1, and K3, K5), amp_mono.cu (the monolithic form, K6) and
// amp_slab.cu (K7): the column code (H_L down 32-column strips of the
// (L, M) section tile in registers and shared memory), the standalone H_L
// of strips, the dense in-kernel encode with its Philox4x32-10 channel
// noise, and their launchers.  See amp_split.cu for the algorithm and the
// state layout.
//
// Column stage, L <= 1024: a block owns an (L, 32) strip, L = W * R, with
// 32 * W threads.  Thread (w = warp, c = lane) holds R values of column c:
//   layout A: rows w + W * k   (k, the register index, holds the high
//                               log2(R) bits of the row)
//   layout B: rows R * w + k   (k holds the low log2(R) bits)
// H_L is the butterflies over all bits of k in layout A, a transpose
// through shared memory, and the butterflies over the low log2(W) bits of
// k in layout B.  W <= R, so every row bit is transformed exactly once.
// Shared-memory rows are 32 floats wide: a warp touches one row, one bank
// per lane.
//
// Column stage, L = 2048 and 4096 (FA = L / 1024 in {2, 4}): an (L, 32)
// strip is 256 or 512 KB of float32, more than a block's 227 KB of shared
// memory, and R = L / W = 64 or 128 values per thread exceed the 64
// registers a thread of a 1024-thread block has.  So H_L = H_FA (x) H_1024
// is split over a thread-block cluster of FA blocks, block a of which owns
// rows [1024 a, 1024 (a + 1)) of the strip: each runs the L = 1024 column
// code (H_1024) on its rows, then the FA blocks exchange the strip through
// distributed shared memory and block a adds up sign(a, a') * x_a' over the
// cluster (H_FA across rows l, l + 1024, ...), in the fixed order a' = 0 ..
// FA - 1.  One launch, no extra device-memory pass, the same per-element
// arithmetic as at L = 1024; the price is two cluster barriers and
// (FA - 1) remote shared-memory reads per value and transform.  Chosen over
// a two-launch H_FA pass through device memory, which would add two
// (B, L, M) float32 passes per transform.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <utility>

namespace {

constexpr int kStrip = 32;         // columns per column-stage block
constexpr int kBlockRows = 1024;   // strip rows one column-stage block owns
constexpr int kBadShape = -1;      // return code for an unsupported shape

__device__ __forceinline__ float maybe_round(float x, int round_bf16) {
  return round_bf16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

// Storage type of a work tile: float, or bfloat16 when the transforms round
// their operands to bf16 (then rounding when it is stored gives the same
// values and moves half the bytes).
template <typename WT>
struct IsBf16 {
  static constexpr int value = 0;
};
template <>
struct IsBf16<__nv_bfloat16> {
  static constexpr int value = 1;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename WT>
__device__ __forceinline__ WT from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Butterflies over the register index bits with stride < H: the Hadamard
// factor H_H acting on the low log2(H) bits of the index into v.
template <int R, int H>
__device__ __forceinline__ void reg_fwht(float (&v)[R]) {
#pragma unroll
  for (int h = 1; h < H; h <<= 1) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if ((i & h) == 0) {
        const float a = v[i], b = v[i + h];
        v[i] = a + b;
        v[i + h] = a - b;
      }
    }
  }
}

__device__ __forceinline__ float warp_sum(float x) {
  // xor tree: partners add the same two values, so every lane ends with the
  // same bits
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, m));
  return x;
}

// Sum over a block of NW warps in a fixed order; every thread gets it.
template <int NW>
__device__ __forceinline__ float block_sum(float x, float* red) {
  x = warp_sum(x);
  __syncthreads();  // earlier readers of red are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NW; ++i) s += red[i];
  return s;
}

// ---------------------------------------------------------------- columns

template <int W, int R>
__device__ __forceinline__ void a_to_b(float (&v)[R], float* sm, int w,
                                       int c) {
  __syncthreads();
#pragma unroll
  for (int k = 0; k < R; ++k) sm[(w + W * k) * kStrip + c] = v[k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < R; ++k) v[k] = sm[(R * w + k) * kStrip + c];
}

template <int W, int R>
__device__ __forceinline__ void b_to_a(float (&v)[R], float* sm, int w,
                                       int c) {
  __syncthreads();
#pragma unroll
  for (int k = 0; k < R; ++k) sm[(R * w + k) * kStrip + c] = v[k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < R; ++k) v[k] = sm[(w + W * k) * kStrip + c];
}

// H_FA across the FA blocks of a cluster (block a holds rows 1024 a + the
// same local rows in the same layout): v[k] = sum_a' (-1)^popc(a & a') x_a'[k]
// in the order a' = 0 .. FA - 1.  No-op for FA = 1.
template <int FA, int R>
__device__ __forceinline__ void cluster_fwht(float (&v)[R], float* sm, int a) {
  if constexpr (FA > 1) {
    namespace cg = cooperative_groups;
    cg::cluster_group cl = cg::this_cluster();
    const int nt = blockDim.x;
    cl.sync();  // every block of the cluster is done with its sm
#pragma unroll
    for (int k = 0; k < R; ++k) sm[k * nt + threadIdx.x] = v[k];
    cl.sync();
#pragma unroll
    for (int k = 0; k < R; ++k) {
      float s = 0.f;
#pragma unroll
      for (int a2 = 0; a2 < FA; ++a2) {
        const float x =
            a2 == a ? v[k] : cl.map_shared_rank(sm, a2)[k * nt + threadIdx.x];
        s = (__popc(a & a2) & 1) ? s - x : s + x;
      }
      v[k] = s;
    }
    cl.sync();  // the remote reads are done before any sm is reused
  }
}

// H_L on a strip held in layout A; the result is in layout B.
template <int W, int R, int FA>
__device__ __forceinline__ void col_fwht_ab(float (&v)[R], float* sm, int w,
                                            int c, int a) {
  reg_fwht<R, R>(v);
  a_to_b<W, R>(v, sm, w, c);
  reg_fwht<R, W>(v);
  cluster_fwht<FA, R>(v, sm, a);
}

// H_L on a strip held in layout B; the result is in layout A.
template <int W, int R, int FA>
__device__ __forceinline__ void col_fwht_ba(float (&v)[R], float* sm, int w,
                                            int c, int a) {
  reg_fwht<R, W>(v);
  b_to_a<W, R>(v, sm, w, c);
  reg_fwht<R, R>(v);
  cluster_fwht<FA, R>(v, sm, a);
}

// ------------------------------------------------------------------ noise

// Philox4x32-10: ten rounds, the key bumped between rounds.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// The reference's 24-bit uniforms (ops/amp_kernel.py boxmuller_pair_f32):
// u1 in (0, 1), floored at 2^-25 so the log never sees 0, and the angle.
// Explicit roundings keep nvcc from contracting them into an FMA.
__device__ __forceinline__ float bm_u1(uint32_t bits) {
  return __fadd_rn(__fmul_rn((float)(bits >> 8), 0x1p-24f), 0x1p-25f);
}
__device__ __forceinline__ float bm_theta(uint32_t bits) {
  return __fmul_rn(__fmul_rn(6.28318548f, (float)(bits >> 8)), 0x1p-24f);
}

// The four standard normals of rows 4q .. 4q + 3 in column m (layout in
// amp_split.cu).
__device__ __forceinline__ void normal4(uint2 key, int m, int q, float (&e)[4]) {
  const uint4 x = philox4x32_10(make_uint4((uint32_t)m, (uint32_t)q, 0u, 0u),
                                key);
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const float r = sqrtf(-2.f * logf(bm_u1(w[2 * p])));
    float s, c;
    sincosf(bm_theta(w[2 * p + 1]), &s, &c);
    e[2 * p] = r * c;
    e[2 * p + 1] = r * s;
  }
}

// In-kernel encode: y = where(mask > 0, noise, 0) + mask/n * H(sqo one_hot).
// The one-hot row's H_M is closed-form, (e_idx H_M)[m] = (-1)^popc(idx & m),
// exact in float32; H_L then runs in float32.  enc_idx == nullptr only
// applies the mask.  The noise is y_n, or with seeds != nullptr sigma times
// the Philox normals (y_n is then not read).  Grid (FA * M / 32, B), block a
// = blockIdx.x % FA of a cluster owns rows [1024 a, 1024 (a + 1)).
template <int W, int R, int FA>
__global__ void __launch_bounds__(32 * W, 1)
amp_encode_kernel(const float* __restrict__ y_n,
                  const float* __restrict__ mask_n,
                  const float* __restrict__ sqo,
                  const int32_t* __restrict__ enc_idx,
                  const uint32_t* __restrict__ seeds, float sigma,
                  float* __restrict__ y, int M) {
  extern __shared__ float sm[];
  constexpr int L = FA * W * R;
  static_assert(R % 4 == 0, "a Philox block feeds four rows of a thread");
  const int w = threadIdx.x >> 5, c = threadIdx.x & 31;
  const int b = blockIdx.y, a = blockIdx.x % FA;
  const int m = (blockIdx.x / FA) * kStrip + c;
  const int l0 = a * W * R;  // this block's first row
  const size_t base = (size_t)b * L * M;
  float v[R];
  if (enc_idx != nullptr) {
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int l = l0 + w + W * k;
      const float s = sqo[l];
      v[k] = (__popc(enc_idx[(size_t)b * L + l] & m) & 1) ? -s : s;
    }
    col_fwht_ab<W, R, FA>(v, sm, w, c, a);
  } else {
#pragma unroll
    for (int k = 0; k < R; ++k) v[k] = 0.f;
  }
  uint2 key = make_uint2(0u, 0u);
  if (seeds != nullptr) key = make_uint2(seeds[2 * b], seeds[2 * b + 1]);
#pragma unroll
  for (int g = 0; g < R / 4; ++g) {
    float e[4];
    if (seeds != nullptr) normal4(key, m, (l0 + R * w) / 4 + g, e);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = 4 * g + i;
      const int l = l0 + R * w + k;
      const size_t off = base + (size_t)l * M + m;
      const float mk = mask_n[(size_t)l * M + m];
      const float noise =
          mk > 0.f ? (seeds != nullptr ? __fmul_rn(sigma, e[i]) : y_n[off])
                   : 0.f;
      y[off] = noise + mk * v[k];
    }
  }
}

// Standalone H_L of every strip of x (B, L, M), in place, the data rounded
// to bf16 first when round_bf16 is set and the result multiplied by scale
// as it is stored (scale = 1 stores it as it is: x * 1 is exact).
template <int W, int R, int FA>
__global__ void __launch_bounds__(32 * W, 1)
fwht_cols_kernel(float* __restrict__ x, int M, int round_bf16, float scale) {
  extern __shared__ float sm[];
  constexpr int L = FA * W * R;
  const int w = threadIdx.x >> 5, c = threadIdx.x & 31;
  const int b = blockIdx.y, a = blockIdx.x % FA;
  const int m = (blockIdx.x / FA) * kStrip + c;
  const int l0 = a * W * R;
  const size_t base = (size_t)b * L * M;
  float v[R];
#pragma unroll
  for (int k = 0; k < R; ++k)
    v[k] = maybe_round(x[base + (size_t)(l0 + w + W * k) * M + m], round_bf16);
  col_fwht_ab<W, R, FA>(v, sm, w, c, a);
#pragma unroll
  for (int k = 0; k < R; ++k)
    x[base + (size_t)(l0 + R * w + k) * M + m] = v[k] * scale;
}

// ------------------------------------------------------------- launchers

// Launch kernel on a (FA * M / 32, B) grid of 32 * W threads with the
// strip's shared memory: a plain launch at FA = 1, in clusters of FA blocks
// along x above.
template <int W, int R, int FA, typename... Exp, typename... Act>
int launch_cols(void (*kernel)(Exp...), int B, int M, cudaStream_t st,
                Act&&... args) {
  const int bytes = W * R * kStrip * (int)sizeof(float);
  int rc = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc) return rc;
  if constexpr (FA == 1) {
    kernel<<<dim3(M / kStrip, B), 32 * W, bytes, st>>>(
        std::forward<Act>(args)...);
  } else {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(FA * (M / kStrip), B);
    cfg.blockDim = dim3(32 * W);
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = FA;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    rc = (int)cudaLaunchKernelEx(&cfg, kernel, std::forward<Act>(args)...);
    if (rc) return rc;
  }
  return (int)cudaGetLastError();
}

template <int W, int R, int FA>
struct Cols {
  static int encode(const float* y_n, const float* mask_n, const float* sqo,
                    const int32_t* enc_idx, const uint32_t* seeds,
                    float sigma, float* y, int B, int M, cudaStream_t st) {
    return launch_cols<W, R, FA>(amp_encode_kernel<W, R, FA>, B, M, st, y_n,
                                 mask_n, sqo, enc_idx, seeds, sigma, y, M);
  }
  static int fwht(float* x, int B, int M, int round_bf16, float scale,
                  cudaStream_t st) {
    return launch_cols<W, R, FA>(fwht_cols_kernel<W, R, FA>, B, M, st, x, M,
                                 round_bf16, scale);
  }
};

inline bool pow2_in(int x, int lo, int hi) {
  return x >= lo && x <= hi && (x & (x - 1)) == 0;
}

// Returns CALL with C = Cols<W, R, FA> for the supported L = FA * W * R
// (W <= R, W * R <= 1024): DISPATCH_L1024 up to L = 1024 (the mono form),
// DISPATCH_L up to 4096.
#define CASES_L1024(CALL)                                \
  case 32: { using C = Cols<4, 8, 1>; return CALL; }     \
  case 64: { using C = Cols<8, 8, 1>; return CALL; }     \
  case 128: { using C = Cols<8, 16, 1>; return CALL; }   \
  case 256: { using C = Cols<16, 16, 1>; return CALL; }  \
  case 512: { using C = Cols<16, 32, 1>; return CALL; }  \
  case 1024: { using C = Cols<32, 32, 1>; return CALL; }

#define DISPATCH_L1024(L, CALL) \
  switch (L) {                  \
    CASES_L1024(CALL)           \
    default: return kBadShape;  \
  }

#define DISPATCH_L(L, CALL)                                \
  switch (L) {                                             \
    CASES_L1024(CALL)                                      \
    case 2048: { using C = Cols<32, 32, 2>; return CALL; } \
    case 4096: { using C = Cols<32, 32, 4>; return CALL; } \
    default: return kBadShape;                             \
  }

}  // namespace
