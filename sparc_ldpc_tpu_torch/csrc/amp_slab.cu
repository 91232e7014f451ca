// Whole-trial AMP decode, slab form, for Hopper (sm_90a).
//
// Replaces the TPU kernel sparc_ldpc_tpu/ops/amp_kernel.py::_amp_kernel_slab
// (K7, the route of amp_kernel="fused_slab": in-kernel encode, early stop,
// pinning, SE schedule; no in-kernel noise).  It computes the iteration of
// amp_split.cu (same scale-free scheme, freeze table and pins) with the slab
// kernel's transform and reductions:
//
//   H = H_L (x) H_M,  H_L = H_{f_a} (x) H_{f_b},  H_M = H_{m_a} (x) H_{m_b}
//   f_b = min(128, L), m_b = 128 when 128 divides M > 128, else M
//
// H_M runs first in both transforms, on the data rounded to bf16, and H_L
// on the H_M stage's result rounded to bf16 again: the reference's `_mm`
// (tall column blocks times H_{m_b}) and `_mml` (H_{f_b} times wide row
// slabs).  The two 128-wide factors are products on the tensor cores, as the
// TPU kernel runs them on its matrix unit: mma.sync m16n8k16 with bf16 data
// and float32 accumulation, their +-1 fragments made in registers from the
// parity of popcount(k & n) (as amp_mono.cu does; no factor is loaded).  The
// radix factors H_{m_a} and H_{f_a} are float32 butterflies on the products,
// stride 1 first, the order of the reference's `_fwht_blocks`.  So kernel and
// plain version (ops/amp_kernel.py, fwht_tile_reference(x, "bf16")) round at
// the same places and differ in summation order only.  The kernel computes
// in bf16 only: its factors run on the bf16 tensor cores, and the reference
// kernel has no float32 mode either.
//
// Reductions are the slab kernel's: tau2 from one |z|^2 partial per
// (codeword, slab, 32-column strip), |beta'|^2 from one partial per
// (codeword, slab); a consumer adds each slab's partials, then the slabs in
// slab order.  No float atomics: the same inputs give the same bits.
//
// State: the TPU kernel kept y, z and beta of a codeword in VMEM for all T
// iterations (4 x 2 MiB at L = 1024, M = 512); a Hopper SM has 227 KB of
// shared memory, so here, as in amp_split.cu, the state lives in device
// memory and an iteration is four launches over the batch:
//   C1 column stage (one block per 32-column strip, all L rows; a cluster of
//      L / 1024 blocks above L = 1024): H_L of w = bf16(H_M bf16(beta')),
//      z = y - mask/n * H(beta') + coef * z, the strip's |z|^2 per slab;
//   R2 row stage (one block per 16 rows): bf16(H_M bf16(z)) into the work
//      tile;
//   C2 column stage: H_L of the work tile into u (float32);
//   R3 row stage (one block per slab of f_b rows, 16 rows at a time):
//      u + beta', the max-subtracted softmax, pin, the slab's |beta'|^2, and,
//      unless it is the codeword's last iteration, bf16(H_M bf16(beta'_new))
//      into the work tile for the next C1.
// The column stage's H_{f_b}: within each slab, D = H_{f_b} X, the factor the
// mma's A operand and the strip's bf16 data (from shared memory) its B
// operand; a warp holds one (16-row, 8-column) output tile of every slab of
// the block, so H_{f_a} across the block's slabs is in its registers; above
// L = 1024 the remaining H_{L / 1024} runs across the cluster through
// distributed shared memory (amp_common.cuh cluster_fwht, K1's).  The row
// stage's H_{m_b}: D = X H_{m_b} per column block, the data the A operand;
// a warp holds one 8-column tile of every column block, so H_{m_a} is in its
// registers too.  The encode is amp_split.cu's (float32, the one-hot row's
// H_M in closed form), so codeword power is exact to float32 where the
// reference's two bf16 passes (hi, lo) reach about 2^-16.
//
// What bounds it: device-memory bytes.  Per iteration it moves about 10
// float32-equivalent (B, L, M) passes (C1: read w (bf16), y, z, write z; R2:
// read z, write bf16; C2: read bf16, write u; R3: read u, beta', write
// beta', bf16), against amp_split.cu's 7 and amp_mono.cu's 12: at the
// headline shape (B = 2048, L = 1024, M = 512, T = 22) about 0.94 TB, 282 ms
// at 3.35 TB/s.  The tensor cores do 2 (f_b + m_b) = 512 flops per element
// and transform, about 24 TFLOP there, 24 ms at 989 TFLOP/s.  The function
// itself needs neither: its bound (chip_smoke.py amp_bound, the butterflies'
// log2(L M) float32 adds per element and transform, inputs read and outputs
// written once) is 17.5 ms at that shape.  A simple first kernel:
// mma.sync from shared tiles, no overlap of loads with products.
//
// Built by sparc_ldpc_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// and called through ctypes (plain C interface below).

#include "amp_common.cuh"
#include "amp_mma.cuh"

namespace {

constexpr int kSlabRows = 128;        // f_b at L >= 128
constexpr int kColWarps = 8;          // warps of a column-stage block
constexpr int kColThreads = 32 * kColWarps;

// ---------------------------------------------------------------- columns
//
// A block owns a 32-column strip of FAL slabs of FB rows (LB = FAL FB rows,
// 1024 at most; block c of a cluster of CL owns rows [c LB, (c + 1) LB)).
// Its bf16 tile sits in shared memory, kLdX bf16 a row.  Warp w computes
// the (16-row tile i, 8-column tile j) pairs p = w + 8 s of every slab of the
// block: for the mma m16n8k16 (g = lane / 4, q = lane % 4) the A operand is
// H_{f_b}[16 i + r][16 kk + k] = (-1)^(popc(i & kk) + popc(r & k)): a base
// 16 x 16 fragment, negated as a whole when popc(i & kk) is odd; the B
// operand is X[16 kk + k][8 j + n] of the slab, read as bf16 pairs along k.
// D holds rows 16 i + g and + 8, columns 8 j + 2 q and + 1.

template <int FB, int FAL, int CL, bool RESID>
__global__ void __launch_bounds__(kColThreads, 2)
slab_col_kernel(const __nv_bfloat16* __restrict__ work,
                float* __restrict__ out,          // C2: u (B, L, M)
                const float* __restrict__ y, float* __restrict__ z,
                const float* __restrict__ mask_n,
                float* __restrict__ zpart,        // (B, FA, M / 32)
                const float* __restrict__ bpart,  // (B, FA)
                const float* __restrict__ trace,  // (T, B)
                const int32_t* __restrict__ active,  // (T + 1, B) or null
                int B, int M, int t, float P, float nn) {
  constexpr int LB = FAL * FB, L = CL * LB, FA = CL * FAL;
  constexpr int PPW = (FB / kTile) * (kStrip / 8) / kColWarps;
  static_assert(PPW >= 1, "a warp owns at least one tile pair");
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sx = reinterpret_cast<__nv_bfloat16*>(smem);
  float* sc = reinterpret_cast<float*>(smem + LB * kLdX * sizeof(__nv_bfloat16));
  __shared__ float red[kColWarps][FAL];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int b = blockIdx.y, c = blockIdx.x % CL, strip = blockIdx.x / CL;
  if (active != nullptr && !active[(size_t)t * B + b]) return;  // frozen
  const int m0 = strip * kStrip, row0 = c * LB;
  const size_t base = (size_t)b * L * M;
  // beta' = 0 before the first iteration: no forward transform there
  const bool transform = !RESID || t > 0;
  float coef = 0.f;
  if (RESID && t > 0) {
    float bn = 0.f;
#pragma unroll 1
    for (int a = 0; a < FA; ++a) bn += bpart[(size_t)b * FA + a];
    coef = (P - bn / nn) / trace[(size_t)(t - 1) * B + b];
  }
  if (transform) {
    for (int e = threadIdx.x; e < LB * 4; e += kColThreads) {
      const int r = e >> 2, part = e & 3;
      *reinterpret_cast<uint4*>(sx + r * kLdX + 8 * part) =
          *reinterpret_cast<const uint4*>(work + base + (size_t)(row0 + r) * M
                                          + m0 + 8 * part);
    }
    __syncthreads();
  }
  const uint32_t ha0 = h_pair(g, 2 * q), ha1 = h_pair(g + 8, 2 * q);
  const uint32_t ha2 = h_pair(g, 2 * q + 8), ha3 = h_pair(g + 8, 2 * q + 8);
  float zz[FAL];
#pragma unroll
  for (int a = 0; a < FAL; ++a) zz[a] = 0.f;
#pragma unroll 1
  for (int s = 0; s < PPW; ++s) {
    const int p = warp + kColWarps * s;
    const int i = p >> 2, j = p & 3;
    float acc[FAL][4];
#pragma unroll
    for (int a = 0; a < FAL; ++a)
      acc[a][0] = acc[a][1] = acc[a][2] = acc[a][3] = 0.f;
    if (transform) {
#pragma unroll
      for (int a = 0; a < FAL; ++a) {
#pragma unroll
        for (int kk = 0; kk < FB / kTile; ++kk) {
          const uint32_t sg = (__popc(i & kk) & 1) ? kNeg : 0u;
          const __nv_bfloat16* px =
              sx + (a * FB + kTile * kk + 2 * q) * kLdX + 8 * j + g;
          const uint32_t b0 = bf16_bits(px[0]) | (bf16_bits(px[kLdX]) << 16);
          const uint32_t b1 =
              bf16_bits(px[8 * kLdX]) | (bf16_bits(px[9 * kLdX]) << 16);
          mma_bf16(acc[a][0], acc[a][1], acc[a][2], acc[a][3], ha0 ^ sg,
                   ha1 ^ sg, ha2 ^ sg, ha3 ^ sg, b0, b1);
        }
      }
      tile_fwht<FAL>(acc);  // H_{f_a} across the block's slabs
      // the rest of H_{f_a} across the cluster's blocks (no-op at CL = 1)
      cluster_fwht<CL, FAL * 4>(reinterpret_cast<float(&)[FAL * 4]>(acc), sc,
                                c);
    }
    const int col = m0 + 8 * j + 2 * q;
#pragma unroll
    for (int a = 0; a < FAL; ++a) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int l = row0 + a * FB + kTile * i + g + 8 * h;
        const size_t off = base + (size_t)l * M + col;
        const float w0 = acc[a][2 * h], w1 = acc[a][2 * h + 1];
        if constexpr (RESID) {
          const float2 yv = *reinterpret_cast<const float2*>(y + off);
          const float2 mk =
              *reinterpret_cast<const float2*>(mask_n + (size_t)l * M + col);
          float z0 = yv.x - mk.x * w0, z1 = yv.y - mk.y * w1;
          if (t > 0) {
            const float2 zo = *reinterpret_cast<const float2*>(z + off);
            z0 += coef * zo.x;
            z1 += coef * zo.y;
          }
          *reinterpret_cast<float2*>(z + off) = make_float2(z0, z1);
          zz[a] += z0 * z0 + z1 * z1;
        } else {
          *reinterpret_cast<float2*>(out + off) = make_float2(w0, w1);
        }
      }
    }
  }
  if constexpr (RESID) {
#pragma unroll
    for (int a = 0; a < FAL; ++a) {
      const float v = warp_sum(zz[a]);
      if (lane == 0) red[warp][a] = v;
    }
    __syncthreads();
    if (threadIdx.x < FAL) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kColWarps; ++w) sum += red[w][threadIdx.x];
      zpart[((size_t)b * FA + c * FAL + threadIdx.x) * (M / kStrip) + strip] =
          sum;
    }
  }
}

// ------------------------------------------------------------------- rows
//
// The H_M stage of a row block is amp_mma.cuh's slab_hm.

// R2: out = bf16(H_M bf16(x)) for every row of x (B, L, M), 16 rows per
// block; the blocks of a codeword frozen at iteration t return at once
// (active != null).
template <int M>
__global__ void __launch_bounds__(SlabRows<M>::THREADS)
slab_hm_kernel(const float* __restrict__ x, __nv_bfloat16* __restrict__ out,
               const int32_t* __restrict__ active, int B, int L, int t) {
  using S = SlabRows<M>;
  __shared__ __align__(16) __nv_bfloat16 sA[kTile * S::LDA];
  const int b = blockIdx.y;
  if (active != nullptr && !active[(size_t)t * B + b]) return;
  const size_t base = ((size_t)b * L + (size_t)blockIdx.x * kTile) * M;
  for (int e = threadIdx.x; e < kTile * M / 4; e += S::THREADS) {
    const int r = e / (M / 4), c4 = e % (M / 4);
    const float4 v =
        *reinterpret_cast<const float4*>(x + base + (size_t)r * M + 4 * c4);
    *reinterpret_cast<uint2*>(sA + r * S::LDA + 4 * c4) =
        make_uint2(bf16_pair(v.x, v.y), bf16_pair(v.z, v.w));
  }
  __syncthreads();
  slab_hm<M>(sA, out + base);
}

// R3 of iteration t, one block per (slab, codeword), the slab's fb rows 16
// at a time.  u holds H(z) on entry; work holds bf16(H_M bf16(beta'_new))
// on exit unless this is the codeword's last iteration; beta holds beta'
// and, after the last iteration, the true-scale beta.  One warp per row at a
// time; lane i holds columns i + 32 e.
template <int M>
__global__ void __launch_bounds__(SlabRows<M>::THREADS)
slab_row_kernel(const float* __restrict__ u, float* __restrict__ beta,
                __nv_bfloat16* __restrict__ work,
                const float* __restrict__ zpart,  // (B, FA, M / 32)
                float* __restrict__ bpart,        // (B, FA)
                float* __restrict__ trace,        // (T, B)
                int32_t* __restrict__ iters,      // (B,)
                int32_t* __restrict__ active,     // (T + 1, B)
                const int32_t* __restrict__ pin,  // (B, L) or null
                const float* __restrict__ sched,  // (T,) or null
                const float* __restrict__ sqi, const float* __restrict__ sqo,
                int B, int L, int fb, int t, int last, float n,
                float inv_sqrt_n, float tol) {
  using S = SlabRows<M>;
  constexpr int EPL = M / 32, NS = M / kStrip;
  __shared__ __align__(16) __nv_bfloat16 sA[kTile * S::LDA];
  __shared__ float red[S::NW];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int a = blockIdx.x, b = blockIdx.y, fa = gridDim.x;
  const bool lead = a == 0 && threadIdx.x == 0;
  const float tau2_prev = t > 0 ? trace[(size_t)(t - 1) * B + b] : INFINITY;
  if (!active[(size_t)t * B + b]) {  // frozen: uniform per block
    if (lead) {
      trace[(size_t)t * B + b] = tau2_prev;
      active[(size_t)(t + 1) * B + b] = 0;
    }
    return;
  }
  float tau2;
  if (sched != nullptr) {
    tau2 = sched[t];
  } else {
    // each slab's strips, then the slabs in slab order
    float zz = 0.f;
#pragma unroll 1
    for (int sl = 0; sl < fa; ++sl) {
      float zs = 0.f;
#pragma unroll
      for (int k = 0; k < NS; ++k) zs += zpart[((size_t)b * fa + sl) * NS + k];
      zz += zs;
    }
    tau2 = zz / n;
  }
  const bool conv = fabsf(tau2 - tau2_prev) < tol * tau2;
  const bool fin = last || conv;  // this codeword's last iteration

  float bb = 0.f;
#pragma unroll 1
  for (int tile = 0; tile < fb / kTile; ++tile) {
    const int l0 = a * fb + kTile * tile;
    const size_t base = ((size_t)b * L + l0) * M;
    for (int r = warp; r < kTile; r += S::NW) {
      const int l = l0 + r;
      const size_t off = base + (size_t)r * M + lane;
      float v[EPL];
#pragma unroll
      for (int e = 0; e < EPL; ++e) v[e] = u[off + 32 * e];
      if (t > 0) {
#pragma unroll
        for (int e = 0; e < EPL; ++e) v[e] += beta[off + 32 * e];
      }
      const float ai = sqi[l] / tau2;
      float mx = -INFINITY;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        v[e] = ai * v[e];
        mx = fmaxf(mx, v[e]);
      }
      mx = warp_max(mx);
      float se = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        v[e] = expf(v[e] - mx);
        se += v[e];
      }
      se = warp_sum(se);
      const float so = sqo[l] / se;
#pragma unroll
      for (int e = 0; e < EPL; ++e) v[e] = so * v[e];
      if (pin != nullptr) {
        const int p = pin[(size_t)b * L + l];
        if (p >= 0) {
#pragma unroll
          for (int e = 0; e < EPL; ++e) v[e] = (lane + 32 * e == p) ? sqo[l] : 0.f;
        }
      }
      if (fin) {
#pragma unroll
        for (int e = 0; e < EPL; ++e) beta[off + 32 * e] = v[e] * inv_sqrt_n;
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          beta[off + 32 * e] = v[e];
          bb += v[e] * v[e];
          sA[r * S::LDA + lane + 32 * e] = __float2bfloat16_rn(v[e]);
        }
      }
    }
    if (!fin) {  // uniform per block
      __syncthreads();
      slab_hm<M>(sA, work + base);
      __syncthreads();  // sA is refilled by the next tile
    }
  }
  if (!fin) {
    const float sum = block_sum<S::NW>(bb, red);
    if (threadIdx.x == 0) bpart[(size_t)b * fa + a] = sum;
  }
  if (lead) {
    trace[(size_t)t * B + b] = tau2;
    active[(size_t)(t + 1) * B + b] = fin ? 0 : 1;
    if (fin) iters[b] = t + 1;
  }
}

// ------------------------------------------------------------- launchers

template <int FB, int FAL, int CL>
struct SlabCols {
  static constexpr int LB = FAL * FB;
  template <bool RESID>
  static int step(const __nv_bfloat16* work, float* out, const float* y,
                  float* z, const float* mask_n, float* zpart,
                  const float* bpart, const float* trace,
                  const int32_t* active, int B, int M, int t, float P,
                  float nn, cudaStream_t st) {
    auto kernel = slab_col_kernel<FB, FAL, CL, RESID>;
    const int bytes = LB * kLdX * (int)sizeof(__nv_bfloat16)
                      + (CL > 1 ? FAL * 4 * kColThreads * (int)sizeof(float)
                                : 0);
    int rc = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (rc) return rc;
    const dim3 grid(CL * (M / kStrip), B);
    if constexpr (CL == 1) {
      kernel<<<grid, kColThreads, bytes, st>>>(work, out, y, z, mask_n, zpart,
                                               bpart, trace, active, B, M, t,
                                               P, nn);
    } else {
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = grid;
      cfg.blockDim = dim3(kColThreads);
      cfg.dynamicSmemBytes = bytes;
      cfg.stream = st;
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = CL;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      rc = (int)cudaLaunchKernelEx(&cfg, kernel, work, out, y, z, mask_n,
                                   zpart, bpart, trace, active, B, M, t, P,
                                   nn);
      if (rc) return rc;
    }
    return (int)cudaGetLastError();
  }
};

// Returns CALL with K = SlabCols<f_b, slabs a block, cluster size> for the
// supported L.
#define DISPATCH_SLAB_L(L, CALL)                                   \
  switch (L) {                                                     \
    case 32: { using K = SlabCols<32, 1, 1>; return CALL; }        \
    case 64: { using K = SlabCols<64, 1, 1>; return CALL; }        \
    case 128: { using K = SlabCols<128, 1, 1>; return CALL; }      \
    case 256: { using K = SlabCols<128, 2, 1>; return CALL; }      \
    case 512: { using K = SlabCols<128, 4, 1>; return CALL; }      \
    case 1024: { using K = SlabCols<128, 8, 1>; return CALL; }     \
    case 2048: { using K = SlabCols<128, 8, 2>; return CALL; }     \
    case 4096: { using K = SlabCols<128, 8, 4>; return CALL; }     \
    default: return kBadShape;                                     \
  }

template <int M>
struct SlabRowLaunch {
  static constexpr int NT = SlabRows<M>::THREADS;
  static int hm(const float* x, __nv_bfloat16* out, const int32_t* active,
                int B, int L, int t, cudaStream_t st) {
    slab_hm_kernel<M><<<dim3(L / kTile, B), NT, 0, st>>>(x, out, active, B,
                                                         L, t);
    return (int)cudaGetLastError();
  }
  static int row(const float* u, float* beta, __nv_bfloat16* work,
                 const float* zpart, float* bpart, float* trace,
                 int32_t* iters, int32_t* active, const int32_t* pin,
                 const float* sched, const float* sqi, const float* sqo,
                 int B, int L, int fb, int t, int last, float n,
                 float inv_sqrt_n, float tol, cudaStream_t st) {
    slab_row_kernel<M><<<dim3(L / fb, B), NT, 0, st>>>(
        u, beta, work, zpart, bpart, trace, iters, active, pin, sched, sqi,
        sqo, B, L, fb, t, last, n, inv_sqrt_n, tol);
    return (int)cudaGetLastError();
  }
};

#define DISPATCH_SLAB_M(M, CALL)                              \
  switch (M) {                                                \
    case 32: { using Q = SlabRowLaunch<32>; return CALL; }    \
    case 64: { using Q = SlabRowLaunch<64>; return CALL; }    \
    case 128: { using Q = SlabRowLaunch<128>; return CALL; }  \
    case 256: { using Q = SlabRowLaunch<256>; return CALL; }  \
    case 512: { using Q = SlabRowLaunch<512>; return CALL; }  \
    case 1024: { using Q = SlabRowLaunch<1024>; return CALL; } \
    default: return kBadShape;                                \
  }

int encode(const float* y_n, const float* mask_n, const float* sqo,
           const int32_t* enc_idx, float* y, int B, int L, int M,
           cudaStream_t st) {
  DISPATCH_L(L, C::encode(y_n, mask_n, sqo, enc_idx, nullptr, 0.f, y, B, M,
                          st))
}

template <bool RESID>
int col_step(const __nv_bfloat16* work, float* out, const float* y, float* z,
             const float* mask_n, float* zpart, const float* bpart,
             const float* trace, const int32_t* active, int B, int L, int M,
             int t, float P, float nn, cudaStream_t st) {
  DISPATCH_SLAB_L(L, (K::template step<RESID>(work, out, y, z, mask_n, zpart,
                                                bpart, trace, active, B, M, t,
                                                P, nn, st)))
}

int rows_hm(const float* x, __nv_bfloat16* out, const int32_t* active, int B,
            int L, int M, int t, cudaStream_t st) {
  DISPATCH_SLAB_M(M, Q::hm(x, out, active, B, L, t, st))
}

int rows_softmax(const float* u, float* beta, __nv_bfloat16* work,
                 const float* zpart, float* bpart, float* trace,
                 int32_t* iters, int32_t* active, const int32_t* pin,
                 const float* sched, const float* sqi, const float* sqo,
                 int B, int L, int M, int t, int last, float n,
                 float inv_sqrt_n, float tol, cudaStream_t st) {
  const int fb = L < kSlabRows ? L : kSlabRows;
  DISPATCH_SLAB_M(M, Q::row(u, beta, work, zpart, bpart, trace, iters,
                            active, pin, sched, sqi, sqo, B, L, fb, t, last,
                            n, inv_sqrt_n, tol, st))
}

// L up to 4096, the reference's gate for the fused route; M up to 1024.
bool supported(int B, int L, int M) {
  return B >= 1 && B <= 65535 && pow2_in(L, 32, 4096) && pow2_in(M, 32, 1024);
}

}  // namespace

extern "C" {

// Whole-trial AMP of the slab form for B codewords.  Inputs: y_n (B, L, M)
// the channel noise (enc_idx given) or the whole observation (enc_idx
// null), embedded on the row support; mask_n (L, M) = mask / n; sqi, sqo
// (L,); enc_idx (B, L) int32 or null; pin (B, L) int32 (-1 = unpinned) or
// null; sched (T,) SE tau2 schedule or null; tol the early-stop threshold
// (0 = fixed T).  Outputs: beta (B, L, M) true scale, trace (T, B), iters
// (B,) int32.  active (T + 1, B) int32 holds the freeze flags and must
// arrive with row 0 all ones.  Scratch: y, z, u (B, L, M) float; work
// (B, L, M) bfloat16; zpart (B, f_a M / 32); bpart (B, f_a), f_a =
// L / min(128, L).  L, M powers of two, L in [32, 4096], M in [32, 1024].
// Returns 0, a cudaError_t, or -1 for an unsupported shape.
int amp_slab_run(const float* y_n, const float* mask_n, const float* sqi,
                 const float* sqo, const int32_t* enc_idx, const int32_t* pin,
                 const float* sched, float* beta, float* trace,
                 int32_t* iters, int32_t* active, float* y, float* z,
                 float* u, void* work_v, float* zpart, float* bpart, int B,
                 int L, int M, int T, float P, float n, float inv_sqrt_n,
                 float tol, void* stream) {
  if (!supported(B, L, M) || T < 1 || y_n == nullptr) return kBadShape;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* work = static_cast<__nv_bfloat16*>(work_v);
  int rc = encode(y_n, mask_n, sqo, enc_idx, y, B, L, M, st);
  if (rc) return rc;
  const float nn = n * n;
  for (int t = 0; t < T; ++t) {
    rc = col_step<true>(work, nullptr, y, z, mask_n, zpart, bpart, trace,
                        active, B, L, M, t, P, nn, st);
    if (rc) return rc;
    rc = rows_hm(z, work, active, B, L, M, t, st);
    if (rc) return rc;
    rc = col_step<false>(work, u, nullptr, nullptr, nullptr, nullptr,
                         nullptr, nullptr, active, B, L, M, t, 0.f, 0.f, st);
    if (rc) return rc;
    rc = rows_softmax(u, beta, work, zpart, bpart, trace, iters, active, pin,
                      sched, sqi, sqo, B, L, M, t, t == T - 1, n, inv_sqrt_n,
                      tol, st);
    if (rc) return rc;
  }
  return 0;
}

// The slab form's transform of each (L, M) tile of x (B, L, M) into out:
// H_L bf16(H_M bf16(x)), both 128-wide factors on the tensor cores; work
// (B, L, M) bfloat16 scratch holds the H_M stage.
int amp_slab_tile(const float* x, void* work_v, float* out, int B, int L,
                  int M, void* stream) {
  if (!supported(B, L, M)) return kBadShape;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* work = static_cast<__nv_bfloat16*>(work_v);
  int rc = rows_hm(x, work, nullptr, B, L, M, 0, st);
  if (rc) return rc;
  return col_step<false>(work, out, nullptr, nullptr, nullptr, nullptr,
                         nullptr, nullptr, nullptr, B, L, M, 0, 0.f, 0.f, st);
}

const char* amp_slab_error_string(int code) {
  if (code == kBadShape) return "unsupported shape";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
