// Whole-trial AMP decode, monolithic form, for Hopper (sm_90a).
//
// Replaces the TPU kernel sparc_ldpc_tpu/ops/amp_kernel.py::_amp_kernel (K6,
// the route of amp_kernel="fused" at L <= 1024: in-kernel encode, early
// stop, pinning, SE schedule; no in-kernel noise).  It runs the iteration
// of amp_split.cu (same state, scale-free scheme, freeze table, partials and
// pins) with the transform of the monolithic kernel:
//
//   T(x) = H_L (bf16(x) H_M)
//
// The reference computes both factors as dense matrix products with bf16
// Hadamard matrices: bf16(x) @ H_M rounds the data to bf16 and accumulates
// in float32, and H_L @ (that) takes the float32 intermediate as it is (its
// first operand, H_L, is the one cast to bf16).  So each transform rounds
// its data once, before H_M, and applies H_L in float32 -- unlike the split
// form, which rounds before both stages.  Here:
//   H_M: the dense product on the tensor cores, mma.sync m16n8k16 with bf16
//     data and float32 accumulation, the reference's own arithmetic for that
//     stage (+-1 is exact in bf16).  The H_M fragments are made in registers
//     from the parity of popcount(k & n) (two base fragments and a sign per
//     (k, n) tile), so no factor is loaded;
//   H_L: float32 butterflies on the CUDA cores, the split form's column stage
//     with no rounding (amp_common.cuh), which computes H_L @ x up to
//     summation order.
// Because H_M must see bf16 data and comes first in both transforms, an
// iteration is four launches (the split form's is two):
//   column (C1): H_L of w = bf16(beta') H_M, the residual and Onsager term,
//     z, the strip's |z|^2;
//   rows (R2): bf16(z) H_M on the tensor cores into the work tile;
//   column (C2): H_L of the work tile, in place;
//   rows (R3): + beta', the max-subtracted softmax, pin, |beta'|^2, and,
//     unless it is the codeword's last iteration, bf16(beta'_new) H_M on the
//     tensor cores into the work tile for the next C1.
// The encode is the split form's (float32, the one-hot row's H_M in closed
// form), so the codeword's power is exact to float32 where the reference's
// two-pass hi/lo bf16 encode reaches about 2^-16.
//
// What bounds it: device-memory bytes and the tensor cores.  Per iteration
// it moves about 12 float32 (B, L, M) passes (C1: read w, y, z, write z;
// R2: read z, write v; C2: read and write v; R3: read u, beta', write
// beta', w), against the split form's 7, and the dense H_M costs 2 M flops
// per element and transform: at the headline shapes (B = 2048, L = 1024,
// M = 512, T = 22) about 48 TFLOP, 49 ms at the H100's 989 TFLOP/s bf16
// peak, beside about 1.1 TB of traffic, 340 ms at 3.35 TB/s.  A simple first
// kernel: mma.sync from a padded shared tile, one 16-row tile per block, no
// overlap of loads with products.
//
// Determinism: no float atomics; the same fixed-order partial sums as the
// split form, and each mma accumulates its k-steps in a fixed order.
//
// Built by sparc_ldpc_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// and called through ctypes (plain C interface below).

#include "amp_common.cuh"

namespace {

constexpr int kTileRows = 16;  // rows of one mma tile, and of a row block

// Warps of a row block: one per 64 columns (8 n-tiles of 8 columns each).
template <int M>
struct RowShape {
  static constexpr int NW = M >= 64 ? M / 64 : 1;
  static constexpr int LDA = M + 8;  // padded bf16 row stride: no bank conflicts
};

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// bf16 bits of H[k][n] = (-1)^popc(k & n).
__device__ __forceinline__ uint32_t h_bits(int k, int n) {
  return (__popc(k & n) & 1) ? 0xBF80u : 0x3F80u;
}

// out[r][n] = sum_k A[r][k] H_M[k][n] for the 16 rows of the bf16 tile sA
// (row stride LDA), float32, into out (row stride M).
//
// For the tile of k-step k0 = 16 i and columns n0 = 8 j, H_M[k0 + k][n0 + n]
// (k < 16, n < 8) has parity popc(k0 & n0) + bit3(k) bit3(n0) + popc(k & n),
// the three bit sets being disjoint: a base 16 x 8 fragment, negated in its
// k >= 8 half when bit 3 of n0 is set, and as a whole when popc(k0 & n0) is
// odd (xor with the two bf16 sign bits).
//
// Fragments of mma.m16n8k16 (g = lane / 4, q = lane % 4): A holds
// A[g][2q..2q+1], A[g+8][2q..], A[g][2q+8..], A[g+8][2q+8..]; B holds
// B[2q..2q+1][g], B[2q+8..2q+9][g]; D holds D[g][2q..2q+1], D[g+8][2q..].
template <int M>
__device__ __forceinline__ void hm_mma(const __nv_bfloat16* sA,
                                       float* __restrict__ out) {
  constexpr int NW = RowShape<M>::NW, LDA = RowShape<M>::LDA;
  constexpr int NTW = M / 8 / NW;  // n-tiles per warp
  constexpr uint32_t kNeg = 0x80008000u;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const uint32_t b0 = h_bits(2 * q, g) | (h_bits(2 * q + 1, g) << 16);
  const uint32_t b1 = h_bits(2 * q + 8, g) | (h_bits(2 * q + 9, g) << 16);
  const int nb = warp * NTW * 8;
  float acc[NTW][4];
#pragma unroll
  for (int j = 0; j < NTW; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  for (int k0 = 0; k0 < M; k0 += 16) {
    const __nv_bfloat16* pa = sA + g * LDA + k0 + 2 * q;
    const uint32_t a0 = *reinterpret_cast<const uint32_t*>(pa);
    const uint32_t a1 = *reinterpret_cast<const uint32_t*>(pa + 8 * LDA);
    const uint32_t a2 = *reinterpret_cast<const uint32_t*>(pa + 8);
    const uint32_t a3 = *reinterpret_cast<const uint32_t*>(pa + 8 * LDA + 8);
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      const int n0 = nb + 8 * j;
      const uint32_t s = (__popc(k0 & n0) & 1) ? kNeg : 0u;
      const uint32_t f = (n0 & 8) ? kNeg : 0u;
      mma_bf16(acc[j], a0, a1, a2, a3, b0 ^ s, b1 ^ s ^ f);
    }
  }
#pragma unroll
  for (int j = 0; j < NTW; ++j) {
    const int col = nb + 8 * j + 2 * q;
    *reinterpret_cast<float2*>(out + (size_t)g * M + col) =
        make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(out + (size_t)(g + 8) * M + col) =
        make_float2(acc[j][2], acc[j][3]);
  }
}

// R2: out = bf16(x) H_M for every row of x (B, L, M), 16 rows per block.
// With active != nullptr the blocks of a codeword frozen at iteration t
// return at once.
template <int M>
__global__ void __launch_bounds__(32 * RowShape<M>::NW)
mono_hm_kernel(const float* __restrict__ x, float* __restrict__ out,
               const int32_t* __restrict__ active, int B, int L, int t) {
  constexpr int NT = 32 * RowShape<M>::NW, LDA = RowShape<M>::LDA;
  __shared__ __align__(16) __nv_bfloat16 sA[kTileRows * LDA];
  const int b = blockIdx.y;
  if (active != nullptr && !active[(size_t)t * B + b]) return;
  const size_t base = ((size_t)b * L + (size_t)blockIdx.x * kTileRows) * M;
  for (int e = threadIdx.x; e < kTileRows * M; e += NT)
    sA[(e / M) * LDA + e % M] = __float2bfloat16_rn(x[base + e]);
  __syncthreads();
  hm_mma<M>(sA, out + base);
}

// R3 of iteration t.  work holds H_L (bf16(z) H_M) on entry and, unless this
// is the codeword's last iteration, bf16(beta'_new) H_M on exit.  beta
// holds beta' and, after the codeword's last iteration, the true-scale beta.
// One warp per row at a time; lane i holds columns i + 32 j.
template <int M>
__global__ void __launch_bounds__(32 * RowShape<M>::NW)
mono_row_kernel(float* __restrict__ work, float* __restrict__ beta,
                const float* __restrict__ zpart,  // (B, M / 32)
                float* __restrict__ bpart,        // (B, L)
                float* __restrict__ trace,        // (T, B)
                int32_t* __restrict__ iters,      // (B,)
                int32_t* __restrict__ active,     // (T + 1, B)
                const int32_t* __restrict__ pin,  // (B, L) or null
                const float* __restrict__ sched,  // (T,) or null
                const float* __restrict__ sqi, const float* __restrict__ sqo,
                int B, int L, int t, int last, float n,
                float inv_sqrt_n, float tol) {
  constexpr int NS = M / kStrip;  // |z|^2 partials (one block per strip)
  constexpr int NW = RowShape<M>::NW, LDA = RowShape<M>::LDA, EPL = M / 32;
  __shared__ __align__(16) __nv_bfloat16 sA[kTileRows * LDA];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const bool lead = blockIdx.x == 0 && threadIdx.x == 0;
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
    float zz = 0.f;
#pragma unroll
    for (int s = 0; s < NS; ++s) zz += zpart[(size_t)b * NS + s];
    tau2 = zz / n;
  }
  const bool conv = fabsf(tau2 - tau2_prev) < tol * tau2;
  const bool fin = last || conv;  // this codeword's last iteration
  const size_t base = ((size_t)b * L + (size_t)blockIdx.x * kTileRows) * M;

  for (int r = warp; r < kTileRows; r += NW) {
    const int l = blockIdx.x * kTileRows + r;
    const size_t off = base + (size_t)r * M + lane;
    float v[EPL];
#pragma unroll
    for (int i = 0; i < EPL; ++i) v[i] = work[off + 32 * i];
    if (t > 0) {
#pragma unroll
      for (int i = 0; i < EPL; ++i) v[i] += beta[off + 32 * i];
    }
    const float ai = sqi[l] / tau2;
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < EPL; ++i) {
      v[i] = ai * v[i];
      mx = fmaxf(mx, v[i]);
    }
    mx = warp_max(mx);
    float se = 0.f;
#pragma unroll
    for (int i = 0; i < EPL; ++i) {
      v[i] = expf(v[i] - mx);
      se += v[i];
    }
    se = warp_sum(se);
    const float so = sqo[l] / se;
#pragma unroll
    for (int i = 0; i < EPL; ++i) v[i] = so * v[i];
    if (pin != nullptr) {
      const int p = pin[(size_t)b * L + l];
      if (p >= 0) {
#pragma unroll
        for (int i = 0; i < EPL; ++i) v[i] = (lane + 32 * i == p) ? sqo[l] : 0.f;
      }
    }
    if (fin) {
#pragma unroll
      for (int i = 0; i < EPL; ++i) beta[off + 32 * i] = v[i] * inv_sqrt_n;
    } else {
      float bb = 0.f;
#pragma unroll
      for (int i = 0; i < EPL; ++i) {
        beta[off + 32 * i] = v[i];
        bb += v[i] * v[i];
        sA[r * LDA + lane + 32 * i] = __float2bfloat16_rn(v[i]);
      }
      bb = warp_sum(bb);
      if (lane == 0) bpart[(size_t)b * L + l] = bb;
    }
  }
  if (!fin) {  // uniform per block
    __syncthreads();
    hm_mma<M>(sA, work + base);
  }
  if (lead) {
    trace[(size_t)t * B + b] = tau2;
    active[(size_t)(t + 1) * B + b] = fin ? 0 : 1;
    if (fin) iters[b] = t + 1;
  }
}

// ------------------------------------------------------------- launchers

template <int M>
struct MonoRows {
  static constexpr int NT = 32 * RowShape<M>::NW;
  static int hm(const float* x, float* out, const int32_t* active, int B,
                int L, int t, cudaStream_t st) {
    mono_hm_kernel<M><<<dim3(L / kTileRows, B), NT, 0, st>>>(x, out, active,
                                                             B, L, t);
    return (int)cudaGetLastError();
  }
  static int row(float* work, float* beta, const float* zpart, float* bpart,
                 float* trace, int32_t* iters, int32_t* active,
                 const int32_t* pin, const float* sched, const float* sqi,
                 const float* sqo, int B, int L, int t, int last, float n,
                 float inv_sqrt_n, float tol, cudaStream_t st) {
    mono_row_kernel<M><<<dim3(L / kTileRows, B), NT, 0, st>>>(
        work, beta, zpart, bpart, trace, iters, active, pin, sched, sqi, sqo,
        B, L, t, last, n, inv_sqrt_n, tol);
    return (int)cudaGetLastError();
  }
};

#define DISPATCH_MONO_M(M, CALL)                         \
  switch (M) {                                           \
    case 32: { using Q = MonoRows<32>; return CALL; }    \
    case 64: { using Q = MonoRows<64>; return CALL; }    \
    case 128: { using Q = MonoRows<128>; return CALL; }  \
    case 256: { using Q = MonoRows<256>; return CALL; }  \
    case 512: { using Q = MonoRows<512>; return CALL; }  \
    case 1024: { using Q = MonoRows<1024>; return CALL; } \
    default: return kBadShape;                           \
  }

int encode(const float* y_n, const float* mask_n, const float* sqo,
           const int32_t* enc_idx, float* y, int B, int L, int M,
           cudaStream_t st) {
  DISPATCH_L1024(L, C::encode(y_n, mask_n, sqo, enc_idx, nullptr, 0.f, y, B,
                              M, st))
}

int col_step(float* work, const float* y, float* z, const float* mask_n,
             float* zpart, const float* bpart, const float* trace,
             const int32_t* active, int B, int L, int M, int t, float P,
             float nn, cudaStream_t st) {
  DISPATCH_L1024(L, (C::template step<float>(work, y, z, mask_n, zpart,
                                             bpart, trace, active, B, M, t,
                                             P, nn, st)))
}

int cols_fwht(float* x, int B, int L, int M, const int32_t* active, int t,
              cudaStream_t st) {
  DISPATCH_L1024(L, C::fwht(x, B, M, 0, 1.f, active, t, st))
}

int rows_hm(const float* x, float* out, const int32_t* active, int B, int L,
            int M, int t, cudaStream_t st) {
  DISPATCH_MONO_M(M, Q::hm(x, out, active, B, L, t, st))
}

int rows_softmax(float* work, float* beta, const float* zpart, float* bpart,
                 float* trace, int32_t* iters, int32_t* active,
                 const int32_t* pin, const float* sched, const float* sqi,
                 const float* sqo, int B, int L, int M, int t, int last,
                 float n, float inv_sqrt_n, float tol, cudaStream_t st) {
  DISPATCH_MONO_M(M, Q::row(work, beta, zpart, bpart, trace, iters, active,
                            pin, sched, sqi, sqo, B, L, t, last, n,
                            inv_sqrt_n, tol, st))
}

bool supported(int B, int L, int M) {
  return B >= 1 && B <= 65535 && pow2_in(L, 32, 1024) && pow2_in(M, 32, 1024);
}

}  // namespace

extern "C" {

// Whole-trial AMP of the monolithic form for B codewords.  Inputs: y_n
// (B, L, M) the channel noise (enc_idx given) or the whole observation
// (enc_idx null), embedded on the row support; mask_n (L, M) = mask / n;
// sqi, sqo (L,); enc_idx (B, L) int32 or null; pin (B, L) int32 (-1 =
// unpinned) or null; sched (T,) SE tau2 schedule or null; tol the
// early-stop threshold (0 = fixed T).  Outputs: beta (B, L, M) true scale,
// trace (T, B), iters (B,) int32.  active (T + 1, B) int32 holds the freeze
// flags and must arrive with row 0 all ones.  Scratch: y, z, work (B, L, M)
// float; zpart (B, M / 32); bpart (B, L).  L, M powers of two in
// [32, 1024].  Returns 0, a cudaError_t, or -1 for an unsupported shape.
int amp_mono_run(const float* y_n, const float* mask_n, const float* sqi,
                 const float* sqo, const int32_t* enc_idx, const int32_t* pin,
                 const float* sched, float* beta, float* trace,
                 int32_t* iters, int32_t* active, float* y, float* z,
                 float* work, float* zpart, float* bpart, int B, int L, int M,
                 int T, float P, float n, float inv_sqrt_n, float tol,
                 void* stream) {
  if (!supported(B, L, M) || T < 1 || y_n == nullptr) return kBadShape;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = encode(y_n, mask_n, sqo, enc_idx, y, B, L, M, st);
  if (rc) return rc;
  const float nn = n * n;
  for (int t = 0; t < T; ++t) {
    rc = col_step(work, y, z, mask_n, zpart, bpart, trace, active, B, L, M, t,
                  P, nn, st);
    if (rc) return rc;
    rc = rows_hm(z, work, active, B, L, M, t, st);
    if (rc) return rc;
    rc = cols_fwht(work, B, L, M, active, t, st);
    if (rc) return rc;
    rc = rows_softmax(work, beta, zpart, bpart, trace, iters, active, pin,
                      sched, sqi, sqo, B, L, M, t, t == T - 1, n, inv_sqrt_n,
                      tol, st);
    if (rc) return rc;
  }
  return 0;
}

// The monolithic form's transform of each (L, M) tile of x (B, L, M) into
// out: H_L (bf16(x) H_M), H_M on the tensor cores, H_L in float32.
int amp_mono_tile(const float* x, float* out, int B, int L, int M,
                  void* stream) {
  if (!supported(B, L, M)) return kBadShape;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = rows_hm(x, out, nullptr, B, L, M, 0, st);
  if (rc) return rc;
  return cols_fwht(out, B, L, M, nullptr, 0, st);
}

const char* amp_mono_error_string(int code) {
  if (code == kBadShape) return "unsupported shape";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
