// Whole-trial AMP decode of the partial-Hadamard SPARC, for Hopper (sm_90a).
//
// Replaces the TPU kernel sparc_ldpc_tpu/ops/amp_kernel.py::_amp_kernel_split
// (launched by amp_fused: in-kernel encode and channel noise, early stop,
// pinning, SE schedule).  Per codeword, on the (L, M) section tile:
//
//   y  = where(mask, noise, 0) + mask/n * H(sqo * one_hot(idx))     (encode)
//   T times, while the codeword is active:
//     z    = y - mask/n * H(beta') + coef * z,  coef = (P - |beta'|^2/n^2)/tau2_prev
//     tau2 = |z|^2 / n                    (or sched[t], an SE schedule)
//     beta' = sqo * softmax_row((sqi / tau2) * (H(z) + beta'))
//     pinned rows (pin[l] >= 0): beta'[l] = sqo[l] * one_hot(pin[l])
//     active while |tau2 - tau2_prev| >= tol * tau2
//   beta = beta' / sqrt(n)
//
// Early stop: a codeword whose tau2 plateaus within tol is frozen from
// the next iteration on.  The state lives in device memory and each
// iteration is two launches, so the freeze flag is a (T + 1, B) table:
// row t says which codewords run iteration t; the row stage of iteration
// t writes row t + 1 and only the launches of iteration t + 1 read it, so
// no launch reads a flag that another block of the same launch writes.
// Every block of a frozen codeword returns at once in both stages (the
// early stop saves real time); block 0 of its row stage copies tau2_prev
// into the trace.  Every block of the row stage computes tau2 and the
// convergence test itself, from the same partials in the same order, so
// the block that finishes a codeword knows it: the codeword's last
// iteration (converged, or t = T - 1) stores beta in true scale, and
// block 0 writes its iteration count.
//
// H = H_L (x) H_M is the unnormalized Kronecker Hadamard transform of the
// tile (H_L down the columns, H_M along each section row).  The scale-free
// scheme is the reference's: beta' = beta * sqrt(n), sqi = sq / sqrt(n),
// sqo = sq * sqrt(n); z and tau2 stay in true scale.  As in the reference,
// the data operand of each transform stage is rounded to bfloat16 and the
// sums are float32 (round_bf16 = 0 keeps every operand float32); the encode
// transform is all float32, so codeword power is exact to float32.
//
// What bounds it: device-memory bytes.  The TPU kernel kept a codeword's
// whole state (beta, z, y, a work tile: 4 x 2 MiB at 1024 x 512) in VMEM for
// all T iterations.  A Hopper block has at most 227 KB of shared memory, so
// here the state lives in device memory and each iteration is two launches
// over the batch:
//   column stage: one block per (codeword, 32-column strip) holds the
//     (L, 32) strip (128 KB at L = 1024) in registers and shared memory
//     (a cluster of L / 1024 blocks above L = 1024):
//     H_L of the forward transform, the residual and Onsager term, the
//     strip's |z|^2, then H_L of the adjoint transform;
//   row stage: one thread group per section row: H_M of the adjoint, the
//     max-subtracted softmax, the pin, the row's |beta'|^2, then H_M of
//     the next iteration's forward transform.
// That is about 9 (B, L, M) passes per iteration (column: read w, y, z,
// write z, u; row: read u, beta', write beta', w), 7 float32-equivalent
// passes with the work tile w/u in bf16; the (L, M) mask is shared by the
// batch and stays in L2.  On an H100 (700 W) both stages move about
// 2.1 TB/s of the 3.35: their in-block phases, not run concurrently with
// the loads (one 1024-thread block per SM in the column stage), hold them
// back as well (PERF.md).  The later design keeps the tile on chip: a
// thread-block cluster per codeword (16 CTAs x 227 KB hold a 2 MiB tile)
// with distributed shared memory in place of the two passes.
//
// Determinism: no float atomics.  Per-codeword sums are fixed-order trees
// inside a block plus a fixed-order second pass over the per-block partials,
// so the same inputs give bitwise-identical outputs.
//
// In-kernel channel noise: with per-codeword seeds the encode launch draws
// the masked AWGN itself, so no (B, L, M) noise tensor is written or read.
// The generator is Philox4x32-10 (Salmon et al., SC'11), a counter-based
// generator written out in amp_common.cuh, so the plain PyTorch version
// (ops/amp_kernel.py, philox4x32) reproduces every draw.  Layout: element
// (l, m) of codeword b uses
//   key (seed[b][0], seed[b][1]), counter (m, l / 4, 0, 0) -> words x0..x3,
//   pair p = (l % 4) / 2: u1 = (x_{2p} >> 8) 2^-24 + 2^-25,
//                         theta = 2 pi (x_{2p+1} >> 8) 2^-24,
//   normal = sqrt(-2 ln u1) * (l even ? cos theta : sin theta).
// Each thread of the encode launch owns R >= 8 consecutive rows of one
// column (R = 32 at L >= 1024, where block a of a cluster starts at row
// 1024 a), so one Philox block feeds four of its rows.  The transcendentals
// are the precise logf/sincosf/sqrtf (no fast-math).
//
// The transform stages (reg_fwht, col_fwht_ab / col_fwht_ba, row_fwht) are
// device functions, so the standalone tile transform (amp_fwht_tile) and the
// plain length-N FWHT of the operator route (fwht2_run, the counterpart of
// sparc_ldpc_tpu/ops/fwht.py::_fwht2_kernel) reuse them.  The column stage,
// the encode and the noise live in amp_common.cuh, which the monolithic
// form (amp_mono.cu) shares.
//
// L = 2048 and 4096 (the fast_l4096 preset): the column stage's H_L runs
// on a thread-block cluster of L / 1024 blocks per strip that exchange
// through distributed shared memory (amp_common.cuh states why); the row
// stage is the same at every L.  The |z|^2 partials are one per
// column-stage block, (L / 1024) * M / 32 per codeword above L = 1024.
//
// Built by sparc_ldpc_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// and called through ctypes (plain C interface below).

#include "amp_common.cuh"

namespace {

constexpr int kRowThreads = 256;   // threads per row-stage block

// The uniforms behind every draw: u1 and theta of element (l, m) of every
// codeword (rows 2j and 2j + 1 share their pair's).  For checking the
// generator against its plain version; the decode never launches it.
__global__ void noise_draws_kernel(const uint32_t* __restrict__ seeds,
                                   float* __restrict__ u1,
                                   float* __restrict__ theta, int L, int M) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (L / 4) * M) return;
  const int q = i / M, m = i % M, b = blockIdx.y;
  const uint4 x = philox4x32_10(make_uint4((uint32_t)m, (uint32_t)q, 0u, 0u),
                                make_uint2(seeds[2 * b], seeds[2 * b + 1]));
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const size_t off = ((size_t)b * L + 4 * q + r) * M + m;
    u1[off] = bm_u1(w[2 * (r / 2)]);
    theta[off] = bm_theta(w[2 * (r / 2) + 1]);
  }
}

// ------------------------------------------------------------------- rows
//
// A section row of M columns is handled by TPR = M / 4 threads, each with
// 4 adjacent columns (one float4); a block of 256 threads holds
// RPB = 256 / TPR rows.  Row bits 0-1 are inside the thread, bits 2-6 go
// through warp shuffles, and the bits above (M > 128: a row spans warps)
// through shared memory.

template <int M>
__device__ __forceinline__ void row_fwht(float (&v)[4], float* srow, int j) {
  constexpr int TPR = M / 4;
  constexpr int LANES = TPR < 32 ? TPR : 32;
  {
    const float a = v[0] + v[1], b = v[0] - v[1];
    const float c = v[2] + v[3], d = v[2] - v[3];
    v[0] = a + c;
    v[1] = b + d;
    v[2] = a - c;
    v[3] = b - d;
  }
#pragma unroll
  for (int mk = 1; mk < LANES; mk <<= 1) {
    const bool hi = (j & mk) != 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float o = __shfl_xor_sync(0xffffffffu, v[i], mk);
      v[i] = hi ? o - v[i] : v[i] + o;
    }
  }
  if constexpr (TPR > 32) {
    __syncthreads();
    reinterpret_cast<float4*>(srow)[j] = make_float4(v[0], v[1], v[2], v[3]);
    __syncthreads();
    for (int h = 128; h < M; h <<= 1) {
      for (int i = j; i < M / 2; i += TPR) {
        const int p = (i / h) * 2 * h + (i % h);
        const float a = srow[p], b = srow[p + h];
        srow[p] = a + b;
        srow[p + h] = a - b;
      }
      __syncthreads();
    }
    const float4 q = reinterpret_cast<const float4*>(srow)[j];
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
}

// Max or sum over one row's TPR threads, fixed order; every thread of the
// row gets the result.
template <int M, bool IS_MAX>
__device__ __forceinline__ float row_reduce(float x, float* red, int r) {
  constexpr int TPR = M / 4;
  constexpr int LANES = TPR < 32 ? TPR : 32;
#pragma unroll
  for (int mk = 1; mk < LANES; mk <<= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, x, mk);
    x = IS_MAX ? fmaxf(x, o) : x + o;
  }
  if constexpr (TPR > 32) {
    constexpr int WPR = TPR / 32;  // warps per row
    __syncthreads();
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
    __syncthreads();
    x = red[r * WPR];
#pragma unroll
    for (int i = 1; i < WPR; ++i) {
      const float o = red[r * WPR + i];
      x = IS_MAX ? fmaxf(x, o) : x + o;
    }
  }
  return x;
}

__device__ __forceinline__ void load4(float (&v)[4], const float* p) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void load4(float (&v)[4], const __nv_bfloat16* p) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 q;
  q.x = *reinterpret_cast<const unsigned int*>(&a);
  q.y = *reinterpret_cast<const unsigned int*>(&b);
  *reinterpret_cast<uint2*>(p) = q;
}

// Row stage of iteration t.  work holds H_L z on entry and, unless this is
// the codeword's last iteration, H_M beta'_new (the next forward
// transform) on exit.  beta holds beta' and, after the codeword's last
// iteration, the true-scale beta.
template <int M, typename WT, int FA>
__global__ void __launch_bounds__(kRowThreads)
amp_row_kernel(WT* __restrict__ work, float* __restrict__ beta,
               const float* __restrict__ zpart,  // (B, FA * M / 32)
               float* __restrict__ bpart,        // (B, L)
               float* __restrict__ trace,        // (T, B)
               int32_t* __restrict__ iters,      // (B,)
               int32_t* __restrict__ active,     // (T + 1, B)
               const int32_t* __restrict__ pin,  // (B, L) or null
               const float* __restrict__ sched,  // (T,) or null
               const float* __restrict__ sqi, const float* __restrict__ sqo,
               int B, int L, int t, int last, float n, float inv_sqrt_n,
               float tol) {
  // NS |z|^2 partials, one per column-stage block of the codeword
  constexpr int TPR = M / 4, RPB = kRowThreads / TPR, NS = FA * M / kStrip;
  constexpr int kRound = IsBf16<WT>::value;
  __shared__ __align__(16) float srows[RPB * M];
  __shared__ float red[kRowThreads / 32];
  const int r = threadIdx.x / TPR, j = threadIdx.x % TPR;
  const int b = blockIdx.y;
  const int l = blockIdx.x * RPB + r;
  float* srow = srows + r * M;
  const size_t off = ((size_t)b * L + l) * M + 4 * j;
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
    for (int s = 0; s < NS; ++s) zz += zpart[(size_t)b * NS + s];
    tau2 = zz / n;
  }
  const bool conv = fabsf(tau2 - tau2_prev) < tol * tau2;
  const bool fin = last || conv;  // this codeword's last iteration

  float v[4];
  load4(v, work + off);
  row_fwht<M>(v, srow, j);
  if (t > 0) {
    float bo[4];
    load4(bo, beta + off);
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] += bo[i];
  }
  const float ai = sqi[l] / tau2;
  float mx = -INFINITY;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[i] = ai * v[i];
    mx = fmaxf(mx, v[i]);
  }
  mx = row_reduce<M, true>(mx, red, r);
  float se = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[i] = expf(v[i] - mx);
    se += v[i];
  }
  se = row_reduce<M, false>(se, red, r);
  const float so = sqo[l] / se;
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = so * v[i];
  if (pin != nullptr) {
    const int p = pin[(size_t)b * L + l];
    if (p >= 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = (4 * j + i == p) ? sqo[l] : 0.f;
    }
  }
  float bb = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) bb += v[i] * v[i];
  if (fin) {
    float out[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = v[i] * inv_sqrt_n;
    store4(beta + off, out);
  } else {
    store4(beta + off, v);
    bb = row_reduce<M, false>(bb, red, r);
    if (j == 0) bpart[(size_t)b * L + l] = bb;
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = maybe_round(v[i], kRound);
    row_fwht<M>(v, srow, j);
    store4(work + off, v);
  }
  if (lead) {
    trace[(size_t)t * B + b] = tau2;
    active[(size_t)(t + 1) * B + b] = fin ? 0 : 1;
    if (fin) iters[b] = t + 1;
  }
}

// Standalone H_M of every row of x into out.
template <int M>
__global__ void __launch_bounds__(kRowThreads)
fwht_rows_kernel(const float* __restrict__ x, float* __restrict__ out,
                 int round_bf16) {
  constexpr int TPR = M / 4, RPB = kRowThreads / TPR;
  __shared__ __align__(16) float srows[RPB * M];
  const int r = threadIdx.x / TPR, j = threadIdx.x % TPR;
  const size_t off = ((size_t)blockIdx.x * RPB + r) * M + 4 * j;
  float v[4];
  load4(v, x + off);
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = maybe_round(v[i], round_bf16);
  row_fwht<M>(v, srows + r * M, j);
  store4(out + off, v);
}

// ------------------------------------------------------------- launchers

template <int M>
struct Rows {
  static constexpr int RPB = kRowThreads / (M / 4);
  template <typename WT>
  static int step(WT* work, float* beta, const float* zpart, float* bpart,
                  float* trace, int32_t* iters, int32_t* active,
                  const int32_t* pin, const float* sched, const float* sqi,
                  const float* sqo, int B, int L, int t, int last, float n,
                  float inv_sqrt_n, float tol, cudaStream_t st) {
    // the partials' count is a template argument: a loop with a run-time
    // trip count here cost the row stage 2 % at L = 1024 on an H100
    switch (L / kBlockRows) {
      case 2: return launch<WT, 2>(work, beta, zpart, bpart, trace, iters,
                                   active, pin, sched, sqi, sqo, B, L, t,
                                   last, n, inv_sqrt_n, tol, st);
      case 4: return launch<WT, 4>(work, beta, zpart, bpart, trace, iters,
                                   active, pin, sched, sqi, sqo, B, L, t,
                                   last, n, inv_sqrt_n, tol, st);
      default: return launch<WT, 1>(work, beta, zpart, bpart, trace, iters,
                                    active, pin, sched, sqi, sqo, B, L, t,
                                    last, n, inv_sqrt_n, tol, st);
    }
  }
  template <typename WT, int FA>
  static int launch(WT* work, float* beta, const float* zpart, float* bpart,
                    float* trace, int32_t* iters, int32_t* active,
                    const int32_t* pin, const float* sched, const float* sqi,
                    const float* sqo, int B, int L, int t, int last, float n,
                    float inv_sqrt_n, float tol, cudaStream_t st) {
    amp_row_kernel<M, WT, FA><<<dim3(L / RPB, B), kRowThreads, 0, st>>>(
        work, beta, zpart, bpart, trace, iters, active, pin, sched, sqi,
        sqo, B, L, t, last, n, inv_sqrt_n, tol);
    return (int)cudaGetLastError();
  }
  static int fwht(const float* x, float* out, int rows, int round_bf16,
                  cudaStream_t st) {
    fwht_rows_kernel<M><<<rows / RPB, kRowThreads, 0, st>>>(x, out,
                                                            round_bf16);
    return (int)cudaGetLastError();
  }
};

// Returns CALL with Q = Rows<M> for the supported M.
#define DISPATCH_M(M, CALL)                          \
  switch (M) {                                       \
    case 32: { using Q = Rows<32>; return CALL; }    \
    case 64: { using Q = Rows<64>; return CALL; }    \
    case 128: { using Q = Rows<128>; return CALL; }  \
    case 256: { using Q = Rows<256>; return CALL; }  \
    case 512: { using Q = Rows<512>; return CALL; }  \
    case 1024: { using Q = Rows<1024>; return CALL; } \
    default: return kBadShape;                       \
  }

int encode(const float* y_n, const float* mask_n, const float* sqo,
           const int32_t* enc_idx, const uint32_t* seeds, float sigma,
           float* y, int B, int L, int M, cudaStream_t st) {
  DISPATCH_L(L, C::encode(y_n, mask_n, sqo, enc_idx, seeds, sigma, y, B, M,
                          st))
}

template <typename WT>
int col_step(WT* work, const float* y, float* z, const float* mask_n,
             float* zpart, const float* bpart, const float* trace,
             const int32_t* active, int B, int L, int M, int t, float P,
             float nn, cudaStream_t st) {
  DISPATCH_L(L, (C::template step<WT, true>(work, y, z, mask_n, zpart, bpart,
                                             trace, active, B, M, t, P, nn,
                                             st)))
}

template <typename WT>
int row_step(WT* work, float* beta, const float* zpart, float* bpart,
             float* trace, int32_t* iters, int32_t* active, const int32_t* pin,
             const float* sched, const float* sqi, const float* sqo, int B,
             int L, int M, int t, int last, float n, float inv_sqrt_n,
             float tol, cudaStream_t st) {
  DISPATCH_M(M, Q::step(work, beta, zpart, bpart, trace, iters, active, pin,
                        sched, sqi, sqo, B, L, t, last, n, inv_sqrt_n, tol,
                        st))
}

// Arguments of the iteration loop (see amp_split_run).
struct AmpArgs {
  const float *mask_n, *sqi, *sqo, *y, *sched;
  const int32_t* pin;
  float *beta, *trace, *z, *zpart, *bpart;
  int32_t *iters, *active;
  int B, L, M, T;
  float P, n, inv_sqrt_n, tol;
};

template <typename WT>
int amp_iterations(const AmpArgs& a, WT* work, cudaStream_t st) {
  const float nn = a.n * a.n;
  for (int t = 0; t < a.T; ++t) {
    int rc = col_step(work, a.y, a.z, a.mask_n, a.zpart, a.bpart, a.trace,
                      a.active, a.B, a.L, a.M, t, a.P, nn, st);
    if (rc) return rc;
    rc = row_step(work, a.beta, a.zpart, a.bpart, a.trace, a.iters, a.active,
                  a.pin, a.sched, a.sqi, a.sqo, a.B, a.L, a.M, t,
                  t == a.T - 1, a.n, a.inv_sqrt_n, a.tol, st);
    if (rc) return rc;
  }
  return 0;
}

int cols_fwht(float* x, int B, int L, int M, int round_bf16, float scale,
              cudaStream_t st) {
  DISPATCH_L(L, C::fwht(x, B, M, round_bf16, scale, nullptr, 0, st))
}

int rows_fwht(const float* x, float* out, int rows, int M, int round_bf16,
              cudaStream_t st) {
  DISPATCH_M(M, Q::fwht(x, out, rows, round_bf16, st))
}

// L up to 4096, the reference's gate for the fused route
// (sparc_ldpc_tpu/models/amp.py:116); M up to 1024.
bool supported(int B, int L, int M) {
  return B >= 1 && B <= 65535 && pow2_in(L, 32, 4096) && pow2_in(M, 32, 1024);
}

}  // namespace

extern "C" {

// Whole-trial AMP for B codewords.  Inputs: y_n (B, L, M) the channel
// noise (enc_idx given) or the whole observation (enc_idx null), embedded
// on the row support, or null when seeds is given; seeds (B, 2) uint32
// Philox keys or null: the kernel then draws the masked noise itself,
// sigma times standard normals; mask_n (L, M) = mask / n; sqi, sqo (L,);
// enc_idx (B, L) int32 or null; pin (B, L) int32 (-1 = unpinned) or null;
// sched (T,) SE tau2 schedule or null; tol the early-stop threshold (0 =
// fixed T).  Outputs: beta (B, L, M) true scale, trace (T, B), iters (B,)
// int32.  active (T + 1, B) int32 holds the freeze flags and must arrive
// with row 0 all ones.  Scratch: y, z (B, L, M) float; work (B, L, M),
// bfloat16 when round_bf16 (transform operands rounded to bf16) and float
// otherwise; zpart (B, max(1, L / 1024) * M / 32); bpart (B, L).
// Returns 0, a cudaError_t, or -1 for an unsupported shape.
int amp_split_run(const float* y_n, const float* mask_n, const float* sqi,
                  const float* sqo, const int32_t* enc_idx,
                  const uint32_t* seeds, const int32_t* pin,
                  const float* sched, float* beta, float* trace,
                  int32_t* iters, int32_t* active, float* y, float* z,
                  void* work, float* zpart, float* bpart, int B, int L,
                  int M, int T, float P, float n, float inv_sqrt_n,
                  float tol, float sigma, int round_bf16, void* stream) {
  if (!supported(B, L, M) || T < 1) return kBadShape;
  if ((y_n == nullptr) == (seeds == nullptr)) return kBadShape;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = encode(y_n, mask_n, sqo, enc_idx, seeds, sigma, y, B, L, M, st);
  if (rc) return rc;
  AmpArgs a;
  a.mask_n = mask_n;
  a.sqi = sqi;
  a.sqo = sqo;
  a.y = y;
  a.sched = sched;
  a.pin = pin;
  a.beta = beta;
  a.trace = trace;
  a.z = z;
  a.zpart = zpart;
  a.bpart = bpart;
  a.iters = iters;
  a.active = active;
  a.B = B;
  a.L = L;
  a.M = M;
  a.T = T;
  a.P = P;
  a.n = n;
  a.inv_sqrt_n = inv_sqrt_n;
  a.tol = tol;
  if (round_bf16)
    return amp_iterations(a, static_cast<__nv_bfloat16*>(work), st);
  return amp_iterations(a, static_cast<float*>(work), st);
}

// K3: scale * (H_L (x) H_M) of each (L, M) tile of x (B, L, M) into out:
// H_M along the rows, then H_L down the columns, each stage's input rounded
// to bfloat16 when round_bf16 is set, the scale applied once, in float32,
// as the column stage stores its result.
//
// Replaces the TPU kernel sparc_ldpc_tpu/ops/amp_kernel.py::_fwht_tile_kernel
// (fwht_tile_pallas), the local stage of section-sharded AMP: each device
// transforms its (L/S, M) slab, L/S in [32, 4096] (a cluster of L/1024
// column blocks per strip above 1024), and the cross-shard H_S runs outside
// (parallel/amp_sharded.py).  What bounds it: device-memory bytes.  The
// function reads x and writes out once (8 bytes an element) and does
// log2(L M) adds an element, about 2.4 adds a byte where the card's
// float32 rate over its memory rate is 20; the design moves 16 bytes an
// element (the row stage reads x and writes out, the column stage reads and
// rewrites out in place), both stages on K1's device functions.
int amp_fwht_tile(const float* x, float* out, int B, int L, int M,
                  int round_bf16, float scale, void* stream) {
  if (!supported(B, L, M)) return kBadShape;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = rows_fwht(x, out, B * L, M, round_bf16, st);
  if (rc) return rc;
  return cols_fwht(out, B, L, M, round_bf16, scale, st);
}

// The masked channel noise alone: y = where(mask_n > 0, sigma * normal, 0)
// for (B, L, M), the encode launch with no codeword.
int amp_noise_run(const uint32_t* seeds, const float* mask_n, float sigma,
                  float* y, int B, int L, int M, void* stream) {
  if (!supported(B, L, M)) return kBadShape;
  return encode(nullptr, mask_n, nullptr, nullptr, seeds, sigma, y, B, L, M,
                static_cast<cudaStream_t>(stream));
}

// u1 and theta of every draw of amp_noise_run, (B, L, M) each.
int amp_noise_draws(const uint32_t* seeds, float* u1, float* theta, int B,
                    int L, int M, void* stream) {
  if (!supported(B, L, M)) return kBadShape;
  constexpr int kThreads = 256;
  const int blocks = ((L / 4) * M + kThreads - 1) / kThreads;
  noise_draws_kernel<<<dim3(blocks, B), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(seeds, u1, theta,
                                                            L, M);
  return (int)cudaGetLastError();
}

// Length-N FWHT of B rows, N = f1 * f2, each row viewed as an (f1, f2)
// row-major tile: H_f2 along the tile's rows (the input rounded to
// bfloat16 first when round_input is set), then H_f1 down its columns, in
// float32 and natural order.  f1, f2 powers of two in [32, 1024].
int fwht2_run(const float* x, float* out, int B, int f1, int f2,
              int round_input, void* stream) {
  if (!supported(B, f1, f2) || f1 > 1024) return kBadShape;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = rows_fwht(x, out, B * f1, f2, round_input, st);
  if (rc) return rc;
  return cols_fwht(out, B, f1, f2, 0, 1.f, st);
}

const char* amp_split_error_string(int code) {
  if (code == kBadShape) return "unsupported shape";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
