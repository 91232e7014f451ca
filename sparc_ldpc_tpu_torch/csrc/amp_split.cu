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
// A frozen codeword costs nothing in either stage (the column stage skips
// its items, the row stage's blocks return at once); block 0 of its row
// stage copies tau2_prev into the trace.  Every block of the row stage
// computes tau2 and the convergence test itself, from the same partials in
// the same order, so the block that finishes a codeword knows it: the
// codeword's last iteration (converged, or t = T - 1) stores beta in true
// scale, and block 0 writes its iteration count.
//
// H = H_L (x) H_M is the unnormalized Kronecker Hadamard transform of the
// tile (H_L down the columns, H_M along each section row).  The scale-free
// scheme is the reference's: beta' = beta * sqrt(n), sqi = sq / sqrt(n),
// sqo = sq * sqrt(n); z and tau2 stay in true scale.  As in the reference,
// the data operand of each transform stage is rounded to bfloat16 and the
// sums are float32 (round_bf16 = 0 keeps every operand float32); the encode
// transform is all float32, so codeword power is exact to float32.
//
// Layout.  A Hopper block has at most 227 KB of shared memory, so the state
// lives in device memory and each iteration is two launches over the batch
// (the TPU kernel kept a codeword's 8 MiB of state in VMEM):
//   column stage: H_L of the forward transform, the residual and Onsager
//     term, the strip's |z|^2, then H_L of the adjoint, on (L, 32) strips;
//   row stage: H_M of the adjoint, the max-subtracted softmax, the pin, the
//     row's |beta'|^2, then H_M of the next iteration's forward transform.
// They exchange the work tile (B, L, M), bf16 when the operands round to
// bf16.  beta' (B, L, M) float32 lives in the row stage.  y and z are kept
// only on the row support mask: (B, ns) float32 in the column stage's own
// order of the ns support entries (ops/split_support.py builds its tables:
// each thread's entries consecutive, each block's too).  Off the support z
// is 0 at every iteration, and the adjoint's input there is 0.
//
// Bytes per codeword and iteration: 16 N + 12 ns (N = L M; ns = n, 1.8 % of
// N at the headline): the column stage reads and writes the bf16 work tile
// (4 N) and reads y, z and writes z on the support (12 ns); the row stage
// reads the work tile and beta' and writes both (12 N).  The earlier design
// moved 28 N: y, the mask and z read and z written densely (16 N) in its
// column stage.
//
// Column stage (k1_col_kernel): M is a template argument (a run-time M in
// the address arithmetic cost the earlier column stage 27 % at L = 1024).
// One 1024-thread block per SM (128 KB of float32 transpose buffer, the
// layouts A and B of amp_common.cuh) walks (codeword, strip) items,
// skipping frozen codewords; while it transforms one item, cp.async brings
// the next item's bf16 strip (64 KB, 16 bytes a thread) and its support
// data (y, z, mask/n, each thread's word and first entry) into shared
// memory, so its loads overlap the in-block transposes, butterflies and
// barriers that held the earlier design back.  The residual runs in layout
// B on the thread's support rows only (its 32-bit word of rows), in the
// earlier row order, so at L <= 1024 |z|^2 and every transformed value are
// the earlier design's bit for bit.  What bounds it now: the two
// shared-memory transposes (512 KB of shared traffic an item) and the
// butterflies (20 float32 adds an element), not its 4 bytes an element of
// device memory.  float32 work tiles (round_bf16 = 0) do not fit the
// staging buffer beside the transpose buffer and are read directly.  On
// an H100 (PERF.md) the walk took 3.5 ms a headline launch against 4.2 ms
// for one item a block, and against 4.3 ms for 16-column strips with two
// resident blocks an SM (which also changes the |z|^2 sums' order); a
// quarter of the block sums' shared-memory reads, or warp 0 alone adding
// them, moved nothing or lost.  The loads are 16 bytes a thread
// (cp.async); the result is stored 2 bytes a thread, a warp a 64-byte row
// segment: staging it through shared memory for 16-byte stores took 4.0
// ms a launch.
//
// Above L = 1024 (FA = L / 1024 in {2, 4}) the strip is split over a
// cluster of FA blocks, block a holding rows 1024 a + the same local rows,
// and H_L = H_FA (x) H_1024 takes an exchange through distributed shared
// memory (amp_common.cuh).  The walk and the prefetch are the same, one
// resident cluster per walker.  The exchange runs on the support only: the
// forward transform's H_FA (after each block's H_1024) is needed only at
// the residual's rows, one remote read per other block there (the same
// values as the dense exchange); the adjoint's input is 0 off the support,
// so its H_FA runs first, reading the other blocks' z of the item (in
// device memory, just written) where they have a support row, and H_1024
// follows: the same function as the dense design's, which took H_1024
// first, with its float32 sums in another order.  Two cluster barriers an
// item instead of six, and about one remote value a thread per transform
// instead of 3 R.
//
// Row stage (k1_row_kernel): one warp per section row, M / 32 values a lane
// (chunks of 8 columns: 16-byte loads and stores of the bf16 work tile,
// two of beta').  H_M's bits run in registers and shuffles in ascending
// order, and the max, the exp-sum and |beta'|^2 are warp reductions that
// add in the earlier design's order, with no shared memory and no block
// barrier.  What bounds it: its 12 bytes an element of device memory.
//
// The column and row stages' kernels and launchers are in amp_k1.cuh,
// which the split kernel's stage ablation (S2, amp_exp.cu) shares: its
// variants are compile-time variants of them, K1's the default.
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
// K1's encode launch (k1_encode_kernel) draws only the Philox blocks that
// feed a support row of its thread's R >= 8 consecutive rows and writes
// the compact y; the dense noise launch (amp_noise_run) is amp_common.cuh's
// encode with no codeword.  The transcendentals are the precise
// logf/sincosf/sqrtf (no fast-math).
//
// The transform stages of the plain length-N FWHT of the operator route
// (fwht2_run, K5, the counterpart of sparc_ldpc_tpu/ops/fwht.py::
// _fwht2_kernel) and of the standalone tile transform in float32
// (amp_fwht_tile, K3) are row_fwht below and amp_common.cuh's column code,
// which the monolithic form (amp_mono.cu) shares; K3 in bf16 has kernels of
// its own (k3_row_kernel, k3_col_kernel, below).
//
// Built by sparc_ldpc_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// and called through ctypes (plain C interface below).

#include "amp_k1.cuh"

namespace {

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
// The standalone row transform of K3 and K5 (fwht_rows_kernel), the
// earlier design's row stage: a section row of M columns is handled by
// TPR = M / 4 threads, each with
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


// --------------------------------------------------------------------- K3
//
// K3 in bf16 mode (amp_fwht_tile with round_bf16; the mode section-sharded
// AMP runs): a bf16 intermediate, in distributed shared memory (one launch,
// 8 bytes an element) or in device memory (two launches, 12 bytes) against
// the earlier 16 (a float32 intermediate, rewritten in place by the column
// stage).  Storing the intermediate in bf16 changes no value: the column
// stage rounded it to bf16 before H_L anyway.

// Rows: one warp per section row (RowShape, as K1's row stage), x read in
// chunks of C float32 and rounded to bf16, H_M in registers and shuffles
// (row_fwht's butterflies, so the same values), the result rounded to bf16
// and stored in chunks of C (16 bytes at C = 8).  Grid (rows / RPB).
template <int M>
__global__ void __launch_bounds__(kRowThreads)
k3_row_kernel(const float* __restrict__ x, __nv_bfloat16* __restrict__ mid) {
  using Sh = RowShape<M>;
  constexpr int VPL = Sh::VPL, C = Sh::C, NCH = Sh::NCH;
  const int lane = threadIdx.x & 31;
  const int j = lane % Sh::TPR;
  const int r = (threadIdx.x >> 5) * (32 / Sh::TPR) + lane / Sh::TPR;
  const size_t row = ((size_t)blockIdx.x * Sh::RPB + r) * M;
  float v[VPL];
#pragma unroll
  for (int i = 0; i < NCH; ++i)
    load_chunk<C>(v + C * i, x + row + Sh::col(j, C * i));
#pragma unroll
  for (int i = 0; i < VPL; ++i) v[i] = maybe_round(v[i], 1);
  warp_row_fwht<M>(v, j);
#pragma unroll
  for (int i = 0; i < NCH; ++i)
    store_chunk<C>(mid + row + Sh::col(j, C * i), v + C * i);
}

// One pass for l <= kK3ClusterRows and M <= 512: a cluster of CL = M / 32
// blocks per codeword keeps the bf16 intermediate in its blocks' shared
// memory.
// Block j of the cluster runs the row stage on its RB = l / CL rows (x read
// once, rounded, H_M in registers and shuffles, rounded) into its shared
// memory; after a cluster barrier it reads strip j (32 columns) of all l
// rows from the blocks that hold them (distributed shared memory, 64-byte
// row segments a warp), runs the column code (H_L in float32 through its own
// transpose buffer) and writes the strip, times scale, once: 8 bytes an
// element of device memory, the function's, and 2 through the cluster.
// Shared memory l * 64 bytes of intermediate beside l * 128 of transpose
// buffer (48 KB at l = 256).  The same values as the two launches.  On an
// H100 (PERF.md, tools/amp_ab.py --k3) it beat them at (B, l, M) =
// (1024, 256, 512), 0.56-0.57 ms against 0.61-0.63, and lost at l = 512
// and 1024 (1.48-1.50 ms against 1.18 at (1024, 512, 512), 1.32 against
// 1.19 at (512, 1024, 512)), where a block's 96 or 192 KB of shared memory
// leave one or two resident blocks an SM and nothing overlaps its loads;
// the two launches run there (ops/amp_kernel.py k3_design chooses).
constexpr int kK3ClusterRows = 256;
template <int W, int R, int M>
__global__ void __launch_bounds__(32 * W, 1)
k3_cluster_kernel(const float* __restrict__ x, float* __restrict__ out,
                  float scale) {
  extern __shared__ __align__(16) float kc_sm[];
  using Sh = RowShape<M>;
  constexpr int L = W * R, CL = M / kStrip, RB = L / CL, NT = 32 * W;
  constexpr int C = Sh::C, NCH = Sh::NCH, RPP = NT / Sh::TPR;
  float* sm = kc_sm;  // transpose buffer, then this block's RB rows of mid
  __nv_bfloat16* mid = reinterpret_cast<__nv_bfloat16*>(sm + L * kStrip);
  cg::cluster_group cl = cg::this_cluster();
  const int j = (int)cl.block_rank();
  const size_t base = (size_t)(blockIdx.x / CL) * L * M;
  {
    const int lane = threadIdx.x & 31, jj = lane % Sh::TPR;
    for (int r = (threadIdx.x >> 5) * (32 / Sh::TPR) + lane / Sh::TPR;
         r < RB; r += RPP) {
      const float* src = x + base + (size_t)(j * RB + r) * M;
      float v[Sh::VPL];
#pragma unroll
      for (int i = 0; i < NCH; ++i)
        load_chunk<C>(v + C * i, src + Sh::col(jj, C * i));
#pragma unroll
      for (int i = 0; i < Sh::VPL; ++i) v[i] = maybe_round(v[i], 1);
      warp_row_fwht<M>(v, jj);
#pragma unroll
      for (int i = 0; i < NCH; ++i)
        store_chunk<C>(mid + r * M + Sh::col(jj, C * i), v + C * i);
    }
  }
  cl.sync();  // every block's rows are in its shared memory
  const int w = threadIdx.x >> 5, c = threadIdx.x & 31;
  float v[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int l = w + W * k;
    const __nv_bfloat16* src = cl.map_shared_rank(mid, l / RB);
    v[k] = __bfloat162float(src[(l % RB) * M + j * kStrip + c]);
  }
  cl.sync();  // the other blocks are done reading this one's rows
  col_fwht_ab<W, R, 1>(v, sm, w, c, 0);
  float* dst = out + base + j * kStrip + c;
#pragma unroll
  for (int k = 0; k < R; ++k) dst[(size_t)(R * w + k) * M] = v[k] * scale;
}

// Columns: H_L of every 32-column strip of mid, times scale, into out
// (float32), with amp_common.cuh's column code (a cluster of FA blocks per
// strip above L = 1024).  Walkers as K1's column stage, as many as are
// resident (one block, or one cluster, per SM): walker i takes the items
// (codeword, strip) i, i + walkers, ...; while it transforms one, cp.async
// brings the next one's bf16 strip (16 bytes a thread) into shared memory
// beside the float32 transpose buffer, so the loads overlap the
// transposes, butterflies and stores.
template <int W, int R, int FA>
__global__ void __launch_bounds__(32 * W, 1)
k3_col_kernel(const __nv_bfloat16* __restrict__ mid, float* __restrict__ out,
              int B, int M, float scale) {
  extern __shared__ __align__(16) float k3_sm[];
  constexpr int LB = W * R, NT = 32 * W, L = FA * LB;
  float* sm = k3_sm;
  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(sm + LB * kStrip);
  const int w = threadIdx.x >> 5, c = threadIdx.x & 31;
  const int a = blockIdx.x % FA, walkers = gridDim.x / FA;
  const int S = M / kStrip, items = B * S;
  // offset of an item's strip at this block's first row
  auto strip = [&](int it) {
    return ((size_t)(it / S) * L + (size_t)a * LB) * M +
           (size_t)(it % S) * kStrip;
  };
  auto fetch = [&](int it) {
    const __nv_bfloat16* src = mid + strip(it);
    for (int q = threadIdx.x; q < LB * 4; q += NT) {
      const int r = q >> 2, p = q & 3;
      cp_async16(stage + r * kStrip + 8 * p, src + (size_t)r * M + 8 * p);
    }
  };
  int it = blockIdx.x / FA;  // the same in every block of a cluster
  if (it >= items) return;
  fetch(it);
  while (it < items) {
    const int nx = it + walkers;
    cp_async_wait_all();
    __syncthreads();  // this item's strip is visible
    float v[R];
#pragma unroll
    for (int k = 0; k < R; ++k)
      v[k] = __bfloat162float(stage[(w + W * k) * kStrip + c]);
    __syncthreads();  // every thread has read the stage
    if (nx < items) fetch(nx);
    col_fwht_ab<W, R, FA>(v, sm, w, c, a);
    float* dst = out + strip(it) + c;
#pragma unroll
    for (int k = 0; k < R; ++k) dst[(size_t)(R * w + k) * M] = v[k] * scale;
    it = nx;
  }
}

// ------------------------------------------------------------- launchers

template <int M>
struct Rows {
  static constexpr int RPB = kRowThreads / (M / 4);
  static int fwht(const float* x, float* out, int rows, int round_bf16,
                  cudaStream_t st) {
    fwht_rows_kernel<M><<<rows / RPB, kRowThreads, 0, st>>>(x, out,
                                                            round_bf16);
    return (int)cudaGetLastError();
  }
  template <typename WT>
  static int k1_step(WT* work, float* beta, const float* zpart, float* bpart,
                     float* trace, int32_t* iters, int32_t* active,
                     const int32_t* pin, const float* sched, const float* sqi,
                     const float* sqo, int B, int L, int t, int last, float n,
                     float inv_sqrt_n, float tol, cudaStream_t st) {
    // the partials' count is a template argument: a loop with a run-time
    // trip count here cost the row stage 2 % at L = 1024 on an H100
    switch (L / kBlockRows) {
      case 2: return k1_row_launch<M, WT, 2>(work, beta, zpart, bpart, trace,
                                             iters, active, pin, sched, sqi,
                                             sqo, B, L, t, last, n,
                                             inv_sqrt_n, tol, st);
      case 4: return k1_row_launch<M, WT, 4>(work, beta, zpart, bpart, trace,
                                             iters, active, pin, sched, sqi,
                                             sqo, B, L, t, last, n,
                                             inv_sqrt_n, tol, st);
      default: return k1_row_launch<M, WT, 1>(work, beta, zpart, bpart,
                                              trace, iters, active, pin,
                                              sched, sqi, sqo, B, L, t, last,
                                              n, inv_sqrt_n, tol, st);
    }
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

// K1's encode and column stage for the column geometry (W, R, FA).
template <int W, int R, int FA>
struct K1Cols {
  static int encode(const float* y_n, const Support& sp, const float* sqo,
                    const int32_t* enc_idx, const uint32_t* seeds,
                    float sigma, float* yc, int B, int M, cudaStream_t st) {
    return k1_encode_launch<W, R, FA>(y_n, sp, sqo, enc_idx, seeds, sigma, yc,
                                      B, M, st);
  }
  template <typename WT>
  static int step(WT* work, const float* yc, float* zc, const Support& sp,
                  float* zpart, const float* bpart, const float* trace,
                  const int32_t* active, int B, int M, int t, float P,
                  float nn, cudaStream_t st) {
    switch (M) {
#define K1_COL_M(MM)                                                     \
  case MM:                                                               \
    return k1_col_launch<W, R, FA, MM, WT>(work, yc, zc, sp, zpart, bpart, \
                                           trace, active, B, t, P, nn, st);
      K1_COL_M(32) K1_COL_M(64) K1_COL_M(128) K1_COL_M(256) K1_COL_M(512)
      K1_COL_M(1024)
#undef K1_COL_M
      default: return kBadShape;
    }
  }
};

template <class C>
struct K1Of;
template <int W, int R, int FA>
struct K1Of<Cols<W, R, FA>> {
  using type = K1Cols<W, R, FA>;
};

int encode(const float* y_n, const float* mask_n, const float* sqo,
           const int32_t* enc_idx, const uint32_t* seeds, float sigma,
           float* y, int B, int L, int M, cudaStream_t st) {
  DISPATCH_L(L, C::encode(y_n, mask_n, sqo, enc_idx, seeds, sigma, y, B, M,
                          st))
}

int k1_encode(const float* y_n, const Support& sp, const float* sqo,
              const int32_t* enc_idx, const uint32_t* seeds, float sigma,
              float* yc, int B, int L, int M, cudaStream_t st) {
  DISPATCH_L(L, K1Of<C>::type::encode(y_n, sp, sqo, enc_idx, seeds, sigma,
                                      yc, B, M, st))
}

template <typename WT>
int k1_col_step(WT* work, const float* yc, float* zc, const Support& sp,
                float* zpart, const float* bpart, const float* trace,
                const int32_t* active, int B, int L, int M, int t, float P,
                float nn, cudaStream_t st) {
  DISPATCH_L(L, (K1Of<C>::type::template step<WT>(
                    work, yc, zc, sp, zpart, bpart, trace, active, B, M, t, P,
                    nn, st)))
}

template <typename WT>
int k1_row_step(WT* work, float* beta, const float* zpart, float* bpart,
                float* trace, int32_t* iters, int32_t* active,
                const int32_t* pin, const float* sched, const float* sqi,
                const float* sqo, int B, int L, int M, int t, int last,
                float n, float inv_sqrt_n, float tol, cudaStream_t st) {
  DISPATCH_M(M, (Q::template k1_step<WT>(work, beta, zpart, bpart, trace,
                                         iters, active, pin, sched, sqi, sqo,
                                         B, L, t, last, n, inv_sqrt_n, tol,
                                         st)))
}

// Arguments of the iteration loop (see amp_split_run).
struct AmpArgs {
  Support sp;
  const float *sqi, *sqo, *yc, *sched;
  const int32_t* pin;
  float *beta, *trace, *zc, *zpart, *bpart;
  int32_t *iters, *active;
  int B, L, M, T;
  float P, n, inv_sqrt_n, tol;
};

template <typename WT>
int amp_iterations(const AmpArgs& a, WT* work, cudaStream_t st) {
  const float nn = a.n * a.n;
  for (int t = 0; t < a.T; ++t) {
    int rc = k1_col_step(work, a.yc, a.zc, a.sp, a.zpart, a.bpart, a.trace,
                         a.active, a.B, a.L, a.M, t, a.P, nn, st);
    if (rc) return rc;
    rc = k1_row_step(work, a.beta, a.zpart, a.bpart, a.trace, a.iters,
                     a.active, a.pin, a.sched, a.sqi, a.sqo, a.B, a.L, a.M, t,
                     t == a.T - 1, a.n, a.inv_sqrt_n, a.tol, st);
    if (rc) return rc;
  }
  return 0;
}

template <class C>
struct K3Of;
template <int W, int R, int FA>
struct K3Of<Cols<W, R, FA>> {
  static int cols(const __nv_bfloat16* mid, float* out, int B, int M,
                  float scale, cudaStream_t st) {
    auto kernel = k3_col_kernel<W, R, FA>;
    constexpr int bytes = W * R * kStrip * (4 + 2);
    int rc = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (rc) return rc;
    int walkers = 0;
    rc = resident_walkers<FA>(kernel, 32 * W, bytes, st, &walkers);
    if (rc) return rc;
    const int items = B * (M / kStrip);
    walkers = walkers < items ? walkers : items;
    ClusterLaunch<FA> lc(dim3(FA * walkers), 32 * W, bytes, st);
    rc = (int)cudaLaunchKernelEx(&lc.cfg, kernel, mid, out, B, M, scale);
    return rc ? rc : (int)cudaGetLastError();
  }
};

// The one-pass cluster kernel for (W, R) of L = W R <= 1024 and M <= 512.
template <int W, int R, int M>
int k3_cluster_launch(const float* x, float* out, int B, float scale,
                      cudaStream_t st) {
  auto kernel = k3_cluster_kernel<W, R, M>;
  constexpr int CL = M / kStrip;
  constexpr int bytes = W * R * (kStrip * 4 + M / CL * 2);
  int rc = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (!rc && CL > 8)
    rc = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (rc) return rc;
  ClusterLaunch<CL> lc(dim3(CL * B), 32 * W, bytes, st);
  rc = (int)cudaLaunchKernelEx(&lc.cfg, kernel, x, out, scale);
  return rc ? rc : (int)cudaGetLastError();
}

template <class C>
struct K3ClusterOf;
template <int W, int R>
struct K3ClusterOf<Cols<W, R, 1>> {
  static int run(const float* x, float* out, int B, int M, float scale,
                 cudaStream_t st) {
    switch (M) {
      case 32: return k3_cluster_launch<W, R, 32>(x, out, B, scale, st);
      case 64: return k3_cluster_launch<W, R, 64>(x, out, B, scale, st);
      case 128: return k3_cluster_launch<W, R, 128>(x, out, B, scale, st);
      case 256: return k3_cluster_launch<W, R, 256>(x, out, B, scale, st);
      case 512: return k3_cluster_launch<W, R, 512>(x, out, B, scale, st);
      default: return kBadShape;
    }
  }
};

int k3_cluster(const float* x, float* out, int B, int L, int M, float scale,
               cudaStream_t st) {
  switch (L) {
    case 32: return K3ClusterOf<Cols<4, 8, 1>>::run(x, out, B, M, scale, st);
    case 64: return K3ClusterOf<Cols<8, 8, 1>>::run(x, out, B, M, scale, st);
    case 128:
      return K3ClusterOf<Cols<8, 16, 1>>::run(x, out, B, M, scale, st);
    case 256:
      return K3ClusterOf<Cols<16, 16, 1>>::run(x, out, B, M, scale, st);
    default: return kBadShape;
  }
}

int k3_cols(const __nv_bfloat16* mid, float* out, int B, int L, int M,
            float scale, cudaStream_t st) {
  DISPATCH_L(L, K3Of<C>::cols(mid, out, B, M, scale, st))
}

template <int M>
int k3_rows_m(const float* x, __nv_bfloat16* mid, int rows, cudaStream_t st) {
  k3_row_kernel<M><<<rows / RowShape<M>::RPB, kRowThreads, 0, st>>>(x, mid);
  return (int)cudaGetLastError();
}

int k3_rows(const float* x, __nv_bfloat16* mid, int rows, int M,
            cudaStream_t st) {
  switch (M) {
    case 32: return k3_rows_m<32>(x, mid, rows, st);
    case 64: return k3_rows_m<64>(x, mid, rows, st);
    case 128: return k3_rows_m<128>(x, mid, rows, st);
    case 256: return k3_rows_m<256>(x, mid, rows, st);
    case 512: return k3_rows_m<512>(x, mid, rows, st);
    case 1024: return k3_rows_m<1024>(x, mid, rows, st);
    default: return kBadShape;
  }
}

int cols_fwht(float* x, int B, int L, int M, int round_bf16, float scale,
              cudaStream_t st) {
  DISPATCH_L(L, C::fwht(x, B, M, round_bf16, scale, st))
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
// noise (enc_idx given) or the whole observation (enc_idx null), read on
// the row support only, or null when seeds is given; seeds (B, 2) uint32
// Philox keys or null: the kernel then draws the masked noise itself,
// sigma times standard normals.  The row support, ns entries in the
// kernel's order (ops/split_support.py): mask_c (ns,) mask/n of each entry,
// offset and word (L / R, M) int32 / uint32, block (FA * M / 32 + 1,) int32.
// sqi, sqo (L,); enc_idx (B, L) int32 or null; pin (B, L) int32 (-1 =
// unpinned) or null; sched (T,) SE tau2 schedule or null; tol the
// early-stop threshold (0 = fixed T).  Outputs: beta (B, L, M) true scale,
// trace (T, B), iters (B,) int32.  active (T + 1, B) int32 holds the freeze
// flags and must arrive with row 0 all ones.  Scratch: yc, zc (B, ns)
// float; work (B, L, M), bfloat16 when round_bf16 (transform operands
// rounded to bf16) and float otherwise; zpart (B, max(1, L / 1024) * M /
// 32); bpart (B, L).  Returns 0, a cudaError_t, or -1 for an unsupported
// shape.
int amp_split_run(const float* y_n, const float* mask_c,
                  const int32_t* offset, const uint32_t* word,
                  const int32_t* block, int ns, const float* sqi,
                  const float* sqo, const int32_t* enc_idx,
                  const uint32_t* seeds, const int32_t* pin,
                  const float* sched, float* beta, float* trace,
                  int32_t* iters, int32_t* active, float* yc, float* zc,
                  void* work, float* zpart, float* bpart, int B, int L,
                  int M, int T, float P, float n, float inv_sqrt_n,
                  float tol, float sigma, int round_bf16, void* stream) {
  if (!supported(B, L, M) || T < 1 || ns < 0) return kBadShape;
  if ((y_n == nullptr) == (seeds == nullptr)) return kBadShape;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  AmpArgs a;
  a.sp.mask = mask_c;
  a.sp.offset = offset;
  a.sp.word = word;
  a.sp.block = block;
  a.sp.ns = ns;
  int rc = k1_encode(y_n, a.sp, sqo, enc_idx, seeds, sigma, yc, B, L, M, st);
  if (rc) return rc;
  a.sqi = sqi;
  a.sqo = sqo;
  a.yc = yc;
  a.sched = sched;
  a.pin = pin;
  a.beta = beta;
  a.trace = trace;
  a.zc = zc;
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
// as the column stage stores its result.  With round_bf16, mid is the
// (B, L, M) bfloat16 intermediate of the two launches, or null for the
// one-pass cluster launch (L <= kK3ClusterRows, M <= 512); the caller picks
// (ops/amp_kernel.py k3_design).
//
// Replaces the TPU kernel sparc_ldpc_tpu/ops/amp_kernel.py::_fwht_tile_kernel
// (fwht_tile_pallas), the local stage of section-sharded AMP: each device
// transforms its (L/S, M) slab, L/S in [32, 4096] (a cluster of L/1024
// column blocks per strip above 1024), and the cross-shard H_S runs outside
// (parallel/amp_sharded.py).  What bounds it: device-memory bytes.  The
// function reads x and writes out once (8 bytes an element) and does
// log2(L M) adds an element, about 2.4 adds a byte where the card's
// float32 rate over its memory rate is 20.  In bf16 mode (the sharded
// loop's) at L <= 256 and M <= 512 it is one launch that moves those 8
// bytes (k3_cluster_kernel: a cluster of M / 32 blocks a codeword keeps
// the bf16 intermediate in distributed shared memory); above, two launches
// over a bf16 intermediate in device memory, 12 bytes an element
// (k3_row_kernel reads x and writes it, k3_col_kernel reads it and writes
// out).  Either gives the earlier design's values bit for bit (the same
// butterflies, and the intermediate was rounded to bf16 before H_L there
// too).  Without rounding (float32, which no timed path runs) it keeps the
// earlier design: the row stage into out and the column stage in place,
// 16 bytes an element.
int amp_fwht_tile(const float* x, float* out, void* mid, int B, int L,
                  int M, int round_bf16, float scale, void* stream) {
  if (!supported(B, L, M)) return kBadShape;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!round_bf16) {
    int rc = rows_fwht(x, out, B * L, M, 0, st);
    if (rc) return rc;
    return cols_fwht(out, B, L, M, 0, scale, st);
  }
  if (mid == nullptr) {
    if (L > kK3ClusterRows || M > 512) return kBadShape;
    return k3_cluster(x, out, B, L, M, scale, st);
  }
  __nv_bfloat16* m = static_cast<__nv_bfloat16*>(mid);
  int rc = k3_rows(x, m, B * L, M, st);
  if (rc) return rc;
  return k3_cols(m, out, B, L, M, scale, st);
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
