// Whole-trial AMP decode, slab form, for Hopper (sm_90a).
//
// Replaces the TPU kernel sparc_ldpc_tpu/ops/amp_kernel.py::_amp_kernel_slab
// (K7, the route of amp_kernel="fused_slab": in-kernel encode, early stop,
// pinning, SE schedule; no in-kernel noise).  It computes the iteration of
// amp_split.cu (same scale-free scheme, freeze table and pins, and y and z
// kept on the row support only, in K1's layout of ops/split_support.py)
// with the slab kernel's transform and reductions:
//
//   H = H_L (x) H_M,  H_L = H_{f_a} (x) H_{f_b},  H_M = H_{m_a} (x) H_{m_b}
//   f_b = min(128, L), m_b = 128 when 128 divides M > 128, else M
//
// H_M runs first in both transforms, on the data rounded to bf16, and H_L
// on the H_M stage's result rounded to bf16 again: the reference's `_mm`
// (tall column blocks times H_{m_b}) and `_mml` (H_{f_b} times wide row
// slabs).  The 128-wide factors of the dense stages are products on the
// tensor cores, as the TPU kernel runs them on its matrix unit: mma.sync
// m16n8k16 with bf16 data and float32 accumulation, their +-1 fragments
// made in registers from the parity of popcount(k & n) (no factor is
// loaded).  The radix factors H_{m_a} and H_{f_a} are float32 butterflies
// on the products, stride 1 first, the order of the reference's
// `_fwht_blocks`; above L = 1024 the rest of H_{f_a} runs across a cluster
// of L / 1024 blocks through distributed shared memory (amp_common.cuh
// cluster_fwht, K1's).  The kernel computes in bf16 only: its factors run
// on the bf16 tensor cores, and the reference kernel has no float32 mode
// either.
//
// Reductions are the slab kernel's: tau2 from one |z|^2 partial per
// (codeword, slab, 32-column strip), |beta'|^2 from one partial per
// (codeword, slab); a consumer adds each slab's partials, then the slabs in
// slab order.  No float atomics: the same inputs give the same bits.
//
// State: the TPU kernel kept y, z and beta of a codeword in VMEM for all T
// iterations (4 x 2 MiB at L = 1024, M = 512); a Hopper SM has 227 KB of
// shared memory, so the state lives in device memory.  z is 0 off the row
// support at every iteration, so y and z are kept only there, (B, ns) in
// K1's order of the entries (about n / L = 9 of a 512-wide row at the
// headline).  An iteration is three launches:
//   C1 (slab_c1_kernel): H_L of the work tile w = bf16(H_M bf16(beta')),
//     the residual and Onsager term z = y - mask/n * H(beta') + coef * z on
//     the support entries alone, z written compact and, as bf16 with its
//     column, at its row-major place for R2C2, and the strip's |z|^2 per
//     slab;
//   R2C2 (slab_adj_kernel): the adjoint from the compact z: each strip's
//     columns of H_M bf16(z) built from each row's support entries (the
//     mono form's sparse build, amp_mono.cu mono_adj_kernel: a shift, a
//     logic operation and an add a term), rounded to bf16 as the
//     reference's `_mml` reads them, then H_L on the tensor cores, u
//     written once in float32;
//   R3 (slab_row_kernel, one block per slab of f_b rows, 16 rows at a
//     time): u + beta', the max-subtracted softmax, pin, the slab's
//     |beta'|^2, and, unless it is the codeword's last iteration,
//     bf16(H_M bf16(beta'_new)) into the work tile for the next C1.
// C1 and R2C2 walk (codeword, strip) items, skipping frozen codewords,
// with as many walkers as are resident (one block, or one cluster, an SM).
// C1 keeps two strip buffers: cp.async brings the next item's bf16 strip
// (and its support entries of y, z and mask/n) while this item's products
// run.  R2C2 stages the packed z of the block's rows by cp.async while the
// item before is in its products.  The column products read their bf16
// operand with ldmatrix.trans (one instruction for two k-steps of a 16 x 8
// tile) and a warp owns one (16-row, 8-column) tile of every slab of the
// block, so H_{f_a} across the block's slabs is in its registers.  The
// encode is K1's compact encode (k1_encode_kernel: the one-hot row's H_M in
// closed form, H_L in float32, y written on the support), so codeword
// power is exact to float32 where the reference's two bf16 passes (hi, lo)
// reach about 2^-16.
//
// Bytes: per element and iteration C1 reads the bf16 work tile (2 bytes),
// R2C2 writes u (4), R3 reads u and beta' and writes beta' and the bf16
// work tile (14): 20 bytes, beside 16 bytes an entry of the support (y, z
// read, z and its packed copy written) and the packed z read by R2C2.  At
// the headline shape (B = 2048, L = 1024, M = 512, T = 22) about 472 GB,
// 141 ms at 3.35 TB/s.  The earlier design moved about 40 bytes an
// element: C1 read y, mask/n and z and wrote z densely, a row launch (R2)
// multiplied the mostly-zero z by the dense H_M on the tensor cores into a
// bf16 tile, and a column launch (C2) read it back.  On an H100 (PERF.md)
// R3 runs near the card's memory rate, while C1 and R2C2 take two to four
// times their bytes' time: R2C2 is held by its sparse build's
// instructions, as the mono form's is, and a warp taking two (i, j) units
// (16 warps a block) was slower in both.  The function itself needs
// neither: its bound (chip_smoke.py amp_bound, the butterflies' log2(L M)
// float32 adds per element and transform, inputs read and outputs written
// once) is 17.5 ms at that shape.
//
// The kernels are in amp_k7.cuh, shared with the stage ablation S4
// (amp_slab_exp.cu), which instantiates them at other variants.
//
// Built by sparc_ldpc_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// and called through ctypes (plain C interface below).

#include "amp_k7.cuh"

namespace {

// Returns CALL with K = SlabColsOf<f_b, slabs a block, cluster size> for
// the supported L.
#define DISPATCH_SLAB_L(L, CALL)                                       \
  switch (L) {                                                         \
    case 32: { using K = SlabColsOf<32, 1, 1>; return CALL; }          \
    case 64: { using K = SlabColsOf<64, 1, 1>; return CALL; }          \
    case 128: { using K = SlabColsOf<128, 1, 1>; return CALL; }        \
    case 256: { using K = SlabColsOf<128, 2, 1>; return CALL; }        \
    case 512: { using K = SlabColsOf<128, 4, 1>; return CALL; }        \
    case 1024: { using K = SlabColsOf<128, 8, 1>; return CALL; }       \
    case 2048: { using K = SlabColsOf<128, 8, 2>; return CALL; }       \
    case 4096: { using K = SlabColsOf<128, 8, 4>; return CALL; }       \
    default: return kBadShape;                                         \
  }

template <bool RESID>
int c1_step(const __nv_bfloat16* work, float* out, const float* yc, float* zc,
            uint32_t* zr, const Support& sp, const int32_t* perm,
            float* zpart, const float* bpart, const float* trace,
            const int32_t* active, int B, int L, int M, int t, float P,
            float nn, cudaStream_t st) {
  DISPATCH_SLAB_L(L, (K::template c1<RESID>(
                         work, out, yc, zc, zr, sp, perm, zpart, bpart,
                         trace, active, B, M, t, P, nn, st)))
}

int adj_step(const uint32_t* zr, const int32_t* row_offset, int ns, float* u,
             const int32_t* active, int B, int L, int M, int t,
             cudaStream_t st) {
  DISPATCH_SLAB_L(L, (K::adj(zr, row_offset, ns, u, active, B, M,
                                        t, st)))
}

// K1's compact encode for the column geometry C = Cols<W, R, FA>.
template <class C>
struct EncodeOf;
template <int W, int R, int FA>
struct EncodeOf<Cols<W, R, FA>> {
  static int run(const float* y_n, const Support& sp, const float* sqo,
                 const int32_t* enc_idx, float* yc, int B, int M,
                 cudaStream_t st) {
    auto kernel = k1_encode_kernel<W, R, FA>;
    const int bytes = W * R * kStrip * (int)sizeof(float);
    int rc = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (rc) return rc;
    ClusterLaunch<FA> lc(dim3(FA * (M / kStrip), B), 32 * W, bytes, st);
    rc = (int)cudaLaunchKernelEx(&lc.cfg, kernel, y_n, sp, sqo, enc_idx,
                                 static_cast<const uint32_t*>(nullptr), 0.f,
                                 yc, M);
    return rc ? rc : (int)cudaGetLastError();
  }
};

int encode(const float* y_n, const Support& sp, const float* sqo,
           const int32_t* enc_idx, float* yc, int B, int L, int M,
           cudaStream_t st) {
  DISPATCH_L(L, EncodeOf<C>::run(y_n, sp, sqo, enc_idx, yc, B, M, st))
}

template <int M>
struct SlabRowLaunch {
  static constexpr int NT = SlabRows<M>::THREADS;
  static int hm(const float* x, __nv_bfloat16* out, int B, int L,
                cudaStream_t st) {
    slab_hm_kernel<M><<<dim3(L / kTile, B), NT, 0, st>>>(x, out, L);
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

int rows_hm(const float* x, __nv_bfloat16* out, int B, int L, int M,
            cudaStream_t st) {
  DISPATCH_SLAB_M(M, Q::hm(x, out, B, L, st))
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
// null), read on the row support only.  The row support, ns entries in
// K1's order (ops/split_support.py): mask_c (ns,) mask/n of each entry,
// offset and word (L / R, M), block (FA M / 32 + 1,) with FA =
// max(1, L / 1024), perm (ns,) each entry's place in row-major order,
// row_offset (L + 1,) each row's first entry in row-major order.  sqi, sqo
// (L,); enc_idx (B, L) int32 or null; pin (B, L) int32 (-1 = unpinned) or
// null; sched (T,) SE tau2 schedule or null; tol the early-stop threshold
// (0 = fixed T).  Outputs: beta (B, L, M) true scale, trace (T, B), iters
// (B,) int32.  active (T + 1, B) int32 holds the freeze flags and must
// arrive with row 0 all ones.  Scratch: yc, zc (B, ns) float, zr (B, ns)
// uint32, u (B, L, M) float, work (B, L, M) bfloat16; zpart (B, f_a M /
// 32); bpart (B, f_a), f_a = L / min(128, L).  L, M powers of two, L in
// [32, 4096], M in [32, 1024].  Returns 0, a cudaError_t, or -1 for an
// unsupported shape.
int amp_slab_run(const float* y_n, const float* mask_c, const int32_t* offset,
                 const uint32_t* word, const int32_t* block,
                 const int32_t* perm, const int32_t* row_offset, int ns,
                 const float* sqi, const float* sqo, const int32_t* enc_idx,
                 const int32_t* pin, const float* sched, float* beta,
                 float* trace, int32_t* iters, int32_t* active, float* yc,
                 float* zc, uint32_t* zr, float* u, void* work_v,
                 float* zpart, float* bpart, int B, int L, int M, int T,
                 float P, float n, float inv_sqrt_n, float tol,
                 void* stream) {
  if (!supported(B, L, M) || T < 1 || y_n == nullptr || ns < 0)
    return kBadShape;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* work = static_cast<__nv_bfloat16*>(work_v);
  Support sp;
  sp.mask = mask_c;
  sp.offset = offset;
  sp.word = word;
  sp.block = block;
  sp.ns = ns;
  int rc = encode(y_n, sp, sqo, enc_idx, yc, B, L, M, st);
  if (rc) return rc;
  const float nn = n * n;
  for (int t = 0; t < T; ++t) {
    rc = c1_step<true>(work, nullptr, yc, zc, zr, sp, perm, zpart, bpart,
                       trace, active, B, L, M, t, P, nn, st);
    if (rc) return rc;
    rc = adj_step(zr, row_offset, ns, u, active, B, L, M, t, st);
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
// (B, L, M) bfloat16 scratch holds the H_M stage, and C1's products (its
// strip walk without the residual) run H_L.
int amp_slab_tile(const float* x, void* work_v, float* out, int B, int L,
                  int M, void* stream) {
  if (!supported(B, L, M)) return kBadShape;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* work = static_cast<__nv_bfloat16*>(work_v);
  int rc = rows_hm(x, work, B, L, M, st);
  if (rc) return rc;
  Support none = {};
  return c1_step<false>(work, out, nullptr, nullptr, nullptr, none, nullptr,
                        nullptr, nullptr, nullptr, nullptr, B, L, M, 0, 0.f,
                        0.f, st);
}

// The decode's adjoint alone (R2C2 on every codeword): out (B, L, M) =
// H_L bf16(H_M bf16(z)) from zr (B, ns), z's entries packed as C1 writes
// them (bf16 bits above, the column below) in row-major order, with
// row_offset (L + 1,).
int amp_slab_adjoint(const uint32_t* zr, const int32_t* row_offset, int ns,
                     float* out, int B, int L, int M, void* stream) {
  if (!supported(B, L, M) || ns < 0) return kBadShape;
  return adj_step(zr, row_offset, ns, out, nullptr, B, L, M, 0,
                  static_cast<cudaStream_t>(stream));
}

const char* amp_slab_error_string(int code) {
  if (code == kBadShape) return "unsupported shape";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
