// The slab AMP kernel's stage ablation (S4), for Hopper (sm_90a).
//
// Replaces the TPU kernels of scripts/slab_ablation.py (make_kernel,
// make_compact_kernel, make_pair_kernel): the slab form's decode
// (sparc_ldpc_tpu/ops/amp_kernel.py::_amp_kernel_slab, K7) at T fixed
// iterations on an observation y given (no encode of a codeword, no noise,
// no early stop, no pins), with one stage removed or changed.
//
// Every variant is K7 as it is (amp_slab.cu: its row-support design and
// scale-free form), with one thing changed: K1's compact encode of y on
// the row support, then per iteration K7's three launches, C1
// (slab_c1_kernel), R2C2 (slab_adj_kernel) and R3 (slab_row_kernel), from
// amp_k7.cuh at a compile-time variant.  "full" is K7's own instantiation,
// so its decode is amp_fused(..., form="slab") at fixed T with y given, bit
// for bit.  In the scale-free form (ops/amp_kernel.py)
//
//   z     = y - mask/n * H(beta') + coef * z,  coef = (P - |beta'|^2/n^2)/tau2_prev
//   tau2  = |z|^2 / n
//   beta' = sqo * softmax_row((sqi / tau2) * (H(z) + beta')),  beta = beta' / sqrt(n)
//
// with H = H_L bf16(H_M bf16(.)), H_M = H_{m_a} (x) H_{m_b} (R3: X H_{m_b}
// on the tensor cores, then float32 butterflies), H_L = H_{f_a} (x) H_{f_b}
// (C1 and R2C2: H_{f_b} on the tensor cores, then butterflies); the
// adjoint's H_M is R2C2's closed form from the support entries (no
// H_{m_a} butterflies and no H_{m_b} product: a variant that changes
// those leaves that launch as K7's).  The script's scaling (beta in true
// scale, a 0/1 mask) has nothing left to fold here: K7 already folds
// 1 / sqrt(n) into mask / n and beta'.
//
// Per variant: what it changes in C1, R2C2 and R3 ("K7" where the launch
// is K7's), its launches an iteration (3 for every variant, after one
// encode launch), and its bound (chip_smoke.py slab_exp_bound: y, mask
// and sq read once, beta and the trace written once; 2 T - 1 transforms of
// log2(L M) = 19 float32 butterfly adds an element, 12 other operations an
// element and iteration; 12.7 ms at B = 1024, T = 32).  Decoding variants
// compute full's function and have its bound; the ablated ones are bounded
// by what they keep (no_radix and no_mm keep R2C2's whole closed-form H_M).
//   variant     C1                      R2C2                 R3                        bound
//   full        K7                      K7                   K7                        12.7
//   fold        K7 (nothing to fold)    K7                   K7                        12.7
//   fold_hfb    H_{f_b} +-bf16(1/sqrt n), K7                 K7                        12.7
//               mask entries mask/sqrt n
//   no_trace    tau2 in two rows        K7                   tau2 in two rows, no trace 12.7
//   exp2        K7                      K7                   exp2f(x log2 e)           12.7
//   bf16_radix  H_{f_a} on bf16         H_{f_a} on bf16      H_{m_a} on bf16           12.7
//   midbf16     K7                      K7 (no H_{m_b} product) H_{m_b} rounded, H_{m_a} bf16 12.7
//   f128m256    K7                      K7                   m_b = 256 products        12.7
//   f128m512    K7                      K7                   m_b = 512 products        12.7
//   f256m128    f_b = 256, two tile pairs a warp (32 warps)  K7 at 256-row slabs        12.7
//   f64m128     f_b = 64, 16 warps      f_b = 64             K7 at 64-row slabs        12.7
//   pair        K7                      two codewords an item two codewords a block     12.7
//   no_radix    no H_{f_a}              no H_{f_a} (H_M K7's) no H_{m_a}                10.7
//   no_mm       no H_{f_b} products     no H_{f_b} products  no H_{m_b} products        7.4
//   no_softmax  K7                      K7                   no max, exp or sums       11.6
//   no_consume  z = H(beta') (no y, mask/n, z reads)  K7     as no_softmax             10.9
//   sched       no |z|^2 partials       K7                   tau2 = 0.36 (K7's schedule) 12.2
//   fold_sched  as sched                as sched             as sched                  12.2
//   compact     slabs summed, H_{f_b}[0:128, :]  rows 0:128, H_{f_b}[:, 0:128], one slab  u's one slab to every slab  6.4
//   compact32   slabs summed, H_{f_b}[0:32, :]   rows 0:32, H_{f_b}[:, 0:32], one slab    as compact                  6.2
// The pair keeps C1 K7's: its two 80 KB strip buffers (this item's and the
// prefetched next one's) and staged entries fill the SM (208 KB), so two
// codewords an item would cost C1 its prefetch.  R2C2's pair builds both
// strips (160 KB) and reads the entries from device memory (the same
// values in the same order as K7's staged ones).  Its bits are full's for
// every codeword; its trace holds every codeword (the wrapper keeps the
// first of each pair, as the script stores).  The compact layouts need the
// support compact_mask(L, M, n), the first n entries of N-space (rows
// 0 .. ceil(n / M) - 1): no real operator has it, so they are for timing.
//
// A run may resume from a state (beta', z, |beta'|^2, tau2) and keep its
// own: one launch of K7's slab_hm_kernel over beta' first rebuilds the work
// tile (variants whose R3 runs K7's H_M only).  That lets a check start an
// ablated variant from a decoded state (no_consume from beta' = 0 is NaN
// throughout, as the script's: its first tau2 is 0).
//
// Shapes: L = 1024, M = 512 (the script's), B up to 65535 (even for pair).
// Determinism: no float atomics; per-codeword sums are fixed-order trees in
// a block and a fixed-order pass over the per-block partials.
//
// Built by sparc_ldpc_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// and called through ctypes (plain C interface below).

#include <string.h>

#include "amp_k1.cuh"
#include "amp_k7.cuh"

namespace {

// the variants, in the order of ops/amp_slab_exp.py MODES
enum Mode {
  kFull, kNoRadix, kNoMm, kNoSoftmax, kNoConsume, kBf16Radix, kMidBf16,
  kFold, kFoldSched, kFoldHfb, kNoTrace, kExp2, kSched, kCompact, kPair,
  kF128M256, kF128M512, kF256M128, kF64M128, kCompact32, kModes
};

constexpr int kL = 1024, kM = 512;  // the script's shape
constexpr int kW = 32, kR = 32;     // K1's column geometry at L = 1024

// K7's column geometry at L = 1024, and the factorings'
using G128 = SlabGeo<128, 8, 1>;
using G256 = SlabGeo<256, 4, 1, 2>;
using G64 = SlabGeo<64, 16, 1>;

// Arguments of the iteration loop (see amp_slab_exp_run).
struct RunArgs {
  const float* y_n;
  Support sp;
  const int32_t *perm, *row_offset;
  const float *sqi, *sqo, *sched;
  float *beta, *trace;
  int32_t *iters, *active;
  float *yc, *zc;
  uint32_t* zr;
  float* u;
  __nv_bfloat16* work;
  float *zpart, *bpart;
  int B, t0, T, keep;
  float P, n, inv_sqrt_n;
  uint32_t hpos;
};

// K1's compact encode of y on the row support, a resumed run's work tile,
// then iterations t0 .. t0 + T - 1 of K7's three launches: C1 at variant
// CV, R2C2 at AV, R3 at RV with m_b = MB, on the column geometry G (slabs
// of G::FB rows).  The last iteration writes the true-scale beta unless
// the state is kept.
template <class G, int CV, int AV, int RV, int MB = 128>
int run_s4(const RunArgs& a, cudaStream_t st) {
  using K = SlabCols<G>;
  const float nn = a.n * a.n;
  int rc = k1_encode_launch<kW, kR, 1>(a.y_n, a.sp, a.sqo, nullptr, nullptr,
                                       0.f, a.yc, a.B, kM, st);
  if (!rc && a.t0 > 0) {
    slab_hm_kernel<kM><<<dim3(kL / kTile, a.B), SlabRows<kM>::THREADS, 0,
                         st>>>(a.beta, a.work, kL);
    rc = (int)cudaGetLastError();
  }
  for (int t = a.t0; t < a.t0 + a.T && !rc; ++t) {
    const int last = !a.keep && t == a.t0 + a.T - 1;
    rc = K::template c1<true, CV>(a.work, nullptr, a.yc, a.zc, a.zr, a.sp,
                                  a.perm, a.zpart, a.bpart, a.trace, a.active,
                                  a.B, kM, t, a.P, nn, st, a.hpos);
    if (rc) break;
    rc = K::template adj<AV>(a.zr, a.row_offset, a.sp.ns, a.u, a.active, a.B,
                             kM, t, st);
    if (rc) break;
    rc = slab_row_launch<kM, RV, MB>(
        a.u, a.beta, a.work, a.zpart, a.bpart, a.trace, a.iters, a.active,
        nullptr, a.sched, a.sqi, a.sqo, a.B, kL, G::FB, t, last, a.n,
        a.inv_sqrt_n, 0.f, st);
  }
  return rc;
}

// the variants that can resume: their R3 runs K7's H_M (m_b = 128, float32
// butterflies), which rebuilds the work tile from beta'
bool resumes(int mode) {
  switch (mode) {
    case kNoRadix: case kNoMm: case kBf16Radix: case kMidBf16:
    case kF128M256: case kF128M512: case kCompact: case kCompact32:
      return false;
    default:
      return true;
  }
}

int dispatch(int mode, const RunArgs& a, cudaStream_t st) {
  switch (mode) {
    case kFull:
    case kFold: return run_s4<G128, kK7, kK7, kK7>(a, st);
    case kNoRadix:
      return run_s4<G128, kK7NoRadix, kK7NoRadix, kK7NoRadix>(a, st);
    case kNoMm: return run_s4<G128, kK7NoMm, kK7NoMm, kK7NoMm>(a, st);
    case kNoSoftmax: return run_s4<G128, kK7, kK7, kK7NoSoftmax>(a, st);
    case kNoConsume:
      return run_s4<G128, kK7NoConsume, kK7, kK7NoConsume>(a, st);
    case kBf16Radix:
      return run_s4<G128, kK7Bf16Radix, kK7Bf16Radix, kK7Bf16Radix>(a, st);
    case kMidBf16: return run_s4<G128, kK7, kK7, kK7MidBf16>(a, st);
    case kFoldSched:
    case kSched: return run_s4<G128, kK7Sched, kK7, kK7>(a, st);
    case kFoldHfb: return run_s4<G128, kK7FoldHfb, kK7, kK7>(a, st);
    case kNoTrace: return run_s4<G128, kK7NoTrace, kK7, kK7NoTrace>(a, st);
    case kExp2: return run_s4<G128, kK7, kK7, kK7Exp2>(a, st);
    case kCompact:
      return run_s4<G128, kK7Compact, kK7Compact, kK7Compact>(a, st);
    case kCompact32:
      return run_s4<G128, kK7Compact32, kK7Compact32, kK7Compact>(a, st);
    case kPair:
      if (a.B % 2) return kBadShape;
      return run_s4<G128, kK7, kK7Pair, kK7Pair>(a, st);
    case kF128M256: return run_s4<G128, kK7, kK7, kK7, 256>(a, st);
    case kF128M512: return run_s4<G128, kK7, kK7, kK7, 512>(a, st);
    case kF256M128: return run_s4<G256, kK7, kK7, kK7>(a, st);
    case kF64M128: return run_s4<G64, kK7, kK7, kK7>(a, st);
    default: return kBadShape;
  }
}

}  // namespace

extern "C" {

// Variant `mode` (the order of ops/amp_slab_exp.py MODES) for B codewords,
// iterations t0 .. t0 + T - 1 on K7's design at L = 1024, M = 512.  Inputs:
// y_n (B, L, M) the observation, read on the row support only; the row
// support as K7 takes it (ops/split_support.py, ns entries in K1's order):
// mask_c (ns,) each entry's mask/n (fold_hfb: mask / sqrt(n)), offset and
// word (L / 32, M), block (M / 32 + 1,), perm (ns,), row_offset (L + 1,);
// sqi, sqo (L,) sq / sqrt(n), sq sqrt(n); sched (t0 + T,) the sched
// variants' tau2, else null.  Outputs: beta (B, L, M), true scale after the
// last iteration (beta' when keep = 1); trace (t0 + T, B) (no_trace: (2, B)
// rows t % 2).  Scratch: iters (B,), active (t0 + T + 1, B) int32 all ones;
// yc, zc (B, ns) float, zr (B, ns) uint32; u (B, L, M) float (compact:
// (B, f_b, M)); work (B, L, M) bfloat16; zpart (B, L / f_b, M / 32); bpart
// (B, L / f_b).  t0 = 0 starts from beta' = 0; t0 >= 1 resumes from the
// state in beta (beta'), zc, bpart (whose row sums, in order, are
// |beta'|^2) and trace row t0 - 1 (the last tau2).  hscale: fold_hfb's
// H_{f_b} entries are +-bf16(hscale).  Returns 0, a cudaError_t, or -1 for
// an unsupported shape or variant.
int amp_slab_exp_run(int mode, const float* y_n, const float* mask_c,
                     const int32_t* offset, const uint32_t* word,
                     const int32_t* block, const int32_t* perm,
                     const int32_t* row_offset, int ns, const float* sqi,
                     const float* sqo, const float* sched, float* beta,
                     float* trace, int32_t* iters, int32_t* active, float* yc,
                     float* zc, uint32_t* zr, float* u, void* work,
                     float* zpart, float* bpart, int B, int L, int M, int t0,
                     int T, int keep, float P, float n, float inv_sqrt_n,
                     float hscale, void* stream) {
  if (L != kL || M != kM || B < 1 || B > 65535 || T < 1 || t0 < 0 ||
      ns < 0 || mode < 0 || mode >= kModes)
    return kBadShape;
  if (t0 > 0 && !resumes(mode)) return kBadShape;
  RunArgs a;
  a.y_n = y_n;
  a.sp.mask = mask_c;
  a.sp.offset = offset;
  a.sp.word = word;
  a.sp.block = block;
  a.sp.ns = ns;
  a.perm = perm;
  a.row_offset = row_offset;
  a.sqi = sqi;
  a.sqo = sqo;
  a.sched = sched;
  a.beta = beta;
  a.trace = trace;
  a.iters = iters;
  a.active = active;
  a.yc = yc;
  a.zc = zc;
  a.zr = zr;
  a.u = u;
  a.work = static_cast<__nv_bfloat16*>(work);
  a.zpart = zpart;
  a.bpart = bpart;
  a.B = B;
  a.t0 = t0;
  a.T = T;
  a.keep = keep;
  a.P = P;
  a.n = n;
  a.inv_sqrt_n = inv_sqrt_n;
  // the bf16 bits (round to nearest even) of the finite hscale
  uint32_t bits;
  memcpy(&bits, &hscale, sizeof(bits));
  a.hpos = (bits + 0x7FFFu + ((bits >> 16) & 1u)) >> 16;
  return dispatch(mode, a, static_cast<cudaStream_t>(stream));
}

const char* amp_slab_exp_error_string(int code) {
  if (code == kBadShape) return "unsupported shape or variant";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
