// Row-layered QC-LDPC belief propagation (normalized or offset min-sum),
// the whole decode of each codeword on chip, for Hopper (sm_90a).
//
// Replaces the TPU kernel sparc_ldpc_tpu/ops/bp_qc_pallas.py::_make_kernel
// (its inner `kernel`, launched by bp_decode_qc_pallas).  The contract is
// the reference's: bitwise equal to the plain layered engine
// (sparc_ldpc_tpu_torch/ops/bp_qc.py `bp_decode_qc(schedule="layered")`,
// itself bitwise equal to the JAX XLA engine) in hard decisions, ok flags,
// iteration counts and float32 posteriors.  Per codeword, with the (J, K)
// circulant base matrix (shift s >= 0 active, -1 a zero block) and
// variable order k * Z + zv:
//
//   tot = clip(llr);  mcv = 0                 (check messages, per active
//                                              block, at check coordinates)
//   up to `iters` times, while the syndrome fails:
//     for each layer j:
//       each check zc of the layer, over its active blocks k in order:
//         m_vc_k  = clip(tot[k][(zc + s_jk) % Z] - mcv[j, k][zc])
//         exc_k   = min over the other blocks of |m_vc|   (two-min rule)
//         new_k   = clip(alpha * sign * exc_k)             (min-sum)
//                   clip(sign * max(exc_k - beta, 0))     (offset min-sum)
//         tot[k][(zc + s_jk) % Z] = m_vc_k + new_k;  mcv[j, k][zc] = new_k
//       tot[k] = clip(tot[k]) + 0 at the layer's zero blocks (the XLA
//       engine routes them through a zero-message identity round trip)
//     syndrome of tot < 0; a codeword that passes is frozen
//
// Design.  The TPU kernel kept the (J, K, Z, B) messages and totals in
// VMEM with codewords on the lanes and the circulant shifts as static
// rolls.  Here one thread block holds a few codewords; for each, shared
// memory holds its totals (K Z floats) and the messages of its ACTIVE
// blocks only (14.9 KB per codeword for the z = 31 array code).  A warp
// group of ceil(Z / 32) warps serves one codeword; thread zc is check zc
// of the current layer, and reads and writes tot[k][(zc + s) % Z], which
// no other check of the layer touches (a circulant is a permutation), so
// a layer needs no barrier inside and one barrier after it.  The shifts
// and the per-layer active and zero-block lists are a small device table
// built on the host from the base matrix.  A block stops once all of its
// codewords pass their syndrome.
//
// What bounds it: shared-memory capacity (codewords resident per SM) and
// the layer recurrence, not device-memory bytes, which are one LLR read
// and one posterior write per codeword.  The messages could be compressed
// to (min1, min2, argmin, signs) per check for more residency; that is a
// later step.
//
// Bitwise equality: the additions, subtractions and multiplications that
// form the messages use __fadd_rn / __fsub_rn / __fmul_rn, which nvcc
// never contracts into a fused multiply-add (it may contract plain
// a * b + c at the default -fmad=true, which would round once where the
// reference rounds twice).  The sign is `x < 0` (so -0.0 counts as
// positive, as in the reference) and the clip is min(max(x, -c), c).
//
// Built by sparc_ldpc_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// and called through ctypes (plain C interface below).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBadShape = -1;         // return code for an unsupported shape
constexpr int kMaxPerBlock = 32;      // codewords per block, at most
constexpr int kBlockSmem = 48 * 1024; // shared memory a block aims for
constexpr int kMaxSmem = 227 * 1024;  // shared memory a block may use

__device__ __forceinline__ float clipf(float x, float c) {
  return fminf(fmaxf(x, -c), c);
}

// Table layout (int32): layer_start[J + 1], act_k[nA], act_s[nA],
// zero_start[J + 1], zero_k[nZ].  The active blocks of layer j are
// a in [layer_start[j], layer_start[j + 1]), in increasing k; active block
// a keeps its messages at mcv[a * Z + zc].
__global__ void bp_qc_layered_kernel(
    const float* __restrict__ llr, const int32_t* __restrict__ tab,
    float* __restrict__ tot_out, int32_t* __restrict__ iters_out,
    int32_t* __restrict__ ok_out, int B, int J, int K, int Z, int nA,
    int max_iters, int oms, float alpha, float beta, float clip, int cpb,
    int tpc) {
  extern __shared__ float smem[];
  __shared__ int s_done[kMaxPerBlock], s_bad[kMaxPerBlock],
      s_iters[kMaxPerBlock];
  const int n = K * Z;
  const int c = threadIdx.x / tpc, zc = threadIdx.x % tpc;
  const int b = blockIdx.x * cpb + c;
  const bool cw = b < B;           // the thread serves a real codeword
  const bool chk = cw && zc < Z;   // and one of its Z checks per layer
  float* tot = smem + (size_t)c * (n + nA * Z);
  float* mcv = tot + n;
  const int32_t* layer_start = tab;
  const int32_t* act_k = layer_start + J + 1;
  const int32_t* act_s = act_k + nA;
  const int32_t* zero_start = act_s + nA;
  const int32_t* zero_k = zero_start + J + 1;

  if (cw) {
    for (int i = zc; i < n; i += tpc)
      tot[i] = clipf(llr[(size_t)b * n + i], clip);
    for (int i = zc; i < nA * Z; i += tpc) mcv[i] = 0.f;
  }
  if (threadIdx.x < cpb) {
    s_done[threadIdx.x] = blockIdx.x * cpb + (int)threadIdx.x >= B;
    s_bad[threadIdx.x] = 0;
    s_iters[threadIdx.x] = 0;
  }
  __syncthreads();

  for (int it = 0; it < max_iters; ++it) {
    const bool done = s_done[c];
    if (__syncthreads_and(done)) break;
    for (int j = 0; j < J; ++j) {
      if (chk && !done) {
        const int a0 = layer_start[j], a1 = layer_start[j + 1];
        float min1 = INFINITY, min2 = INFINITY;
        int nneg = 0;
        for (int a = a0; a < a1; ++a) {
          int p = zc + act_s[a];
          if (p >= Z) p -= Z;
          const float mv =
              clipf(__fsub_rn(tot[act_k[a] * Z + p], mcv[a * Z + zc]), clip);
          const float mag = fabsf(mv);
          nneg += mv < 0.f;
          if (a == a0) {
            min1 = mag;
          } else {
            const bool is_new = mag < min1;
            min2 = is_new ? min1 : fminf(min2, mag);
            min1 = fminf(min1, mag);
          }
        }
        const float sign_prod = (nneg & 1) ? -1.f : 1.f;
        for (int a = a0; a < a1; ++a) {
          int p = zc + act_s[a];
          if (p >= Z) p -= Z;
          float* t = tot + act_k[a] * Z + p;
          float* m = mcv + a * Z + zc;
          const float mv = clipf(__fsub_rn(*t, *m), clip);
          const float mag = fabsf(mv);
          const float s = sign_prod * (mv < 0.f ? -1.f : 1.f);  // exact
          const float exc = mag == min1 ? min2 : min1;
          float nc;
          if (oms)
            nc = __fmul_rn(s, fmaxf(__fsub_rn(exc, beta), 0.f));
          else
            nc = __fmul_rn(__fmul_rn(alpha, s), exc);
          nc = clipf(nc, clip);
          *t = __fadd_rn(mv, nc);
          *m = nc;
        }
        for (int i = zero_start[j]; i < zero_start[j + 1]; ++i) {
          float* t = tot + zero_k[i] * Z + zc;
          *t = __fadd_rn(clipf(*t, clip), 0.f);
        }
      }
      __syncthreads();
    }
    if (chk && !done) {
      int bad = 0;
      for (int j = 0; j < J && !bad; ++j) {
        int par = 0;
        for (int a = layer_start[j]; a < layer_start[j + 1]; ++a) {
          int p = zc + act_s[a];
          if (p >= Z) p -= Z;
          par ^= tot[act_k[a] * Z + p] < 0.f;
        }
        bad = par;
      }
      if (bad) s_bad[c] = 1;
    }
    __syncthreads();
    if (cw && zc == 0 && !done) {
      s_iters[c] += 1;
      s_done[c] = !s_bad[c];
      s_bad[c] = 0;
    }
    __syncthreads();
  }
  if (cw) {
    for (int i = zc; i < n; i += tpc) tot_out[(size_t)b * n + i] = tot[i];
    if (zc == 0) {
      iters_out[b] = s_iters[c];
      ok_out[b] = s_done[c];
    }
  }
}

}  // namespace

extern "C" {

// Layered min-sum (method 0) or offset min-sum (method 1) for B codewords
// of n = K * Z bits.  llr (B, n) float32; tab the int32 table described
// above, with nA active and nZ zero blocks over the J layers.  Outputs:
// tot (B, n) float32 posteriors, iters (B,) and ok (B,) int32.
// Returns 0, a cudaError_t, or -1 for an unsupported shape.
int bp_qc_layered_run(const float* llr, const int32_t* tab, float* tot,
                      int32_t* iters, int32_t* ok, int B, int J, int K, int Z,
                      int nA, int nZ, int max_iters, int method, float alpha,
                      float beta, float clip, void* stream) {
  if (B < 1 || J < 1 || K < 1 || Z < 1 || Z > 1024 || nA < 1 ||
      nA + nZ != J * K || max_iters < 0 || (method != 0 && method != 1))
    return kBadShape;
  const int tpc = (Z + 31) / 32 * 32;           // threads per codeword
  const long per_cw = (long)(K * Z + nA * Z) * (long)sizeof(float);
  if (per_cw > kMaxSmem) return kBadShape;
  int cpb = (int)(kBlockSmem / per_cw);
  if (cpb < 1) cpb = 1;
  if (cpb > kMaxPerBlock) cpb = kMaxPerBlock;
  if (cpb > 1024 / tpc) cpb = 1024 / tpc;
  const int smem = (int)(cpb * per_cw);
  int rc = (int)cudaFuncSetAttribute(
      bp_qc_layered_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (rc) return rc;
  const int grid = (B + cpb - 1) / cpb;
  bp_qc_layered_kernel<<<grid, cpb * tpc, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      llr, tab, tot, iters, ok, B, J, K, Z, nA, max_iters, method, alpha,
      beta, clip, cpb, tpc);
  return (int)cudaGetLastError();
}

const char* bp_qc_layered_error_string(int code) {
  if (code == kBadShape) return "unsupported shape";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
