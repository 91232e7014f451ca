// Sectionwise posterior-mean softmax denoiser, for Hopper (sm_90a).
//
// Replaces the TPU kernel sparc_ldpc_tpu/ops/denoiser.py::_denoise_kernel
// (launched by denoise_pallas, the scan AMP's denoiser on the reference's
// --pallas route).  For every section row (b, l) of M columns:
//
//   a    = sq[l] * s[b, l, :] / tau2[b]        (multiply, then divide, as
//                                               the reference computes it)
//   post = exp(a - max(a)) / sum(exp(a - max(a)))
//   beta = sq[l] * post
//
// What bounds it: device-memory bytes.  It reads s once and writes beta
// and post once, 12 bytes per element and one flop-light pass; the TPU
// kernel tiled (L_tile, M) blocks into VMEM for the same single pass.
// Here one warp owns one row: each lane holds M / 32 values in registers
// (a row never leaves the SM), the loads and stores are coalesced (lane i
// touches column 32 k + i), and the max and the sum are xor-shuffle trees,
// so a row needs no shared memory and no barrier.  Eight rows per
// 256-thread block.
//
// Determinism: no atomics; the reductions are fixed-order trees, so the
// same inputs give bitwise-identical outputs.  Arithmetic: the explicit
// roundings (__fmul_rn, __fdiv_rn) keep nvcc from contracting the
// multiply-divide, and expf is the precise one (no fast-math), so the
// kernel differs from its plain PyTorch version (ops/denoiser.py denoise)
// only in expf's last bits and the sums' order.
//
// Built by sparc_ldpc_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// and called through ctypes (plain C interface below).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;              // threads per block
constexpr int kRowsPerBlock = kThreads / 32;
constexpr int kBadShape = -1;              // return code for an unsupported shape

template <bool IS_MAX>
__device__ __forceinline__ float warp_reduce(float x) {
  // xor tree: partners combine the same two values, so every lane ends with
  // the same bits
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, x, m);
    x = IS_MAX ? fmaxf(x, o) : x + o;
  }
  return x;
}

template <int M>
__global__ void __launch_bounds__(kThreads)
denoise_kernel(const float* __restrict__ s, const float* __restrict__ tau2,
               const float* __restrict__ sq, float* __restrict__ beta,
               float* __restrict__ post, int L, long long rows) {
  constexpr int V = M / 32;  // values per lane
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // uniform per warp
  const int b = (int)(row / L), l = (int)(row % L);
  const float t = tau2[b], q = sq[l];
  const size_t base = (size_t)row * M + lane;
  float a[V];
  float mx = -INFINITY;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    a[k] = __fdiv_rn(__fmul_rn(q, s[base + 32 * k]), t);
    mx = fmaxf(mx, a[k]);
  }
  mx = warp_reduce<true>(mx);
  float se = 0.f;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    a[k] = expf(a[k] - mx);
    se += a[k];
  }
  se = warp_reduce<false>(se);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const float p = __fdiv_rn(a[k], se);
    post[base + 32 * k] = p;
    beta[base + 32 * k] = __fmul_rn(q, p);
  }
}

template <int M>
int launch(const float* s, const float* tau2, const float* sq, float* beta,
           float* post, int L, long long rows, cudaStream_t st) {
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  denoise_kernel<M><<<(unsigned)blocks, kThreads, 0, st>>>(s, tau2, sq, beta,
                                                          post, L, rows);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// beta, post (B, L, M) from s (B, L, M), tau2 (B,), sq (L,), all float32
// and contiguous; M a power of two in [32, 1024].  Returns 0, a
// cudaError_t, or -1 for an unsupported shape.
int denoise_run(const float* s, const float* tau2, const float* sq,
                float* beta, float* post, int B, int L, int M, void* stream) {
  if (B < 1 || L < 1) return kBadShape;
  const long long rows = (long long)B * L;
  if ((rows + kRowsPerBlock - 1) / kRowsPerBlock > 0x7fffffffLL)
    return kBadShape;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (M) {
    case 32: return launch<32>(s, tau2, sq, beta, post, L, rows, st);
    case 64: return launch<64>(s, tau2, sq, beta, post, L, rows, st);
    case 128: return launch<128>(s, tau2, sq, beta, post, L, rows, st);
    case 256: return launch<256>(s, tau2, sq, beta, post, L, rows, st);
    case 512: return launch<512>(s, tau2, sq, beta, post, L, rows, st);
    case 1024: return launch<1024>(s, tau2, sq, beta, post, L, rows, st);
    default: return kBadShape;
  }
}

const char* denoise_error_string(int code) {
  if (code == kBadShape) return "unsupported shape";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
