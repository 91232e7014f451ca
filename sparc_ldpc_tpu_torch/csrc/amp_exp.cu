// The split AMP kernel's experiments, for Hopper (sm_90a): stage ablation,
// other factorings of H_L, and two codewords per block.
//
// Replaces the TPU kernels of three timing scripts, each a variant of the
// split fused AMP decode (sparc_ldpc_tpu/ops/amp_kernel.py::
// _amp_kernel_split, whose Hopper port is K1, amp_split.cu):
//   S2 scripts/kernel_ablation.py::make_kernel (one stage made near-free),
//   S3 scripts/lstage_exp.py::make_kernel (H_L factored otherwise),
//   S1 scripts/pair_kernel_exp.py::_amp_kernel_split_pair (two codewords a
//      program, their stages interleaved).
// All run T fixed iterations on an observation y given (no encode, no
// noise, no early stop, no pins), in the scripts' scaling (ops/amp_exp.py):
//
//   coef = (P - |beta|^2 / n) / tau2_prev          (0 at t = 0)
//   z    = mask (y - H(beta) / sqrt(n)) + coef z   (mask 0/1, bf16)
//   tau2 = |z|^2 / n
//   beta = sq softmax_row((sq / tau2) (H(z) / sqrt(n) + beta))
//
// Every variant is K1's design with one thing changed: the state (beta, z)
// lives in device memory and an iteration is two launches over the batch,
//   column stage: one block per (codeword, 32-column strip) holds the
//     (L, 32) strip: H_L of the forward transform (its H_M came from the
//     row stage through the work tile), the residual and Onsager term, the
//     strip's |z|^2, then H_L of the adjoint into the work tile;
//   row stage: H_M of the adjoint, + beta, the row softmax, the row's
//     |beta|^2, then H_M of the next forward transform into the work tile.
// So the adjoint applies H_L before H_M and rounds between them, where the
// scripts apply H_M first (as K1 against its reference); the forward
// rounds before and after H_M as the scripts do, not between H_L's
// factors.  The work tile is bf16 (the scripts' bf16 operands); with
// round_bf16 = 0 the K1-style variants keep it float32 and round nothing.
// Their garbage decodes amplify rounding noise, so the ablated variants
// are held in bf16 to the plain version rounded where they round
// (ops/amp_exp.py, order="kernel").  Shapes: L = 1024, M = 512 (the
// scripts'), any B up to 65535 (even for "pair").
//
// Per variant: what changes against K1, launches an iteration, and the
// bound (the least time for the function: inputs y, mask, sq read once, beta
// and the trace written once, 8 bytes an element; the least operations the
// function needs at the H100's peak, 67 TFLOP/s float32; at B = 512, T =
// 32, E = B L M = 2.68e8 elements, bytes 0.64 ms).  Every decoding variant
// (full, S3's, the pair) computes full's function and has full's bound;
// the ablated ones compute other functions, bounded by what they keep.
// Every variant moves about 7 float32-equivalent (B, L, M) passes an
// iteration, as K1 does.
//   full          K1's iteration, in the scripts' scaling; 2 launches.
//                 Transforms (2T - 1) log2(L M) float32 adds an element,
//                 12 other operations an element and iteration: 6.3 ms.
//   no_transform  no H_L and no H_M: the column stage reads beta and the
//                 row stage reads z in place of the work tile (same
//                 bytes); 2 launches; 12 T E float32: 1.5 ms.
//   m_stage_only  no H_L: the column stage passes the work tile through;
//                 2 launches; transforms (2T - 1) log2(M): 3.8 ms.
//   no_softmax    beta = s (sq / tau2) 1e-3: no max, exp or sums in the row
//                 stage; 2 launches; 8 other operations: 5.9 ms.
//   no_max        the softmax without its row max (exp overflows); 2
//                 launches; 10 other operations: 6.1 ms.
//   no_norms      coef = 0.1 and tau2 = 0.5: no |beta|^2 or |z|^2 partials
//                 and no pass over them; 2 launches; 10 other: 6.1 ms.
//   pair          full with two codewords per row-stage block, each phase
//                 (load, H_M, max, exp, sum, store, H_M) issued for both
//                 before the next; the column stage stays one codeword a
//                 block: two (L, 32) float32 strips (2 x 128 KB) exceed a
//                 block's 227 KB of shared memory.  Its trace holds the
//                 first codeword of each pair; 2 launches; bound as full.
//   S3 column stage (all S3 variants): H_L = H_{f_a} (x) H_{f_b}, H_{f_b}
//                 on the tensor cores (mma.sync m16n8k16, bf16 strip data
//                 from shared memory the B operand, +-1 fragments from
//                 popcount parity the A operand, as K7's column stage), 16
//                 warps a block, the strip's bf16 tile and the rounded z
//                 in two shared tiles (160 KB); the row stage is K1's.
//                 Bound: full's, 6.3 ms.  Their dense products compute 2 f
//                 bf16 flops an element and transform a factor H_f (at
//                 989 TFLOP/s, (2T - 1) E 2 f bf16 flops take 0.034 f ms).
//   slab_loop     f_b = 128; each slab's H_128 stored rounded to bf16 in
//                 shared memory, slabs in a loop that is not unrolled, then
//                 H_8 across the slabs also on mma.sync (m16n8k8, the
//                 slabs the K axis); 2 launches; 272 flops an element.
//   slab_unroll   as slab_loop, the slab loop unrolled.
//   slab_batched  as slab_loop, every slab's products issued before any
//                 is stored.
//   f128_vpu8     H_128 on mma.sync, H_8 float32 butterflies on the
//                 accumulators (unrounded); 2 launches; 256 flops.
//   f256_vpu4     H_256 on mma.sync, H_4 butterflies; 512 flops.
//   f512_vpu2     H_512 on mma.sync, H_2 butterflies; 1024 flops.
//   l256_m128     as f256_vpu4, and the row stage's H_M = H_4 (x) H_128
//                 with H_128 on mma.sync (amp_mma.cuh slab_hm, 16 rows a
//                 block) and H_4 float32; 2 launches; 768 flops.
//
// Determinism: no float atomics; per-codeword sums are fixed-order trees
// in a block plus a fixed-order pass over the per-block partials.
//
// Built by sparc_ldpc_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// and called through ctypes (plain C interface below).

#include "amp_common.cuh"
#include "amp_mma.cuh"

namespace {

// the variants, in the order of ops/amp_exp.py MODES
enum Mode {
  kFull, kNoSoftmax, kNoMax, kNoTransform, kMStageOnly, kNoNorms,
  kSlabLoop, kSlabUnroll, kSlabBatched, kF512Vpu2, kF256Vpu4, kF128Vpu8,
  kL256M128, kPair, kModes
};

constexpr int kL = 1024, kM = 512;     // the scripts' shape
constexpr int kW = 32, kR = 32;        // K1's column stage at L = 1024
constexpr int kRowThreads = 256;       // threads of a K1-style row block
constexpr int kNS = kM / kStrip;       // |z|^2 partials per codeword
constexpr int kLWarps = 16;            // warps of an S3 column block
constexpr int kLThreads = 32 * kLWarps;

__device__ __forceinline__ float mask_at(const __nv_bfloat16* mask, int l,
                                         int m, int M = kM) {
  return to_f32(mask[(size_t)l * M + m]);
}

// coef of iteration t from the row partials of |beta|^2 (every thread gets
// it); 0 at t = 0, where beta = 0 and z = 0.
template <int NW>
__device__ __forceinline__ float onsager(const float* bpart,
                                         const float* tau2s, float* red,
                                         int B, int b, int t, float P,
                                         float n) {
  if (t == 0) return 0.f;
  float acc = 0.f;
  for (int l = threadIdx.x; l < kL; l += 32 * NW)
    acc += bpart[(size_t)b * kL + l];
  const float bnorm2 = block_sum<NW>(acc, red);
  return (P - bnorm2 / n) / tau2s[(size_t)(t - 1) * B + b];
}

// z of element (l, m) of codeword base: mask (y - w / sqrt(n)) + coef z,
// stored; returns it.
__device__ __forceinline__ float residual(const float* y, float* z,
                                          const __nv_bfloat16* mask,
                                          size_t base, int l, int m, float w,
                                          float coef, int t,
                                          float inv_sqrt_n, int M = kM) {
  const size_t off = base + (size_t)l * M + m;
  float zk = mask_at(mask, l, m, M) * (y[off] - w * inv_sqrt_n);
  if (t > 0) zk += coef * z[off];
  z[off] = zk;
  return zk;
}

// ------------------------------------------------ K1-style column stage
//
// K1's layouts (amp_common.cuh): thread (w, c) of 32 W holds R values of
// column c, layout A rows w + W k, layout B rows R w + k.  RTM takes the
// row length M from m_arg at run time, as K1 does (otherwise it is the
// compile-time kM: every offset of the unrolled register loops is then an
// immediate), a diagnostic of the full variant against K1.

template <int MODE, typename WT, bool RTM>
__global__ void __launch_bounds__(32 * kW, 1)
exp_col_kernel(WT* __restrict__ work, const float* __restrict__ beta,
               const float* __restrict__ y, float* __restrict__ z,
               const __nv_bfloat16* __restrict__ mask,
               float* __restrict__ zpart,        // (B, M / 32)
               const float* __restrict__ bpart,  // (B, L) row |beta|^2
               const float* __restrict__ tau2s,  // (T, B)
               int B, int t, float P, float n, float inv_sqrt_n, int m_arg) {
  extern __shared__ float sm[];
  __shared__ float red[kW];
  constexpr bool NORMS = MODE != kNoNorms;
  constexpr bool DIRECT = MODE == kNoTransform;  // no work tile at all
  constexpr bool HL = !DIRECT && MODE != kMStageOnly;
  constexpr int kRound = IsBf16<WT>::value;
  const int M = RTM ? m_arg : kM;
  const int w = threadIdx.x >> 5, c = threadIdx.x & 31;
  const int b = blockIdx.y, m = blockIdx.x * kStrip + c;
  const size_t base = (size_t)b * kL * M;
  const float coef =
      NORMS ? onsager<kW>(bpart, tau2s, red, B, b, t, P, n) : 0.1f;
  float v[kR];
  if (t > 0) {
    if constexpr (HL) {
#pragma unroll
      for (int k = 0; k < kR; ++k)
        v[k] = to_f32(work[base + (size_t)(w + kW * k) * M + m]);
      col_fwht_ab<kW, kR, 1>(v, sm, w, c, 0);
    } else {
#pragma unroll
      for (int k = 0; k < kR; ++k) {
        const size_t off = base + (size_t)(kR * w + k) * M + m;
        v[k] = DIRECT ? beta[off] : to_f32(work[off]);
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < kR; ++k) v[k] = 0.f;
  }
  float zz = 0.f;
#pragma unroll
  for (int k = 0; k < kR; ++k) {
    const float zk = residual(y, z, mask, base, kR * w + k, m, v[k], coef,
                              t, inv_sqrt_n, M);
    zz += zk * zk;
    v[k] = maybe_round(zk, kRound);
  }
  if constexpr (NORMS) {
    const float zsum = block_sum<kW>(zz, red);
    if (threadIdx.x == 0) zpart[(size_t)b * gridDim.x + blockIdx.x] = zsum;
  }
  if constexpr (HL) {
    col_fwht_ba<kW, kR, 1>(v, sm, w, c, 0);
#pragma unroll
    for (int k = 0; k < kR; ++k)
      work[base + (size_t)(w + kW * k) * M + m] = from_f32<WT>(v[k]);
  } else if constexpr (!DIRECT) {
#pragma unroll
    for (int k = 0; k < kR; ++k)
      work[base + (size_t)(kR * w + k) * M + m] = from_f32<WT>(v[k]);
  }
}

// --------------------------------------------------- K1-style row stage
//
// A section row of M columns is handled by TPR = M / 4 threads with 4
// adjacent columns each (amp_split.cu); a block of 256 threads holds RPB
// rows of C codewords (C = 2: the pair), and every phase runs for all C
// before the next.

constexpr int kTPR = kM / 4, kRPB = kRowThreads / kTPR;

// H_M of the C rows this thread's row group holds (amp_split.cu row_fwht
// for C codewords); srow points at the row's C * M floats of scratch.
template <int C>
__device__ __forceinline__ void row_fwht_c(float (&v)[C][4], float* srow,
                                           int j) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float a = v[c][0] + v[c][1], b = v[c][0] - v[c][1];
    const float d = v[c][2] + v[c][3], e = v[c][2] - v[c][3];
    v[c][0] = a + d;
    v[c][1] = b + e;
    v[c][2] = a - d;
    v[c][3] = b - e;
  }
#pragma unroll
  for (int mk = 1; mk < 32; mk <<= 1) {
    const bool hi = (j & mk) != 0;
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float o = __shfl_xor_sync(0xffffffffu, v[c][i], mk);
        v[c][i] = hi ? o - v[c][i] : v[c][i] + o;
      }
    }
  }
  // bits 7 and 8 of the column span the row's four warps
  __syncthreads();
#pragma unroll
  for (int c = 0; c < C; ++c)
    reinterpret_cast<float4*>(srow + c * kM)[j] =
        make_float4(v[c][0], v[c][1], v[c][2], v[c][3]);
  __syncthreads();
  for (int h = 128; h < kM; h <<= 1) {
    for (int i = j; i < kM / 2; i += kTPR) {
      const int p = (i / h) * 2 * h + (i % h);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float* s = srow + c * kM;
        const float a = s[p], b = s[p + h];
        s[p] = a + b;
        s[p + h] = a - b;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float4 q = reinterpret_cast<const float4*>(srow + c * kM)[j];
    v[c][0] = q.x;
    v[c][1] = q.y;
    v[c][2] = q.z;
    v[c][3] = q.w;
  }
}

// Max or sum over each of the C rows' TPR threads, fixed order; every
// thread of the row gets its codeword's result.  red: C * 8 floats.
template <int C, bool IS_MAX>
__device__ __forceinline__ void row_reduce_c(float (&x)[C], float* red,
                                             int r) {
  constexpr int WPR = kTPR / 32;  // warps per row
#pragma unroll
  for (int mk = 1; mk < 32; mk <<= 1) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float o = __shfl_xor_sync(0xffffffffu, x[c], mk);
      x[c] = IS_MAX ? fmaxf(x[c], o) : x[c] + o;
    }
  }
  __syncthreads();
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int c = 0; c < C; ++c) red[c * 8 + (threadIdx.x >> 5)] = x[c];
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float s = red[c * 8 + r * WPR];
#pragma unroll
    for (int i = 1; i < WPR; ++i) {
      const float o = red[c * 8 + r * WPR + i];
      s = IS_MAX ? fmaxf(s, o) : s + o;
    }
    x[c] = s;
  }
}

__device__ __forceinline__ void load4(float (&v)[4], const float* p) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
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

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]));
}

// tau2 of codeword b at iteration t from its |z|^2 partials.
__device__ __forceinline__ float tau2_of(const float* zpart, int b, float n) {
  float zz = 0.f;
#pragma unroll
  for (int s = 0; s < kNS; ++s) zz += zpart[(size_t)b * kNS + s];
  return zz / n;
}

// Row stage of iteration t for codewords C blockIdx.y + c.  work holds H_L
// of round(z) on entry (z itself for no_transform) and H_M of round(beta)
// on exit unless t is the last iteration (beta itself for no_transform).
template <int MODE, typename WT, int C>
__global__ void __launch_bounds__(kRowThreads)
exp_row_kernel(WT* __restrict__ work, float* __restrict__ beta,
               const float* __restrict__ z,
               const float* __restrict__ zpart,  // (B, M / 32)
               float* __restrict__ bpart,        // (B, L)
               float* __restrict__ tau2s,        // (T, B)
               const float* __restrict__ sq, int B, int t, int last, float n,
               float inv_sqrt_n) {
  constexpr bool NORMS = MODE != kNoNorms;
  constexpr bool DIRECT = MODE == kNoTransform;
  constexpr int kRound = IsBf16<WT>::value;
  __shared__ __align__(16) float srows[kRPB * C * kM];
  __shared__ float red[C * 8];
  const int r = threadIdx.x / kTPR, j = threadIdx.x % kTPR;
  const int l = blockIdx.x * kRPB + r;
  float* srow = srows + r * C * kM;
  size_t off[C];
  float tau2[C], v[C][4];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int b = blockIdx.y * C + c;
    off[c] = ((size_t)b * kL + l) * kM + 4 * j;
    tau2[c] = NORMS ? tau2_of(zpart, b, n) : 0.5f;
    if constexpr (DIRECT) {
      load4(v[c], z + off[c]);
    } else {
      load4(v[c], work + off[c]);
    }
  }
  if constexpr (!DIRECT) row_fwht_c<C>(v, srow, j);
  const float sql = sq[l];
  float mx[C], se[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float bo[4] = {0.f, 0.f, 0.f, 0.f};
    if (t > 0) load4(bo, beta + off[c]);
    const float ai = sql / tau2[c];
    mx[c] = -INFINITY;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float s = v[c][i] * inv_sqrt_n + bo[i];
      v[c][i] = MODE == kNoSoftmax ? s * ai * 1e-3f : ai * s;
      mx[c] = fmaxf(mx[c], v[c][i]);
    }
  }
  if constexpr (MODE != kNoSoftmax) {
    if constexpr (MODE != kNoMax) row_reduce_c<C, true>(mx, red, r);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      se[c] = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[c][i] = expf(MODE == kNoMax ? v[c][i] : v[c][i] - mx[c]);
        se[c] += v[c][i];
      }
    }
    row_reduce_c<C, false>(se, red, r);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float so = sql / se[c];
#pragma unroll
      for (int i = 0; i < 4; ++i) v[c][i] = so * v[c][i];
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) store4(beta + off[c], v[c]);
  if (!last) {  // uniform per launch
    if constexpr (NORMS) {
      float bb[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        bb[c] = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) bb[c] += v[c][i] * v[c][i];
      }
      row_reduce_c<C, false>(bb, red, r);
      if (j == 0) {
#pragma unroll
        for (int c = 0; c < C; ++c)
          bpart[(size_t)(blockIdx.y * C + c) * kL + l] = bb[c];
      }
    }
    if constexpr (!DIRECT) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
#pragma unroll
        for (int i = 0; i < 4; ++i) v[c][i] = maybe_round(v[c][i], kRound);
      }
      row_fwht_c<C>(v, srow, j);
#pragma unroll
      for (int c = 0; c < C; ++c) store4(work + off[c], v[c]);
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
#pragma unroll
    for (int c = 0; c < C; ++c)
      tau2s[(size_t)t * B + blockIdx.y * C + c] = tau2[c];
  }
}

// ---------------------------------------------------- S3 column stage
//
// A block of 16 warps owns a 32-column strip of all L rows as f_a slabs of
// f_b rows.  Warp w computes the (16-row tile i, 8-column tile j) pairs
// p = w + 16 s of every slab with mma.sync m16n8k16 (g = lane / 4, q =
// lane % 4): A = H_{f_b}[16 i + r][16 kk + k] = (-1)^(popc(i & kk) +
// popc(r & k)), a base fragment negated when popc(i & kk) is odd; B = the
// slab's bf16 data X[16 kk + k][8 j + n] from the shared tile; D holds rows
// 16 i + g and + 8, columns 8 j + 2 q and + 1 (amp_slab.cu's column stage).

// acc[a] += H_{f_b} X_a for the FA slabs of src at tile pair (i, j).
template <int FB, int FA>
__device__ __forceinline__ void hfb_mma(float (&acc)[FA][4],
                                        const __nv_bfloat16* src, int i,
                                        int j, const uint32_t (&ha)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int a = 0; a < FA; ++a) {
#pragma unroll
    for (int kk = 0; kk < FB / kTile; ++kk) {
      const uint32_t sg = (__popc(i & kk) & 1) ? kNeg : 0u;
      const __nv_bfloat16* px =
          src + (a * FB + kTile * kk + 2 * q) * kLdX + 8 * j + g;
      const uint32_t b0 = bf16_bits(px[0]) | (bf16_bits(px[kLdX]) << 16);
      const uint32_t b1 =
          bf16_bits(px[8 * kLdX]) | (bf16_bits(px[9 * kLdX]) << 16);
      mma_bf16(acc[a][0], acc[a][1], acc[a][2], acc[a][3], ha[0] ^ sg,
               ha[1] ^ sg, ha[2] ^ sg, ha[3] ^ sg, b0, b1);
    }
  }
}

// Store the tile pair's (rows 16 i + g, + 8; columns 8 j + 2 q, + 1) values
// of slab a rounded to bf16 into dst (kLdX a row).
__device__ __forceinline__ void store_pair(__nv_bfloat16* dst, int row,
                                           int col, const float (&d)[4]) {
  *reinterpret_cast<uint32_t*>(dst + row * kLdX + col) = bf16_pair(d[0], d[1]);
  *reinterpret_cast<uint32_t*>(dst + (row + 8) * kLdX + col) =
      bf16_pair(d[2], d[3]);
}

enum Kind { kLoop, kUnroll, kBatched, kVpu };

// dst = bf16 of H_128 of every slab of src (f_b = 128, 8 slabs): slabs in
// a loop that is not unrolled, unrolled, or all issued before any store.
template <int KIND>
__device__ __forceinline__ void hfb_slabs(const __nv_bfloat16* src,
                                          __nv_bfloat16* dst,
                                          const uint32_t (&ha)[4]) {
  constexpr int FB = 128, FA = kL / FB;
  constexpr int PPW = (FB / kTile) * (kStrip / 8) / kLWarps;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll 1
  for (int s = 0; s < PPW; ++s) {
    const int p = warp + kLWarps * s, i = p >> 2, j = p & 3;
    const int row = kTile * i + g, col = 8 * j + 2 * q;
    if constexpr (KIND == kBatched) {
      float acc[FA][4] = {};
      hfb_mma<FB, FA>(acc, src, i, j, ha);
#pragma unroll
      for (int a = 0; a < FA; ++a) store_pair(dst, a * FB + row, col, acc[a]);
    } else if constexpr (KIND == kUnroll) {
#pragma unroll
      for (int a = 0; a < FA; ++a) {
        float acc[1][4] = {};
        hfb_mma<FB, 1>(acc, src + a * FB * kLdX, i, j, ha);
        store_pair(dst, a * FB + row, col, acc[0]);
      }
    } else {
#pragma unroll 1
      for (int a = 0; a < FA; ++a) {
        float acc[1][4] = {};
        hfb_mma<FB, 1>(acc, src + a * FB * kLdX, i, j, ha);
        store_pair(dst, a * FB + row, col, acc[0]);
      }
    }
  }
}

// H_8 across the 8 slabs of src (f_b = 128) at 16 strip positions: row r of
// every slab, columns col0 .. col0 + 15, as mma.sync m16n8k8 with the
// positions the M axis and the slabs the K axis: d0, d1 are slabs 2q, 2q + 1
// at column col0 + g, d2, d3 the same at col0 + g + 8.
__device__ __forceinline__ void h8_mma(float (&d)[4],
                                       const __nv_bfloat16* src, int r,
                                       int col0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const __nv_bfloat16* p0 = src + (2 * q * 128 + r) * kLdX + col0 + g;
  const __nv_bfloat16* p1 = p0 + 128 * kLdX;
  const uint32_t a0 = bf16_bits(p0[0]) | (bf16_bits(p1[0]) << 16);
  const uint32_t a1 = bf16_bits(p0[8]) | (bf16_bits(p1[8]) << 16);
  mma_bf16_k8(d[0], d[1], d[2], d[3], a0, a1, h_pair(g, 2 * q));
}

template <int FB, int KIND>
__global__ void __launch_bounds__(kLThreads, 1)
lstage_col_kernel(__nv_bfloat16* __restrict__ work,
                  const float* __restrict__ y, float* __restrict__ z,
                  const __nv_bfloat16* __restrict__ mask,
                  float* __restrict__ zpart, const float* __restrict__ bpart,
                  const float* __restrict__ tau2s, int B, int t, float P,
                  float n, float inv_sqrt_n) {
  constexpr int FA = kL / FB;
  constexpr int PPW = (FB / kTile) * (kStrip / 8) / kLWarps;
  static_assert(KIND == kVpu || FB == 128, "H_8 products need f_b = 128");
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sx = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* st = sx + kL * kLdX;
  __shared__ float red[kLWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int b = blockIdx.y, m0 = blockIdx.x * kStrip;
  const size_t base = (size_t)b * kL * kM;
  const float coef = onsager<kLWarps>(bpart, tau2s, red, B, b, t, P, n);
  const bool fwd = t > 0;  // beta = 0 at t = 0: no forward transform
  if (fwd) {
    for (int e = threadIdx.x; e < kL * 4; e += kLThreads) {
      const int row = e >> 2, part = e & 3;
      *reinterpret_cast<uint4*>(sx + row * kLdX + 8 * part) =
          *reinterpret_cast<const uint4*>(work + base + (size_t)row * kM +
                                          m0 + 8 * part);
    }
    __syncthreads();
  }
  const uint32_t ha[4] = {h_pair(g, 2 * q), h_pair(g + 8, 2 * q),
                          h_pair(g, 2 * q + 8), h_pair(g + 8, 2 * q + 8)};
  float zz = 0.f;
  if constexpr (KIND == kVpu) {
    // forward H_{f_b} and H_{f_a}, the residual, round(z) into st
#pragma unroll 1
    for (int s = 0; s < PPW; ++s) {
      const int p = warp + kLWarps * s, i = p >> 2, j = p & 3;
      float acc[FA][4] = {};
      if (fwd) {
        hfb_mma<FB, FA>(acc, sx, i, j, ha);
        tile_fwht<FA>(acc);
      }
      const int col = 8 * j + 2 * q;
#pragma unroll
      for (int a = 0; a < FA; ++a) {
        float zr[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          zr[e] = residual(y, z, mask, base, a * FB + kTile * i + g + 8 * (e >> 1),
                           m0 + col + (e & 1), acc[a][e], coef, t, inv_sqrt_n);
          zz += zr[e] * zr[e];
        }
        store_pair(st, a * FB + kTile * i + g, col, zr);
      }
    }
    __syncthreads();
    // adjoint H_{f_b} and H_{f_a} of round(z) into the work tile
#pragma unroll 1
    for (int s = 0; s < PPW; ++s) {
      const int p = warp + kLWarps * s, i = p >> 2, j = p & 3;
      float acc[FA][4] = {};
      hfb_mma<FB, FA>(acc, st, i, j, ha);
      tile_fwht<FA>(acc);
      const int col = m0 + 8 * j + 2 * q;
#pragma unroll
      for (int a = 0; a < FA; ++a) {
        const size_t row = base + (size_t)(a * FB + kTile * i + g) * kM;
        *reinterpret_cast<uint32_t*>(work + row + col) =
            bf16_pair(acc[a][0], acc[a][1]);
        *reinterpret_cast<uint32_t*>(work + row + 8 * kM + col) =
            bf16_pair(acc[a][2], acc[a][3]);
      }
    }
  } else {
    // forward: H_128 of every slab, rounded, into st; H_8 across the slabs
    // and the residual, round(z) into sx (free once H_128 has read it)
    if (fwd) {
      hfb_slabs<KIND>(sx, st, ha);
      __syncthreads();
    }
#pragma unroll 1
    for (int u = warp; u < 128 * 2; u += kLWarps) {
      const int r = u >> 1, col0 = (u & 1) * 16;
      float d[4] = {};
      if (fwd) h8_mma(d, st, r, col0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int l = (2 * q + (e & 1)) * 128 + r;
        const int col = col0 + g + 8 * (e >> 1);
        const float zk = residual(y, z, mask, base, l, m0 + col, d[e], coef,
                                  t, inv_sqrt_n);
        zz += zk * zk;
        sx[l * kLdX + col] = __float2bfloat16_rn(zk);
      }
    }
    __syncthreads();
    // adjoint: H_128 of round(z) into st, then H_8 into the work tile
    hfb_slabs<KIND>(sx, st, ha);
    __syncthreads();
#pragma unroll 1
    for (int u = warp; u < 128 * 2; u += kLWarps) {
      const int r = u >> 1, col0 = (u & 1) * 16;
      float d[4] = {};
      h8_mma(d, st, r, col0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int l = (2 * q + (e & 1)) * 128 + r;
        work[base + (size_t)l * kM + m0 + col0 + g + 8 * (e >> 1)] =
            __float2bfloat16_rn(d[e]);
      }
    }
  }
  const float zsum = block_sum<kLWarps>(zz, red);
  if (threadIdx.x == 0) zpart[(size_t)b * kNS + blockIdx.x] = zsum;
}

// ---------------------------------------------- l256_m128 row stage
//
// 16 rows of one codeword a block, 8 warps: H_M = H_4 (x) H_128 of the
// work tile's bf16 rows on the tensor cores (amp_mma.cuh slab_hm_apply)
// into a float32 shared tile, then one warp a row (lane i holds columns
// i + 32 e) for the softmax, then H_M of round(beta) into the work tile.

using HmRows = SlabRows<kM>;
constexpr int kHmSmem = kTile * HmRows::LDA * 2 + kTile * kM * 4;

__global__ void __launch_bounds__(HmRows::THREADS)
lstage_row_kernel(__nv_bfloat16* __restrict__ work, float* __restrict__ beta,
                  const float* __restrict__ zpart, float* __restrict__ bpart,
                  float* __restrict__ tau2s, const float* __restrict__ sq,
                  int B, int t, int last, float n, float inv_sqrt_n) {
  constexpr int EPL = kM / 32, NW = HmRows::NW;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem);
  float* sS = reinterpret_cast<float*>(smem + kTile * HmRows::LDA * 2);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.y, l0 = blockIdx.x * kTile;
  const size_t base = ((size_t)b * kL + l0) * kM;
  const float tau2 = tau2_of(zpart, b, n);
  for (int e = threadIdx.x; e < kTile * kM / 8; e += HmRows::THREADS) {
    const int r = e / (kM / 8), c8 = e % (kM / 8);
    *reinterpret_cast<uint4*>(sA + r * HmRows::LDA + 8 * c8) =
        *reinterpret_cast<const uint4*>(work + base + (size_t)r * kM + 8 * c8);
  }
  __syncthreads();
  slab_hm_apply<kM>(sA, [sS](int r, int col, float v0, float v1) {
    *reinterpret_cast<float2*>(sS + r * kM + col) = make_float2(v0, v1);
  });
  __syncthreads();
  for (int r = warp; r < kTile; r += NW) {
    const int l = l0 + r;
    const size_t off = base + (size_t)r * kM + lane;
    const float ai = sq[l] / tau2;
    float v[EPL];
    float mx = -INFINITY;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      float s = sS[r * kM + lane + 32 * e] * inv_sqrt_n;
      if (t > 0) s += beta[off + 32 * e];
      v[e] = ai * s;
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
    const float so = sq[l] / se;
    float bb = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      v[e] = so * v[e];
      beta[off + 32 * e] = v[e];
      bb += v[e] * v[e];
      sA[r * HmRows::LDA + lane + 32 * e] = __float2bfloat16_rn(v[e]);
    }
    bb = warp_sum(bb);
    if (lane == 0 && !last) bpart[(size_t)b * kL + l] = bb;
  }
  if (!last) {  // uniform per launch
    __syncthreads();
    slab_hm<kM>(sA, work + base);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) tau2s[(size_t)t * B + b] = tau2;
}

// ------------------------------------------------------------- launchers

// Arguments of the iteration loop (see amp_exp_run).
struct ExpArgs {
  const float *y, *sq;
  const __nv_bfloat16* mask;
  float *beta, *tau2s, *z, *zpart, *bpart;
  void* work;
  int B, T;
  float P, n, inv_sqrt_n;
};

template <typename K>
int set_smem(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// K1's two launches an iteration, column stage COL_MODE (the pair's is
// full's, with M at run time under RTM), and row stage MODE for C
// codewords a block.
template <int MODE, typename WT, int C, bool RTM = false>
int run_k1_style(const ExpArgs& a, cudaStream_t st) {
  constexpr int COL_MODE = MODE == kPair ? kFull : MODE;
  WT* work = static_cast<WT*>(a.work);
  const __nv_bfloat16* mask = a.mask;
  for (int t = 0; t < a.T; ++t) {
    int rc = launch_cols<kW, kR, 1>(
        exp_col_kernel<COL_MODE, WT, RTM>, a.B, kM, st, work, a.beta,
        a.y, a.z, mask, a.zpart, a.bpart, a.tau2s, a.B, t, a.P, a.n,
        a.inv_sqrt_n, kM);
    if (rc) return rc;
    exp_row_kernel<COL_MODE, WT, C>
        <<<dim3(kL / kRPB, a.B / C), kRowThreads, 0, st>>>(
            work, a.beta, a.z, a.zpart, a.bpart, a.tau2s, a.sq, a.B, t,
            t == a.T - 1, a.n, a.inv_sqrt_n);
    rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  return 0;
}

// The S3 column stage (f_b = FB, KIND) with K1's row stage, or with the
// tensor-core H_M row stage (HM_ROWS, l256_m128).
template <int FB, int KIND, bool HM_ROWS>
int run_lstage(const ExpArgs& a, cudaStream_t st) {
  __nv_bfloat16* work = static_cast<__nv_bfloat16*>(a.work);
  auto col = lstage_col_kernel<FB, KIND>;
  const int col_bytes = 2 * kL * kLdX * (int)sizeof(__nv_bfloat16);
  int rc = set_smem(col, col_bytes);
  if (rc) return rc;
  if constexpr (HM_ROWS) {
    rc = set_smem(lstage_row_kernel, kHmSmem);
    if (rc) return rc;
  }
  for (int t = 0; t < a.T; ++t) {
    col<<<dim3(kM / kStrip, a.B), kLThreads, col_bytes, st>>>(
        work, a.y, a.z, a.mask, a.zpart, a.bpart, a.tau2s, a.B, t, a.P, a.n,
        a.inv_sqrt_n);
    rc = (int)cudaGetLastError();
    if (rc) return rc;
    const int last = t == a.T - 1;
    if constexpr (HM_ROWS) {
      lstage_row_kernel<<<dim3(kL / kTile, a.B), HmRows::THREADS, kHmSmem,
                          st>>>(work, a.beta, a.zpart, a.bpart, a.tau2s,
                                a.sq, a.B, t, last, a.n, a.inv_sqrt_n);
    } else {
      exp_row_kernel<kFull, __nv_bfloat16, 1>
          <<<dim3(kL / kRPB, a.B), kRowThreads, 0, st>>>(
              work, a.beta, a.z, a.zpart, a.bpart, a.tau2s, a.sq, a.B, t,
              last, a.n, a.inv_sqrt_n);
    }
    rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  return 0;
}

template <int MODE, int C = 1>
int run_both(const ExpArgs& a, int round_bf16, cudaStream_t st) {
  return round_bf16 ? run_k1_style<MODE, __nv_bfloat16, C>(a, st)
                    : run_k1_style<MODE, float, C>(a, st);
}

}  // namespace

extern "C" {

// Variant `mode` (the order of ops/amp_exp.py MODES) of the split AMP
// decode for B codewords, T fixed iterations.  Inputs: y (B, L, M) the
// observation on the row support; mask (L, M) bfloat16 0/1; sq (L,)
// sqrt(n P_l).  Outputs: beta (B, L, M) true scale; tau2s (T, B).
// Scratch: z (B, L, M) float; work (B, L, M), bfloat16 when round_bf16
// (the transforms' operands rounded to bf16) and float otherwise (the
// K1-style variants only: S3's factors run on the bf16 tensor cores);
// zpart (B, M / 32); bpart (B, L).  L = 1024, M = 512; B even for the
// pair.  runtime_m (full in bf16 only), a diagnostic of the column stage
// against K1's: it takes M at run time, as K1 does.  Returns 0, a
// cudaError_t, or -1 for an unsupported shape or mode.
int amp_exp_run(int mode, const float* y, const __nv_bfloat16* mask,
                const float* sq, float* beta, float* tau2s, float* z,
                void* work, float* zpart, float* bpart, int B, int L, int M,
                int T, float P, float n, float inv_sqrt_n, int round_bf16,
                int runtime_m, void* stream) {
  if (L != kL || M != kM || B < 1 || B > 65535 || T < 1) return kBadShape;
  if (mode < 0 || mode >= kModes) return kBadShape;
  if (mode == kPair && B % 2) return kBadShape;
  if (mode >= kSlabLoop && mode <= kL256M128 && !round_bf16) return kBadShape;
  if (runtime_m && (mode != kFull || !round_bf16)) return kBadShape;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ExpArgs a{y,    sq,    mask,
                  beta, tau2s, z,
                  zpart, bpart, work,
                  B,    T,     P,
                  n,    inv_sqrt_n};
  using bf = __nv_bfloat16;
  if (runtime_m) return run_k1_style<kFull, bf, 1, true>(a, st);
  switch (mode) {
    case kFull: return run_both<kFull>(a, round_bf16, st);
    case kNoSoftmax: return run_both<kNoSoftmax>(a, round_bf16, st);
    case kNoMax: return run_both<kNoMax>(a, round_bf16, st);
    case kNoTransform: return run_both<kNoTransform>(a, round_bf16, st);
    case kMStageOnly: return run_both<kMStageOnly>(a, round_bf16, st);
    case kNoNorms: return run_both<kNoNorms>(a, round_bf16, st);
    case kSlabLoop: return run_lstage<128, kLoop, false>(a, st);
    case kSlabUnroll: return run_lstage<128, kUnroll, false>(a, st);
    case kSlabBatched: return run_lstage<128, kBatched, false>(a, st);
    case kF512Vpu2: return run_lstage<512, kVpu, false>(a, st);
    case kF256Vpu4: return run_lstage<256, kVpu, false>(a, st);
    case kF128Vpu8: return run_lstage<128, kVpu, false>(a, st);
    case kL256M128: return run_lstage<256, kVpu, true>(a, st);
    case kPair: return run_both<kPair, 2>(a, round_bf16, st);
    default: return kBadShape;
  }
}

const char* amp_exp_error_string(int code) {
  if (code == kBadShape) return "unsupported shape or mode";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
