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
// All run T fixed iterations on an observation y given (no encode of a
// codeword, no noise, no early stop, no pins).
//
// S1, S2 and S3 are K1 as it is (its row-support design) with one thing
// changed: K1's compact encode of y on the row support, then per
// iteration a column stage that walks (codeword, 32-column strip) items
// with one block an SM, the next item's strip brought by cp.async, and
// K1's row stage (one warp a section row), in K1's scale-free arithmetic
// (ops/amp_kernel.py):
//
//   z    = y - mask/n * H(beta') + coef * z,  coef = (P - |beta'|^2/n^2)/tau2_prev
//   tau2 = |z|^2 / n
//   beta' = sqo * softmax_row((sqi / tau2) * (H(z) + beta')),  beta = beta' / sqrt(n)
//
// with y and z kept on the row support only.  The forward transform's H_M
// runs in the row stage before H_L in the column stage; the adjoint's H_L
// in the column stage before H_M in the row stage (K1's order, which
// rounds the adjoint at other places than the scripts: ops/amp_exp.py).
//
// S2 (the stage ablation): K1's own column and row kernels (amp_k1.cuh)
// at a compile-time variant, "full" being K1's instantiation itself, so
// full's decode is K1's fixed-T call with y given, bit for bit.  The
// others drop, at compile time: no_transform H_L and H_M (the work tile
// carries beta' and z); m_stage_only H_L; no_softmax the max, exp and
// sums; no_max the max; no_norms the |z|^2 and |beta'|^2 partials and
// their passes (coef = 0.1, tau2 = 0.5).  full - variant splits K1's
// stages: H_L (two shared-memory transposes and the butterflies), the
// residual's reductions, the row stage's pieces.
//
// S3 (the factorings of H_L = H_{f_a} (x) H_{f_b}): K1's encode, K1's
// row stage (l256_m128: its own, below) and a column stage of its own,
// s3_col_kernel, on K1's walker: one block of 16 warps an SM over (codeword,
// strip) items, two bf16 strip tiles (the current item's, and the next
// one's filled by cp.async while this one computes) and a third for the
// rounded z or an intermediate, each 64 KB, their 16-byte chunks swizzled
// by row so that ldmatrix reads no bank twice without padding; with K1's
// staged support data (y, z, mask/n and the strip's support words and
// first entries, 32 KB) that is 224 KB of the 227.  H_{f_b} runs on the
// tensor cores down the strip's columns, reading the strip in place
// (mma.sync m16n8k16: A the +-1 factor built in registers from the parity
// of popcount, B the strip's bf16 data through ldmatrix.trans; D float32),
// so nothing is transposed; a warp owns (16-row, 8-column) tiles of every
// slab, so H_{f_a} across the slabs is in its registers, and issues eight
// independent accumulation chains at a time (slabs, and tiles of one
// column tile, which share their ldmatrix):
//   f512_vpu2, f256_vpu4, f128_vpu8  H_{f_a} float32 butterflies on the
//                 accumulators (K1's rounding: the transform's input
//                 rounded, H_L in float32);
//   slab_loop, slab_unroll, slab_batched  f_b = 128, and H_8 a second
//                 product across the slabs (mma.sync m16n8k8, the slabs the
//                 K axis) on the H_128 results rounded to bf16 in shared
//                 memory; the slabs' H_128 products one slab after
//                 another in a loop that is not unrolled, unrolled, or
//                 (batched) every product interleaved before any store;
//   l256_m128     f256_vpu4's column stage, and a row stage whose H_M =
//                 H_4 (x) H_128 runs H_128 on the tensor cores (amp_mma.cuh
//                 slab_hm, 16 rows a block) and H_4 in float32.
// A wgmma form (A the factor in registers, B the (f_b x 32) slab in
// shared memory) was not built: every variant's products issue at a small
// share of the tensor cores' rate here (PERF.md).
// The residual runs on the products' layout: each element finds its
// support bit and entry in K1's tables, the strip's words and first
// entries staged in shared memory as K1's column stage stages them (two
// shared loads and a popcount an element, no table of its own).
//
// S1 (the pair): K1's encode and column stage (its walker holds one
// codeword's strip: two would need twice its 192 KB at L = 1024), and K1's
// row stage at its variant kK1Pair, a warp taking section row l of two
// codewords and issuing each phase (load, H_M, max, exp, sum, store, the
// next H_M) for both before the next.  Per codeword the arithmetic is
// K1's, so the pair's bits are K1's fixed-T call's.  Does one codeword's
// arithmetic hide behind the other's loads in the row stage?
//
// Shapes: L = 1024, M = 512 (the scripts'), any B up to 65535 (even for
// the pair).  Bounds (chip_smoke.py exp_bound): every decoding variant
// computes full's function; at B = 512, T = 32 that is 6.33 ms of float32
// operations.  Determinism: no float atomics; per-codeword sums are
// fixed-order trees in a block plus a fixed-order pass over the partials.
//
// Built by sparc_ldpc_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// and called through ctypes (plain C interface below).

#include "amp_k1.cuh"
#include "amp_mma.cuh"

namespace {

// the variants, in the order of ops/amp_exp.py MODES
enum Mode {
  kFull, kNoSoftmax, kNoMax, kNoTransform, kMStageOnly, kNoNorms,
  kSlabLoop, kSlabUnroll, kSlabBatched, kF512Vpu2, kF256Vpu4, kF128Vpu8,
  kL256M128, kPair, kModes
};

constexpr int kL = 1024, kM = 512;     // the scripts' shape
constexpr int kW = 32, kR = 32;        // K1's column geometry at L = 1024
constexpr int kNS = kM / kStrip;       // strips, |z|^2 partials a codeword
constexpr int kSE = kL * kStrip;       // elements of a strip
constexpr int kS3W = 16;               // warps of an S3 column block
constexpr int kS3T = 32 * kS3W;

// Arguments of the K1-based variants' iteration loop (see amp_exp_run).
struct K1Args {
  Support sp;
  const float *y_n, *sqi, *sqo;
  float *yc, *zc, *beta, *trace, *zpart, *bpart;
  int32_t *iters, *active;
  void* work;
  int B, T;
  float P, n, inv_sqrt_n;
};

// ------------------------------------------------------------------ S2

// K1's encode and T iterations of its two launches: the column stage at
// variant V, the row stage at RV (V's own, or S1's kK1Pair).
template <int V, typename WT, int RV = V>
int run_s2(const K1Args& a, cudaStream_t st) {
  WT* work = static_cast<WT*>(a.work);
  const float nn = a.n * a.n;
  int rc = k1_encode_launch<kW, kR, 1>(a.y_n, a.sp, a.sqo, nullptr, nullptr,
                                       0.f, a.yc, a.B, kM, st);
  for (int t = 0; t < a.T && !rc; ++t) {
    rc = k1_col_launch<kW, kR, 1, kM, WT, V>(work, a.yc, a.zc, a.sp, a.zpart,
                                             a.bpart, a.trace, a.active, a.B,
                                             t, a.P, nn, st);
    if (rc) break;
    rc = k1_row_launch<kM, WT, 1, RV>(work, a.beta, a.zpart, a.bpart,
                                      a.trace, a.iters, a.active, nullptr,
                                      nullptr, a.sqi, a.sqo, a.B, kL, t,
                                      t == a.T - 1, a.n, a.inv_sqrt_n, 0.f,
                                      st);
  }
  return rc;
}

// ------------------------------------------------------------------ S3

// Offset of element (l, col) of a strip tile: row l's 16-byte chunks
// XOR-swizzled by bits 1-2 of l, so the eight rows an ldmatrix 8 x 8
// matrix reads (64-byte rows, two to a 128-byte line) fall in eight
// distinct bank groups.
__device__ __forceinline__ int swz(int l, int col) {
  return l * kStrip + ((((col >> 3) ^ (l >> 1)) & 3) << 3) + (col & 7);
}

// The column stage's geometry for slabs of FB rows: FA slabs, kS3W warps,
// a warp owning PPW (16-row tile i, 8-column tile j) pairs p = warp +
// kS3W u of every slab (i = p / 4, j = p % 4: one column tile a warp); its
// accumulators hold rows 16 i + g and + 8, columns 8 j + 2 q and + 1 of
// each (g = lane / 4, q = lane % 4).  Sixteen warps leave 128 registers
// a thread: with 32 the accumulators of every slab and the residual's
// state spilled.
template <int FB>
struct S3Geo {
  static constexpr int FA = kL / FB;
  static constexpr int PPW = FB / 4 / kS3W;
  static constexpr int CAP = entry_cap<kW, kR>();
  // three strip tiles, y, z and mask/n of the item's entries, the strip's
  // support words and first entries
  static constexpr int SMEM = 3 * kSE * 2 + 3 * CAP * 4 + 2 * 1024 * 4;
};

enum Kind { kLoop, kUnroll, kBatched, kVpu };

// d = H_{f_b} X of slab a of the strip tile sx at tile pair (i, j), on
// mma.sync m16n8k16: A = H_{f_b}[16 i + r][16 kk + k] = (-1)^(popc(i & kk) +
// popc(r & k)), the base fragment ha negated as a whole when popc(i & kk)
// is odd; B = X[16 kk + k][8 j + n], two k-steps an ldmatrix.trans.
template <int FB>
__device__ __forceinline__ void s3_hfb(const __nv_bfloat16* sx, int a, int i,
                                       int j, const uint32_t (&ha)[4],
                                       float (&d)[4]) {
  const int lane = threadIdx.x & 31;
  d[0] = d[1] = d[2] = d[3] = 0.f;
  // at most four ldmatrix in flight: a full unroll at f_b = 256 and 512
  // kept them all and spilled
#pragma unroll 4
  for (int k2 = 0; k2 < FB / 32; ++k2) {
    uint32_t r[4];
    ldsm_x4_t(r, sx + swz(a * FB + 32 * k2 + lane, 8 * j));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t sg = (__popc(i & (2 * k2 + h)) & 1) ? kNeg : 0u;
      mma_bf16(d[0], d[1], d[2], d[3], ha[0] ^ sg, ha[1] ^ sg, ha[2] ^ sg,
               ha[3] ^ sg, r[2 * h], r[2 * h + 1]);
    }
  }
}

// acc[u][a] = H_{f_b} X_a of every slab a of sx at the warp's NP tile
// pairs u: rows i[u], all in column tile j, so one ldmatrix.trans feeds
// them all; the k-steps outer and the (slab, pair) products inner, so
// that the NP FA accumulation chains interleave (consecutive mma are
// independent) where s3_hfb runs one chain after another.
template <int FB, int FA, int NP>
__device__ __forceinline__ void s3_hfb_all(const __nv_bfloat16* sx,
                                           const int (&i)[NP], int j,
                                           const uint32_t (&ha)[4],
                                           float (&acc)[NP][FA][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int u = 0; u < NP; ++u)
#pragma unroll
    for (int a = 0; a < FA; ++a)
      acc[u][a][0] = acc[u][a][1] = acc[u][a][2] = acc[u][a][3] = 0.f;
#pragma unroll 1
  for (int k2 = 0; k2 < FB / 32; ++k2) {
    uint32_t r[FA][4];
#pragma unroll
    for (int a = 0; a < FA; ++a)
      ldsm_x4_t(r[a], sx + swz(a * FB + 32 * k2 + lane, 8 * j));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int a = 0; a < FA; ++a) {
#pragma unroll
        for (int u = 0; u < NP; ++u) {
          const uint32_t sg = (__popc(i[u] & (2 * k2 + h)) & 1) ? kNeg : 0u;
          mma_bf16(acc[u][a][0], acc[u][a][1], acc[u][a][2], acc[u][a][3],
                   ha[0] ^ sg, ha[1] ^ sg, ha[2] ^ sg, ha[3] ^ sg, r[a][2 * h],
                   r[a][2 * h + 1]);
        }
      }
    }
  }
}

// Rows 16 i + g and + 8 (row0 = the first), columns col and col + 1 of d,
// rounded to bf16, into the strip tile dst.
__device__ __forceinline__ void s3_store_pair(__nv_bfloat16* dst, int row0,
                                              int col, const float (&d)[4]) {
  *reinterpret_cast<uint32_t*>(dst + swz(row0, col)) = bf16_pair(d[0], d[1]);
  *reinterpret_cast<uint32_t*>(dst + swz(row0 + 8, col)) =
      bf16_pair(d[2], d[3]);
}

// dst = bf16 of H_128 of every slab of src (f_b = 128, 8 slabs) at tile
// pair p = (i, j): the slabs in a loop that is not unrolled, or unrolled.
template <int KIND>
__device__ __forceinline__ void s3_slabs_pair(const __nv_bfloat16* src,
                                              __nv_bfloat16* dst, int p,
                                              const uint32_t (&ha)[4]) {
  const int lane = threadIdx.x & 31;
  const int i = p >> 2, j = p & 3;
  const int row = kTile * i + (lane >> 2), col = 8 * j + 2 * (lane & 3);
  if constexpr (KIND == kUnroll) {
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      float d[4];
      s3_hfb<128>(src, a, i, j, ha, d);
      s3_store_pair(dst, 128 * a + row, col, d);
    }
  } else {
#pragma unroll 1
    for (int a = 0; a < 8; ++a) {
      float d[4];
      s3_hfb<128>(src, a, i, j, ha, d);
      s3_store_pair(dst, 128 * a + row, col, d);
    }
  }
}

// s3_slabs_pair at the warp's tile pairs, one after another; kBatched
// issues every product of both (s3_hfb_all) before it stores any.
template <int KIND>
__device__ __forceinline__ void s3_slabs(const __nv_bfloat16* src,
                                         __nv_bfloat16* dst,
                                         const uint32_t (&ha)[4]) {
  const int warp = threadIdx.x >> 5;
  if constexpr (KIND == kBatched) {
    constexpr int NP = 32 / kS3W;
    const int lane = threadIdx.x & 31, j = warp & 3;
    int i[NP];
#pragma unroll
    for (int u = 0; u < NP; ++u) i[u] = (warp >> 2) + (kS3W / 4) * u;
    float acc[NP][8][4];
    s3_hfb_all<128, 8, NP>(src, i, j, ha, acc);
#pragma unroll
    for (int u = 0; u < NP; ++u)
#pragma unroll
      for (int a = 0; a < 8; ++a)
        s3_store_pair(dst, 128 * a + kTile * i[u] + (lane >> 2),
                      8 * j + 2 * (lane & 3), acc[u][a]);
  } else {
#pragma unroll 1
    for (int p = warp; p < 32; p += kS3W) s3_slabs_pair<KIND>(src, dst, p, ha);
  }
}

// H_8 across the 8 slabs of the strip tile src (f_b = 128) at 16 strip
// positions, row r of every slab at columns col0 .. col0 + 15, as mma.sync
// m16n8k8 with the positions the M axis and the slabs the K axis: d[e] is
// slab 2 q + (e & 1) at column col0 + g + 8 (e >> 1).
__device__ __forceinline__ void s3_h8(const __nv_bfloat16* src, int r,
                                      int col0, float (&d)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int l0 = 2 * q * 128 + r, l1 = l0 + 128;
  const uint32_t a0 = bf16_bits(src[swz(l0, col0 + g)]) |
                      (bf16_bits(src[swz(l1, col0 + g)]) << 16);
  const uint32_t a1 = bf16_bits(src[swz(l0, col0 + g + 8)]) |
                      (bf16_bits(src[swz(l1, col0 + g + 8)]) << 16);
  d[0] = d[1] = d[2] = d[3] = 0.f;
  mma_bf16_k8(d[0], d[1], d[2], d[3], a0, a1, h_pair(g, 2 * q));
}

// S3's column stage of iteration t: as K1's (k1_col_kernel: work holds
// bf16(H_M beta') on entry and bf16(H_L z) on exit, z (B, ns) updated on
// the support, |z|^2 a partial per (codeword, strip), the next item's
// |beta'|^2 taken in the same reduction), with H_L = H_{f_a} (x) H_{f_b}
// on the tensor cores.  Grid: as many walkers as are resident, walker i
// taking the items (codeword, strip) i, i + walkers, ...
template <int FB, int KIND>
__global__ void __launch_bounds__(kS3T, 1)
s3_col_kernel(__nv_bfloat16* __restrict__ work, const float* __restrict__ yc,
              float* __restrict__ zc, Support sp,
              float* __restrict__ zpart,        // (B, M / 32)
              const float* __restrict__ bpart,  // (B, L) row |beta'|^2
              const float* __restrict__ trace,  // (T, B)
              int B, int t, float P, float nn) {
  using G = S3Geo<FB>;
  constexpr int FA = G::FA, PPW = G::PPW, CAP = G::CAP, S = kNS;
  static_assert(KIND == kVpu || FB == 128, "H_8 products need f_b = 128");
  extern __shared__ __align__(16) unsigned char s3_sm[];
  __shared__ float red[2 * kS3W];
  // strip tiles 0 and 1 (the current item's and the next one's), the
  // third (rounded z, or the H_128 results), then the item's support data
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(s3_sm);
  __nv_bfloat16* mid = tiles + 2 * kSE;
  float* ys = reinterpret_cast<float*>(mid + kSE);
  float* zs = ys + CAP;
  float* ms = zs + CAP;
  uint32_t* tword = reinterpret_cast<uint32_t*>(ms + CAP);
  int32_t* toff = reinterpret_cast<int32_t*>(tword + 1024);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int walkers = gridDim.x, items = B * S;
  const bool fwd = t > 0;  // beta' = 0 at t = 0: no forward transform
  auto fetch_strip = [&](int it, __nv_bfloat16* dst) {
    const __nv_bfloat16* src =
        work + (size_t)(it / S) * kL * kM + (it % S) * kStrip;
    for (int e = threadIdx.x; e < kL * 4; e += kS3T) {
      const int r = e >> 2, p = e & 3;
      cp_async16(dst + swz(r, 8 * p), src + (size_t)r * kM + 8 * p);
    }
  };
  // K1's staging of an item's support data (k1_col_kernel fetch_entries):
  // the strip's word and first entry of each (32-row range r, column c) at
  // 32 r + c
  auto fetch_entries = [&](int it) {
    const int s = it % S;
    for (int e = threadIdx.x; e < 1024; e += kS3T) {
      const size_t tab = (size_t)(e >> 5) * kM + s * kStrip + (e & 31);
      cp_async4(tword + e, sp.word + tab);
      cp_async4(toff + e, sp.offset + tab);
    }
    const int first = sp.block[s], count = sp.block[s + 1] - first;
    if (count > CAP) return;
    const size_t off = (size_t)(it / S) * sp.ns + first;
    for (int i = threadIdx.x; i < count; i += kS3T) {
      cp_async4(ys + i, yc + off + i);
      cp_async4(ms + i, sp.mask + first + i);
      if (t > 0) cp_async4(zs + i, zc + off + i);
    }
  };
  auto bterms = [&](int it) {
    float acc = 0.f;
    if (t > 0 && it < items) {
      const float* bp = bpart + (size_t)(it / S) * kL;
      for (int l = threadIdx.x; l < kL; l += kS3T) acc += bp[l];
    }
    return acc;
  };
  const uint32_t ha[4] = {h_pair(g, 2 * q), h_pair(g + 8, 2 * q),
                          h_pair(g, 2 * q + 8), h_pair(g + 8, 2 * q + 8)};
  // the warp's tile pairs warp + kS3W u: rows pi0 + kS3W / 4 u, column
  // tile pj; NP of them at a time, eight accumulation chains
  const int pj = warp & 3, pi0 = warp >> 2;
  constexpr int NP = FA < 8 ? 8 / FA : 1;

  int it = blockIdx.x;
  if (it >= items) return;
  if (fwd) fetch_strip(it, tiles);
  fetch_entries(it);
  float bnorm2 = block_sum2<kS3W>(bterms(it), 0.f, red).x;
  int slot = 0;
  while (it < items) {
    const int nx = it + walkers;
    const int b = it / S, s = it % S;
    const int first = sp.block[s];
    const bool staged = sp.block[s + 1] - first <= CAP;
    const float tau2_prev = t > 0 ? trace[(size_t)(t - 1) * B + b] : 1.f;
    const float bnext = bterms(nx);
    cp_async_wait_all();
    __syncthreads();  // this item's strip and support data are visible
    if (fwd && nx < items) fetch_strip(nx, tiles + (slot ^ 1) * kSE);
    __nv_bfloat16* cur = tiles + slot * kSE;
    const float coef = t > 0 ? (P - bnorm2 / nn) / tau2_prev : 0.f;
    const size_t cw = (size_t)b * sp.ns;
    const float* ysrc = staged ? ys - first : yc + cw;
    const float* zsrc = staged ? zs - first : zc + cw;
    const float* msrc = staged ? ms - first : sp.mask;
    float zz = 0.f;
    // z of strip element (l, col) from x = (H beta')[l, col], stored on
    // the support; 0 off it
    auto resid = [&](int l, int col, float x) {
      const int idx = (l >> 5) * kStrip + col;
      const uint32_t word = tword[idx];
      const int k = l & 31;
      float zk = 0.f;
      if ((word >> k) & 1u) {
        const int e = toff[idx] + __popc(word & ((1u << k) - 1u));
        zk = ysrc[e] - msrc[e] * x;
        if (t > 0) zk += coef * zsrc[e];
        zc[cw + e] = zk;
        zz += zk * zk;
      }
      return zk;
    };
    if constexpr (KIND == kVpu) {
#pragma unroll 1
      for (int u0 = 0; u0 < PPW; u0 += NP) {
        int pi[NP];
#pragma unroll
        for (int u = 0; u < NP; ++u) pi[u] = pi0 + (kS3W / 4) * (u0 + u);
        float acc[NP][FA][4];
        if (fwd) {
          s3_hfb_all<FB, FA, NP>(cur, pi, pj, ha, acc);
#pragma unroll
          for (int u = 0; u < NP; ++u) tile_fwht<FA>(acc[u]);  // H_{f_a}
        }
#pragma unroll
        for (int u = 0; u < NP; ++u) {
#pragma unroll
          for (int a = 0; a < FA; ++a) {
            const int row = a * FB + kTile * pi[u] + g, col = 8 * pj + 2 * q;
            float zr[4];
#pragma unroll
            for (int e = 0; e < 4; ++e)
              zr[e] = resid(row + 8 * (e >> 1), col + (e & 1),
                            fwd ? acc[u][a][e] : 0.f);
            s3_store_pair(mid, row, col, zr);
          }
        }
      }
    } else {
      // forward: H_128 of every slab, rounded, into mid; H_8 across the
      // slabs and the residual, bf16(z) into the current tile (free once
      // H_128 has read it)
      if (fwd) {
        s3_slabs<KIND>(cur, mid, ha);
        __syncthreads();
      }
#pragma unroll 1
      for (int u = warp; u < 256; u += kS3W) {
        const int r = u >> 1, col0 = (u & 1) * 16;
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        if (fwd) s3_h8(mid, r, col0, d);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int l = (2 * q + (e & 1)) * 128 + r;
          const int col = col0 + g + 8 * (e >> 1);
          cur[swz(l, col)] = __float2bfloat16_rn(resid(l, col, d[e]));
        }
      }
    }
    // this item's |z|^2 and the next item's |beta'|^2; the barriers also
    // end every thread's reads of the support data and make the z tile
    // visible
    const float2 sums = block_sum2<kS3W>(zz, bnext, red);
    if (threadIdx.x == 0) zpart[(size_t)b * S + s] = sums.x;
    if (nx < items) fetch_entries(nx);
    __nv_bfloat16* out = work + (size_t)b * kL * kM + s * kStrip;
    if constexpr (KIND == kVpu) {
      // the adjoint's H_{f_b} and H_{f_a} of bf16(z), into the work tile
#pragma unroll 1
      for (int u0 = 0; u0 < PPW; u0 += NP) {
        int pi[NP];
#pragma unroll
        for (int u = 0; u < NP; ++u) pi[u] = pi0 + (kS3W / 4) * (u0 + u);
        float acc[NP][FA][4];
        s3_hfb_all<FB, FA, NP>(mid, pi, pj, ha, acc);
#pragma unroll
        for (int u = 0; u < NP; ++u) {
          tile_fwht<FA>(acc[u]);
#pragma unroll
          for (int a = 0; a < FA; ++a) {
            const int row = a * FB + kTile * pi[u] + g, col = 8 * pj + 2 * q;
            *reinterpret_cast<uint32_t*>(out + (size_t)row * kM + col) =
                bf16_pair(acc[u][a][0], acc[u][a][1]);
            *reinterpret_cast<uint32_t*>(out + (size_t)(row + 8) * kM + col) =
                bf16_pair(acc[u][a][2], acc[u][a][3]);
          }
        }
      }
    } else {
      // the adjoint: H_128 of bf16(z) rounded into mid, then H_8 into the
      // work tile
      s3_slabs<KIND>(cur, mid, ha);
      __syncthreads();
#pragma unroll 1
      for (int u = warp; u < 256; u += kS3W) {
        const int r = u >> 1, col0 = (u & 1) * 16;
        float d[4];
        s3_h8(mid, r, col0, d);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int l = (2 * q + (e & 1)) * 128 + r;
          out[(size_t)l * kM + col0 + g + 8 * (e >> 1)] =
              __float2bfloat16_rn(d[e]);
        }
      }
    }
    bnorm2 = sums.y;
    slot ^= 1;
    it = nx;
  }
}

// l256_m128's row stage, K1's row stage (k1_row_kernel) with its H_M =
// H_4 (x) H_128 on the tensor cores: 16 rows of one codeword a block, 8
// warps.  The work tile's bf16 rows are staged in shared memory, their
// H_M (amp_mma.cuh slab_hm_apply: X H_128 on mma.sync, H_4 across the
// column blocks in float32) goes to a float32 shared tile, then one warp a
// row (lane i holds columns i + 32 e) takes the softmax, and H_M of
// bf16(beta'_new) goes to the work tile unless t is the last iteration.
using HmRows = SlabRows<kM>;
constexpr int kHmSmem = kTile * HmRows::LDA * 2 + kTile * kM * 4;

__global__ void __launch_bounds__(HmRows::THREADS)
s3_hm_row_kernel(__nv_bfloat16* __restrict__ work, float* __restrict__ beta,
                 const float* __restrict__ zpart,  // (B, M / 32)
                 float* __restrict__ bpart,        // (B, L)
                 float* __restrict__ trace,        // (T, B)
                 const float* __restrict__ sqi, const float* __restrict__ sqo,
                 int B, int t, int last, float n, float inv_sqrt_n) {
  constexpr int EPL = kM / 32, NW = HmRows::NW;
  extern __shared__ __align__(16) unsigned char hm_sm[];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(hm_sm);
  float* sS = reinterpret_cast<float*>(hm_sm + kTile * HmRows::LDA * 2);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.y, l0 = blockIdx.x * kTile;
  const size_t base = ((size_t)b * kL + l0) * kM;
  float zz = 0.f;
  for (int s = 0; s < kNS; ++s) zz += zpart[(size_t)b * kNS + s];
  const float tau2 = zz / n;
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
    const float ai = sqi[l] / tau2;
    float v[EPL];
    float mx = -INFINITY;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      float s = sS[r * kM + lane + 32 * e];
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
    const float so = sqo[l] / warp_sum(se);
    float bb = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      v[e] = so * v[e];
      beta[off + 32 * e] = last ? v[e] * inv_sqrt_n : v[e];
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
  if (blockIdx.x == 0 && threadIdx.x == 0) trace[(size_t)t * B + b] = tau2;
}

template <typename K>
int set_smem(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// S3's column stage with as many walkers as are resident (one an SM).
template <int FB, int KIND>
int s3_col_launch(const K1Args& a, int t, cudaStream_t st) {
  auto kernel = s3_col_kernel<FB, KIND>;
  constexpr int bytes = S3Geo<FB>::SMEM;
  int rc = set_smem(kernel, bytes);
  if (rc) return rc;
  int walkers = 0;
  rc = resident_walkers<1>(kernel, kS3T, bytes, st, &walkers);
  if (rc) return rc;
  const int items = a.B * kNS;
  walkers = walkers < items ? walkers : items;
  kernel<<<walkers, kS3T, bytes, st>>>(
      static_cast<__nv_bfloat16*>(a.work), a.yc, a.zc, a.sp, a.zpart, a.bpart,
      a.trace, a.B, t, a.P, a.n * a.n);
  return (int)cudaGetLastError();
}

// K1's encode, then T iterations of S3's column stage (f_b = FB, KIND) and
// K1's row stage, or l256_m128's (HM_ROWS).
template <int FB, int KIND, bool HM_ROWS>
int run_s3(const K1Args& a, cudaStream_t st) {
  __nv_bfloat16* work = static_cast<__nv_bfloat16*>(a.work);
  int rc = k1_encode_launch<kW, kR, 1>(a.y_n, a.sp, a.sqo, nullptr, nullptr,
                                       0.f, a.yc, a.B, kM, st);
  if (!rc && HM_ROWS) rc = set_smem(s3_hm_row_kernel, kHmSmem);
  for (int t = 0; t < a.T && !rc; ++t) {
    const int last = t == a.T - 1;
    rc = s3_col_launch<FB, KIND>(a, t, st);
    if (rc) break;
    if constexpr (HM_ROWS) {
      s3_hm_row_kernel<<<dim3(kL / kTile, a.B), HmRows::THREADS, kHmSmem,
                         st>>>(work, a.beta, a.zpart, a.bpart, a.trace, a.sqi,
                               a.sqo, a.B, t, last, a.n, a.inv_sqrt_n);
      rc = (int)cudaGetLastError();
    } else {
      rc = k1_row_launch<kM, __nv_bfloat16, 1>(
          work, a.beta, a.zpart, a.bpart, a.trace, a.iters, a.active, nullptr,
          nullptr, a.sqi, a.sqo, a.B, kL, t, last, a.n, a.inv_sqrt_n, 0.f,
          st);
    }
  }
  return rc;
}

template <int V, int RV = V>
int run_s2_both(const K1Args& a, int round_bf16, cudaStream_t st) {
  return round_bf16 ? run_s2<V, __nv_bfloat16, RV>(a, st)
                    : run_s2<V, float, RV>(a, st);
}

}  // namespace

extern "C" {

// S1, S2 or S3 variant `mode` (the order of ops/amp_exp.py MODES) for B
// codewords (even for the pair), T fixed iterations, on K1's design.
// Inputs: y_n (B, L, M) the observation, read on the row support only; the
// row support as K1 takes it (ops/split_support.py, ns entries in K1's
// order): mask_c (ns,) mask/n of each entry, offset and word (L / 32, M),
// block (M / 32 + 1,); sqi, sqo (L,) sq / sqrt(n), sq sqrt(n).  Outputs:
// beta (B, L, M) true scale, trace (T, B).  Scratch: iters (B,) int32,
// active (T + 1, B) int32 all ones, yc, zc (B, ns); work (B, L, M),
// bfloat16 when round_bf16 (the transforms' operands rounded to bf16) and
// float otherwise (S1 and S2 only: S3's factors run on the bf16 tensor
// cores); zpart (B, M / 32); bpart (B, L).  L = 1024, M = 512.  Returns 0,
// a cudaError_t, or -1 for an unsupported shape or mode.
int amp_exp_run(int mode, const float* y_n, const float* mask_c,
                const int32_t* offset, const uint32_t* word,
                const int32_t* block, int ns, const float* sqi,
                const float* sqo, float* beta, float* trace, int32_t* iters,
                int32_t* active, float* yc, float* zc, void* work,
                float* zpart, float* bpart, int B, int L, int M, int T,
                float P, float n, float inv_sqrt_n, int round_bf16,
                void* stream) {
  if (L != kL || M != kM || B < 1 || B > 65535 || T < 1 || ns < 0)
    return kBadShape;
  if (mode < 0 || mode >= kModes) return kBadShape;
  if (mode >= kSlabLoop && mode < kPair && !round_bf16) return kBadShape;
  if (mode == kPair && B % 2) return kBadShape;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  K1Args a;
  a.sp.mask = mask_c;
  a.sp.offset = offset;
  a.sp.word = word;
  a.sp.block = block;
  a.sp.ns = ns;
  a.y_n = y_n;
  a.sqi = sqi;
  a.sqo = sqo;
  a.yc = yc;
  a.zc = zc;
  a.beta = beta;
  a.trace = trace;
  a.zpart = zpart;
  a.bpart = bpart;
  a.iters = iters;
  a.active = active;
  a.work = work;
  a.B = B;
  a.T = T;
  a.P = P;
  a.n = n;
  a.inv_sqrt_n = inv_sqrt_n;
  switch (mode) {
    case kFull: return run_s2_both<kK1>(a, round_bf16, st);
    case kNoSoftmax: return run_s2_both<kK1NoSoftmax>(a, round_bf16, st);
    case kNoMax: return run_s2_both<kK1NoMax>(a, round_bf16, st);
    case kNoTransform: return run_s2_both<kK1NoTransform>(a, round_bf16, st);
    case kMStageOnly: return run_s2_both<kK1MStageOnly>(a, round_bf16, st);
    case kNoNorms: return run_s2_both<kK1NoNorms>(a, round_bf16, st);
    case kSlabLoop: return run_s3<128, kLoop, false>(a, st);
    case kSlabUnroll: return run_s3<128, kUnroll, false>(a, st);
    case kSlabBatched: return run_s3<128, kBatched, false>(a, st);
    case kF512Vpu2: return run_s3<512, kVpu, false>(a, st);
    case kF256Vpu4: return run_s3<256, kVpu, false>(a, st);
    case kF128Vpu8: return run_s3<128, kVpu, false>(a, st);
    case kL256M128: return run_s3<256, kVpu, true>(a, st);
    case kPair: return run_s2_both<kK1, kK1Pair>(a, round_bf16, st);
    default: return kBadShape;
  }
}

const char* amp_exp_error_string(int code) {
  if (code == kBadShape) return "unsupported shape or mode";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
