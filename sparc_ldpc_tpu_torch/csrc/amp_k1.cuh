// K1's iteration launches (the split form's column and row stages,
// amp_split.cu), shared by K1 itself and by its stage ablation S2
// (amp_exp.cu): the same templates, with a compile-time variant V whose
// default, kK1, is K1.  Each other variant drops one stage of the
// iteration at compile time and keeps everything else of K1's design (the
// walker, the cp.async prefetch, y and z on the row support, the template
// M, the warp-per-row row stage, the (T + 1, B) active table):
//   kK1NoSoftmax   beta' = (sqi / tau2) (H z + beta') 1e-3 sqrt(n): no
//                  max, exp or sums in the row stage (the script's
//                  beta = s (sq / tau2) 1e-3 in the scale-free form);
//   kK1NoMax       the softmax without its row max (exp overflows);
//   kK1NoTransform no H_L in the column stage and no H_M in the row
//                  stage: the work tile carries beta' and z themselves
//                  (rounded to bf16 when it is bf16);
//   kK1MStageOnly  no H_L: the column stage passes the work tile through;
//   kK1NoNorms     coef = 0.1 and tau2 = 0.5: no |beta'|^2 or |z|^2
//                  partials and no pass over them;
//   kK1Pair        (the row stage only; S1, the pair) a warp takes section
//                  row l of codewords 2 p and 2 p + 1 and issues each phase
//                  (load, H_M, max, exp, sum, store, the next H_M) for both
//                  before the next; per codeword K1's arithmetic, so K1's
//                  bits.  The column stage stays K1's own: its walker holds
//                  one codeword's strip (two 192 KB at L = 1024 would not
//                  fit an SM).
// The ablations run at L <= 1024 only (no cluster).  See amp_split.cu for
// K1's algorithm, layout and what bounds each stage.

#pragma once

#include "amp_support.cuh"

namespace {

enum K1Variant {
  kK1 = 0, kK1NoSoftmax, kK1NoMax, kK1NoTransform, kK1MStageOnly, kK1NoNorms,
  kK1Pair
};

// codewords a row-stage block
__host__ __device__ constexpr int k1_row_cw(int v) {
  return v == kK1Pair ? 2 : 1;
}

constexpr int kRowThreads = 256;   // threads per row-stage block

// Dynamic shared memory of the column stage: the float32 transpose buffer,
// the bf16 staging of the next strip (bf16 work tiles only), y, z and
// mask/n of the next item's entries, and each thread's word and first
// entry.
template <int W, int R, typename WT>
__host__ __device__ constexpr int col_smem_bytes() {
  return W * R * kStrip * 4 + (IsBf16<WT>::value ? W * R * kStrip * 2 : 0) +
         3 * entry_cap<W, R>() * 4 + 2 * 32 * W * 4;
}

// Column stage of iteration t.  work holds H_M beta' (the forward
// transform's first stage, from the row stage) on entry and H_L z, rounded
// to bf16 when the work tile is bf16, on exit; z (B, ns) is updated on the
// support.  Grid (FA * walkers), as many walkers as are resident at once:
// walker i (a block, or a cluster of FA blocks above L = 1024) takes the
// items (codeword, strip) i, i + walkers, ... of the active codewords,
// item it = b * M / 32 + strip.  While it transforms one item, cp.async
// brings the next one's bf16 strip and its support data (y, z, mask/n,
// each thread's word and first entry) into shared memory; every load on an
// item's critical path is from shared memory but the row |beta'|^2
// partials, whose sum for the next item is taken in the same reduction as
// this item's |z|^2.  Without H_L (kK1NoTransform, kK1MStageOnly) the
// strip is read and written in layout B, the residual's.
template <int W, int R, int FA, int M, typename WT, int V = kK1>
__global__ void __launch_bounds__(32 * W, 1)
k1_col_kernel(WT* __restrict__ work, const float* __restrict__ yc,
              float* __restrict__ zc, Support sp,
              float* __restrict__ zpart,        // (B, FA * M / 32)
              const float* __restrict__ bpart,  // (B, L) row |beta'|^2
              const float* __restrict__ trace,  // (T, B)
              const int32_t* __restrict__ active,  // (T + 1, B)
              int B, int t, float P, float nn) {
  extern __shared__ __align__(16) float k1_sm[];
  __shared__ float red[2 * W];
  constexpr int kRound = IsBf16<WT>::value;
  constexpr bool kStage = IsBf16<WT>::value != 0;
  constexpr bool HL = V != kK1NoTransform && V != kK1MStageOnly;
  constexpr bool NORMS = V != kK1NoNorms;
  static_assert(V == kK1 || FA == 1, "the ablations run at L <= 1024");
  constexpr int L = FA * W * R, LB = W * R, NT = 32 * W, S = M / kStrip;
  constexpr int CAP = entry_cap<W, R>();
  // transpose buffer, bf16 stage, then the next item's support data
  float* sm = k1_sm;
  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(sm + LB * kStrip);
  float* ys = sm + LB * kStrip + (kStage ? LB * kStrip / 2 : 0);
  float* zs = ys + CAP;
  float* ms = zs + CAP;
  uint32_t* tword = reinterpret_cast<uint32_t*>(ms + CAP);
  int32_t* toff = reinterpret_cast<int32_t*>(tword + NT);
  const int w = threadIdx.x >> 5, c = threadIdx.x & 31;
  const int a = blockIdx.x % FA, walkers = gridDim.x / FA;
  const int l0 = a * LB;
  const int items = B * S;
  const int32_t* act = active + (size_t)t * B;
  // the walker's next item of an active codeword from it on; the same in
  // every block of a cluster
  auto next = [&](int it) {
    while (it < items && !act[it / S]) it += walkers;
    return it;
  };
  // cp.async of an item's bf16 strip, 16 bytes a thread
  auto fetch_work = [&](int it) {
    const WT* src = work + ((size_t)(it / S) * L + l0) * M + (it % S) * kStrip;
    for (int q = threadIdx.x; q < LB * 4; q += NT) {
      const int r = q >> 2, p = q & 3;
      cp_async16(stage + r * kStrip + 8 * p, src + (size_t)r * M + 8 * p);
    }
  };
  // cp.async of an item's support data: the thread's word and first entry,
  // and the block's entries of y, mask/n and z (iteration 0 reads no z),
  // unless they exceed the shared buffers (then read where they are)
  auto fetch_entries = [&](int it) {
    const int s = it % S, ib = s * FA + a;
    const size_t tab = (size_t)(a * W + w) * M + s * kStrip + c;
    cp_async4(tword + threadIdx.x, sp.word + tab);
    cp_async4(toff + threadIdx.x, sp.offset + tab);
    const int first = sp.block[ib], count = sp.block[ib + 1] - first;
    if (count > CAP) return;
    const size_t off = (size_t)(it / S) * sp.ns + first;
    for (int i = threadIdx.x; i < count; i += NT) {
      cp_async4(ys + i, yc + off + i);
      cp_async4(ms + i, sp.mask + first + i);
      if (t > 0) cp_async4(zs + i, zc + off + i);
    }
  };
  // this thread's terms of an item's |beta'|^2 (the row partials)
  auto bterms = [&](int it) {
    float acc = 0.f;
    if (t > 0 && it < items) {
      const float* bp = bpart + (size_t)(it / S) * L;
      for (int l = threadIdx.x; l < L; l += NT) acc += bp[l];
    }
    return acc;
  };
  // the strip row of register k: layout A with H_L, layout B without
  auto srow = [&](int k) { return HL ? w + W * k : R * w + k; };

  int it = next(blockIdx.x / FA);
  if (it >= items) return;  // uniform per cluster
  if constexpr (kStage) {
    if (t > 0) fetch_work(it);
  }
  fetch_entries(it);
  float bnorm2 = 0.f;
  if constexpr (NORMS) bnorm2 = block_sum2<W>(bterms(it), 0.f, red).x;
  while (it < items) {
    const int nx = next(it + walkers);
    const int b = it / S, s = it % S, ib = s * FA + a;
    const int m = s * kStrip + c;
    const int first = sp.block[ib];
    const bool staged = sp.block[ib + 1] - first <= CAP;
    const float tau2_prev = t > 0 ? trace[(size_t)(t - 1) * B + b] : 1.f;
    float bnext = 0.f;  // consumed after this item's residual
    if constexpr (NORMS) bnext = bterms(nx);
    // every cluster block's support word and first entry of this thread's
    // rows, for the adjoint's sparse H_FA (none at FA = 1)
    uint32_t words[FA];
    int offs[FA];
#pragma unroll
    for (int a2 = 0; a2 < FA; ++a2) {
      const size_t tab2 = (size_t)(a2 * W + w) * M + m;
      words[a2] = FA > 1 ? sp.word[tab2] : 0u;
      offs[a2] = FA > 1 ? sp.offset[tab2] : 0;
    }
    cp_async_wait_all();
    __syncthreads();  // this item's staged data is visible
    const uint32_t word = tword[threadIdx.x];
    float v[R];
    float coef = 0.f;  // beta' = 0 and z = 0 before the first iteration
    if (t > 0) {
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const int r = srow(k);
        if constexpr (kStage)
          v[k] = to_f32(stage[r * kStrip + c]);
        else
          v[k] = to_f32(work[((size_t)b * L + l0 + r) * M + m]);
      }
      if constexpr (kStage) {
        __syncthreads();  // every thread has read the stage
        if (nx < items) fetch_work(nx);
      }
      if constexpr (NORMS)
        coef = (P - bnorm2 / nn) / tau2_prev;
      else
        coef = 0.1f;
      if constexpr (HL) {
        reg_fwht<R, R>(v);
        a_to_b<W, R>(v, sm, w, c);
        reg_fwht<R, W>(v);
        k1_cluster_on_support<FA, R, false>(v, sm, a, word);
      }
    } else {
#pragma unroll
      for (int k = 0; k < R; ++k) v[k] = 0.f;
    }
    // the residual on the thread's support rows (layout B: rows R w + k),
    // in the dense design's row order; off the support z and the adjoint's
    // input are 0
    const size_t cw = (size_t)b * sp.ns;
    const float* ysrc = staged ? ys - first : yc + cw;
    const float* zsrc = staged ? zs - first : zc + cw;
    const float* msrc = staged ? ms - first : sp.mask;
    const int e0 = toff[threadIdx.x];
    float zz = 0.f;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      float zk = 0.f;
      if ((word >> k) & 1u) {
        const int e = e0 + __popc(word & ((1u << k) - 1u));
        zk = ysrc[e] - msrc[e] * v[k];
        if (t > 0) zk += coef * zsrc[e];
        zc[cw + e] = zk;
        zz += zk * zk;
      }
      v[k] = maybe_round(zk, kRound);
    }
    // this item's |z|^2 and the next item's |beta'|^2; the barriers also
    // end every thread's reads of the support data
    float2 sums = make_float2(0.f, 0.f);
    if constexpr (NORMS) {
      sums = block_sum2<W>(zz, bnext, red);
      if (threadIdx.x == 0) zpart[(size_t)b * (FA * S) + ib] = sums.x;
    } else {
      __syncthreads();
    }
    if (nx < items) fetch_entries(nx);
    if constexpr (FA > 1) {
      // the adjoint's H_FA first, on its sparse input: the other blocks'
      // values are their z of this item, rounded as they round them, read
      // where they have a support row.  (The dense design took H_1024 first
      // and H_FA of its dense results: the same sums in another order.)
      cg::this_cluster().sync();  // every block's z of this item is written
#pragma unroll
      for (int k = 0; k < R; ++k) {
        float x = 0.f;
#pragma unroll
        for (int a2 = 0; a2 < FA; ++a2) {
          float y = 0.f;
          if (a2 == a) {
            y = v[k];
          } else if ((words[a2] >> k) & 1u) {
            const int e = offs[a2] + __popc(words[a2] & ((1u << k) - 1u));
            y = maybe_round(__ldcg(zc + cw + e), kRound);
          }
          x = (__popc(a & a2) & 1) ? x - y : x + y;
        }
        v[k] = x;
      }
    }
    if constexpr (HL) {
      reg_fwht<R, W>(v);
      b_to_a<W, R>(v, sm, w, c);
      reg_fwht<R, R>(v);
    }
#pragma unroll
    for (int k = 0; k < R; ++k)
      work[((size_t)b * L + l0 + srow(k)) * M + m] = from_f32<WT>(v[k]);
    bnorm2 = sums.y;
    it = nx;
  }
}

// Row stage, one warp per section row: lane j holds NCH chunks of C
// adjacent columns, chunk i at columns C j + C TPR i (TPR lanes a row, 32
// at M >= 128; at M < 128 a warp holds 32 / TPR rows), so column bits
// 0 .. log2(C) - 1 are inside a chunk, the next log2(TPR) are the lane and
// the rest the chunk.
template <int M>
struct RowShape {
  static constexpr int VPL = M / 32 < 4 ? 4 : M / 32;  // values a lane
  static constexpr int TPR = M / VPL;                  // lanes a row
  static constexpr int C = VPL < 8 ? VPL : 8;          // columns a chunk
  static constexpr int NCH = VPL / C;                  // chunks a lane
  static constexpr int RPB = (kRowThreads / 32) * (32 / TPR);  // rows a block
  __device__ static int col(int j, int i) { return C * j + C * TPR * (i / C) + i % C; }
};

// H_M of a row in registers and shuffles, bits in ascending order (the
// butterflies of row_fwht, so the same values).
template <int M>
__device__ __forceinline__ void warp_row_fwht(float (&v)[RowShape<M>::VPL],
                                              int j) {
  using Sh = RowShape<M>;
  constexpr int VPL = Sh::VPL;
  reg_fwht<VPL, Sh::C>(v);
#pragma unroll
  for (int mk = 1; mk < Sh::TPR; mk <<= 1) {
    const bool hi = (j & mk) != 0;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const float o = __shfl_xor_sync(0xffffffffu, v[i], mk);
      v[i] = hi ? o - v[i] : v[i] + o;
    }
  }
#pragma unroll
  for (int h = Sh::C; h < VPL; h <<= 1) {
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      if ((i & h) == 0) {
        const float x = v[i], y = v[i + h];
        v[i] = x + y;
        v[i + h] = x - y;
      }
    }
  }
}

// Max or sum over a row's values, in the order of the earlier 4-column
// threads: each 4 adjacent columns in sequence (the caller's partials p, one
// per group of 4), then an xor tree over the groups' index bits up to 32
// groups, then those trees' results (one per 128 columns) in sequence.
// Every lane of the row gets it.
template <int M, bool IS_MAX>
__device__ __forceinline__ float warp_row_reduce(
    const float (&p)[RowShape<M>::VPL / 4]) {
  using Sh = RowShape<M>;
  auto op = [](float x, float y) { return IS_MAX ? fmaxf(x, y) : x + y; };
  if constexpr (Sh::C == 4) {  // M <= 128: a group a lane, one tree
    float x = p[0];
#pragma unroll
    for (int mk = 1; mk < Sh::TPR; mk <<= 1)
      x = op(x, __shfl_xor_sync(0xffffffffu, x, mk));
    return x;
  } else {  // M >= 256: group bit 0 in the lane, bits 1-4 lane bits 0-3
    float part[Sh::NCH];
#pragma unroll
    for (int i = 0; i < Sh::NCH; ++i) {
      float x = op(p[2 * i], p[2 * i + 1]);
#pragma unroll
      for (int mk = 1; mk < 16; mk <<= 1)
        x = op(x, __shfl_xor_sync(0xffffffffu, x, mk));
      part[i] = x;
    }
    // the trees of 128 columns, in column order: (chunk i, lane half h)
    const bool upper = (threadIdx.x & 16) != 0;
    float x = 0.f;
#pragma unroll
    for (int i = 0; i < Sh::NCH; ++i) {
      const float o = __shfl_xor_sync(0xffffffffu, part[i], 16);
      const float lo = upper ? o : part[i], hi = upper ? part[i] : o;
      x = i == 0 ? lo : op(x, lo);
      x = op(x, hi);
    }
    return x;
  }
}

template <int C>
__device__ __forceinline__ void load_chunk(float* v, const float* p) {
#pragma unroll
  for (int q = 0; q < C; q += 4) {
    const float4 x = *reinterpret_cast<const float4*>(p + q);
    v[q] = x.x;
    v[q + 1] = x.y;
    v[q + 2] = x.z;
    v[q + 3] = x.w;
  }
}

template <int C>
__device__ __forceinline__ void store_chunk(float* p, const float* v) {
#pragma unroll
  for (int q = 0; q < C; q += 4)
    *reinterpret_cast<float4*>(p + q) =
        make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]);
}

template <int C>
__device__ __forceinline__ void load_chunk(float* v, const __nv_bfloat16* p) {
  if constexpr (C == 8) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const unsigned u[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 f =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[q]));
      v[2 * q] = f.x;
      v[2 * q + 1] = f.y;
    }
  } else {
    static_assert(C == 4, "chunks of 4 or 8 columns");
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    const unsigned u[2] = {x.x, x.y};
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float2 f =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[q]));
      v[2 * q] = f.x;
      v[2 * q + 1] = f.y;
    }
  }
}

template <int C>
__device__ __forceinline__ void store_chunk(__nv_bfloat16* p, const float* v) {
  unsigned u[C / 2];
#pragma unroll
  for (int q = 0; q < C / 2; ++q) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
    u[q] = *reinterpret_cast<const unsigned*>(&h);
  }
  if constexpr (C == 8)
    *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
  else
    *reinterpret_cast<uint2*>(p) = make_uint2(u[0], u[1]);
}

// Row stage of iteration t.  work holds H_L z on entry and, unless this is
// the codeword's last iteration, H_M beta'_new (the next forward
// transform) on exit.  beta holds beta' and, after the codeword's last
// iteration, the true-scale beta.  Grid (L / RPB, B / C): C codewords a
// block (kK1Pair: 2, at fixed T, without pins).
template <int M, typename WT, int FA, int V = kK1>
__global__ void __launch_bounds__(kRowThreads)
k1_row_kernel(WT* __restrict__ work, float* __restrict__ beta,
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
  using Sh = RowShape<M>;
  constexpr int VPL = Sh::VPL, C = Sh::C, NCH = Sh::NCH, NG = VPL / 4;
  // NS |z|^2 partials, one per column-stage block of the codeword
  constexpr int NS = FA * M / kStrip;
  constexpr int kRound = IsBf16<WT>::value;
  constexpr bool HM = V != kK1NoTransform;
  constexpr bool NORMS = V != kK1NoNorms;
  constexpr int CW = k1_row_cw(V);
  const int lane = threadIdx.x & 31;
  const int j = lane % Sh::TPR;
  const int r = (threadIdx.x >> 5) * (32 / Sh::TPR) + lane / Sh::TPR;
  const int b0 = blockIdx.y * CW;
  const int l = blockIdx.x * Sh::RPB + r;
  size_t row[CW];
  float tau2_prev[CW];
#pragma unroll
  for (int cw = 0; cw < CW; ++cw) {
    row[cw] = ((size_t)(b0 + cw) * L + l) * M;
    tau2_prev[cw] = t > 0 ? trace[(size_t)(t - 1) * B + b0 + cw] : INFINITY;
  }
  const bool lead = blockIdx.x == 0 && threadIdx.x == 0;

  if (!active[(size_t)t * B + b0]) {  // frozen: uniform per block
    if (lead) {
#pragma unroll
      for (int cw = 0; cw < CW; ++cw) {
        trace[(size_t)t * B + b0 + cw] = tau2_prev[cw];
        active[(size_t)(t + 1) * B + b0 + cw] = 0;
      }
    }
    return;
  }
  float tau2[CW];
  bool conv = false;
#pragma unroll
  for (int cw = 0; cw < CW; ++cw) {
    if constexpr (!NORMS) {
      tau2[cw] = 0.5f;
    } else if (sched != nullptr) {
      tau2[cw] = sched[t];
    } else {
      float zz = 0.f;
      for (int s = 0; s < NS; ++s) zz += zpart[(size_t)(b0 + cw) * NS + s];
      tau2[cw] = zz / n;
    }
    conv = conv || fabsf(tau2[cw] - tau2_prev[cw]) < tol * tau2[cw];
  }
  const bool fin = last || conv;  // this codeword's last iteration

  float v[CW][VPL];
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
#pragma unroll
    for (int cw = 0; cw < CW; ++cw)
      load_chunk<C>(v[cw] + C * i, work + row[cw] + Sh::col(j, C * i));
  }
  if constexpr (HM) {
#pragma unroll
    for (int cw = 0; cw < CW; ++cw) warp_row_fwht<M>(v[cw], j);
  }
  if (t > 0) {
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
#pragma unroll
      for (int cw = 0; cw < CW; ++cw) {
        float bo[C];
        load_chunk<C>(bo, beta + row[cw] + Sh::col(j, C * i));
#pragma unroll
        for (int q = 0; q < C; ++q) v[cw][C * i + q] += bo[q];
      }
    }
  }
  float p[CW][NG];
  if constexpr (V == kK1NoSoftmax) {
    const float s = 1e-3f / inv_sqrt_n;
#pragma unroll
    for (int cw = 0; cw < CW; ++cw) {
      const float ai = sqi[l] / tau2[cw];
#pragma unroll
      for (int i = 0; i < VPL; ++i) v[cw][i] = (ai * v[cw][i]) * s;
    }
  } else {
    float mx[CW];
#pragma unroll
    for (int cw = 0; cw < CW; ++cw) {
      const float ai = sqi[l] / tau2[cw];
      mx[cw] = 0.f;
      if constexpr (V != kK1NoMax) {
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          float gm = -INFINITY;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            v[cw][4 * g + q] = ai * v[cw][4 * g + q];
            gm = fmaxf(gm, v[cw][4 * g + q]);
          }
          p[cw][g] = gm;
        }
      } else {
#pragma unroll
        for (int i = 0; i < VPL; ++i) v[cw][i] = ai * v[cw][i];
      }
    }
    if constexpr (V != kK1NoMax) {
#pragma unroll
      for (int cw = 0; cw < CW; ++cw)
        mx[cw] = warp_row_reduce<M, true>(p[cw]);
    }
#pragma unroll
    for (int cw = 0; cw < CW; ++cw) {
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        float se = 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          v[cw][4 * g + q] = V == kK1NoMax ? expf(v[cw][4 * g + q])
                                           : expf(v[cw][4 * g + q] - mx[cw]);
          se += v[cw][4 * g + q];
        }
        p[cw][g] = se;
      }
    }
    float so[CW];
#pragma unroll
    for (int cw = 0; cw < CW; ++cw)
      so[cw] = sqo[l] / warp_row_reduce<M, false>(p[cw]);
#pragma unroll
    for (int cw = 0; cw < CW; ++cw) {
#pragma unroll
      for (int i = 0; i < VPL; ++i) v[cw][i] = so[cw] * v[cw][i];
    }
  }
  if (pin != nullptr) {
#pragma unroll
    for (int cw = 0; cw < CW; ++cw) {
      const int pc = pin[(size_t)(b0 + cw) * L + l];
      if (pc >= 0) {
#pragma unroll
        for (int i = 0; i < VPL; ++i)
          v[cw][i] = (Sh::col(j, i) == pc) ? sqo[l] : 0.f;
      }
    }
  }
  if (fin) {
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
#pragma unroll
      for (int cw = 0; cw < CW; ++cw) {
        float out[C];
#pragma unroll
        for (int q = 0; q < C; ++q) out[q] = v[cw][C * i + q] * inv_sqrt_n;
        store_chunk<C>(beta + row[cw] + Sh::col(j, C * i), out);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
#pragma unroll
      for (int cw = 0; cw < CW; ++cw)
        store_chunk<C>(beta + row[cw] + Sh::col(j, C * i), v[cw] + C * i);
    }
    if constexpr (NORMS) {
#pragma unroll
      for (int cw = 0; cw < CW; ++cw) {
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          float bb = 0.f;
#pragma unroll
          for (int q = 0; q < 4; ++q)
            bb += v[cw][4 * g + q] * v[cw][4 * g + q];
          p[cw][g] = bb;
        }
      }
#pragma unroll
      for (int cw = 0; cw < CW; ++cw) {
        const float bb = warp_row_reduce<M, false>(p[cw]);
        if (j == 0) bpart[(size_t)(b0 + cw) * L + l] = bb;
      }
    }
#pragma unroll
    for (int cw = 0; cw < CW; ++cw) {
#pragma unroll
      for (int i = 0; i < VPL; ++i) v[cw][i] = maybe_round(v[cw][i], kRound);
    }
    if constexpr (HM) {
#pragma unroll
      for (int cw = 0; cw < CW; ++cw) warp_row_fwht<M>(v[cw], j);
    }
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
#pragma unroll
      for (int cw = 0; cw < CW; ++cw)
        store_chunk<C>(work + row[cw] + Sh::col(j, C * i), v[cw] + C * i);
    }
  }
  if (lead) {
#pragma unroll
    for (int cw = 0; cw < CW; ++cw) {
      trace[(size_t)t * B + b0 + cw] = tau2[cw];
      active[(size_t)(t + 1) * B + b0 + cw] = fin ? 0 : 1;
      if (fin) iters[b0 + cw] = t + 1;
    }
  }
}

// ------------------------------------------------------------- launchers

// K1's compact encode (amp_support.cuh k1_encode_kernel) for the column
// geometry (W, R, FA): grid (FA * M / 32, B).
template <int W, int R, int FA>
int k1_encode_launch(const float* y_n, const Support& sp, const float* sqo,
                     const int32_t* enc_idx, const uint32_t* seeds,
                     float sigma, float* yc, int B, int M, cudaStream_t st) {
  auto kernel = k1_encode_kernel<W, R, FA>;
  const int bytes = W * R * kStrip * (int)sizeof(float);
  int rc = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc) return rc;
  ClusterLaunch<FA> lc(dim3(FA * (M / kStrip), B), 32 * W, bytes, st);
  rc = (int)cudaLaunchKernelEx(&lc.cfg, kernel, y_n, sp, sqo, enc_idx, seeds,
                               sigma, yc, M);
  return rc ? rc : (int)cudaGetLastError();
}

// The column stage with as many walkers as can be resident at once (one
// block, or one cluster, per walker), at most one per item.
template <int W, int R, int FA, int M, typename WT, int V = kK1>
int k1_col_launch(WT* work, const float* yc, float* zc, const Support& sp,
                  float* zpart, const float* bpart, const float* trace,
                  const int32_t* active, int B, int t, float P, float nn,
                  cudaStream_t st) {
  auto kernel = k1_col_kernel<W, R, FA, M, WT, V>;
  constexpr int bytes = col_smem_bytes<W, R, WT>();
  int rc = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc) return rc;
  const int items = B * (M / kStrip);
  int walkers = 0;
  rc = resident_walkers<FA>(kernel, 32 * W, bytes, st, &walkers);
  if (rc) return rc;
  walkers = walkers < items ? walkers : items;
  ClusterLaunch<FA> lc(dim3(FA * walkers), 32 * W, bytes, st);
  rc = (int)cudaLaunchKernelEx(&lc.cfg, kernel, work, yc, zc, sp, zpart,
                               bpart, trace, active, B, t, P, nn);
  return rc ? rc : (int)cudaGetLastError();
}

// The row stage: grid (L / RPB, B / codewords a block).
template <int M, typename WT, int FA, int V = kK1>
int k1_row_launch(WT* work, float* beta, const float* zpart, float* bpart,
                  float* trace, int32_t* iters, int32_t* active,
                  const int32_t* pin, const float* sched, const float* sqi,
                  const float* sqo, int B, int L, int t, int last, float n,
                  float inv_sqrt_n, float tol, cudaStream_t st) {
  k1_row_kernel<M, WT, FA, V>
      <<<dim3(L / RowShape<M>::RPB, B / k1_row_cw(V)), kRowThreads, 0, st>>>(
          work, beta, zpart, bpart, trace, iters, active, pin, sched, sqi,
          sqo, B, L, t, last, n, inv_sqrt_n, tol);
  return (int)cudaGetLastError();
}

}  // namespace
