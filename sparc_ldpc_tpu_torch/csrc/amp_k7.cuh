// K7's iteration launches (the slab form's C1, R2C2 and R3, amp_slab.cu),
// shared by K7 itself and by its stage ablation S4 (amp_slab_exp.cu): the
// same templates, with a compile-time variant V whose default, kK7, is K7.
// Each other variant changes one thing of K7's design and keeps the rest
// (the walkers, the cp.async prefetch, y and z on the row support in K1's
// tables, the sparse adjoint from the compact z, the tensor-core H_{f_b}
// and H_{m_b} with +-1 fragments made in registers, the per-slab
// reductions, the (T + 1, B) active table).  What each variant changes, by
// launch (K7: no change):
//   kK7NoRadix     C1, R2C2: no H_{f_a}; R3: no H_{m_a};
//   kK7NoMm        C1, R2C2: no H_{f_b} products, H_{f_a} on the bf16
//                  values they would read; R3: the same for H_{m_b};
//   kK7Bf16Radix   C1, R2C2: H_{f_a} on bf16; R3: H_{m_a} on bf16;
//   kK7MidBf16     R3: the H_{m_b} products rounded to bf16, H_{m_a} on
//                  bf16;
//   kK7NoSoftmax   R3: beta' = (sqi / tau2) (u + beta') 1e-3 sqrt(n);
//   kK7NoConsume   C1: z = H(beta') on the support (no y, mask/n or z
//                  read, no Onsager term); R3 as kK7NoSoftmax;
//   kK7FoldHfb     C1: H_{f_b}'s fragments hold +-bf16(1 / sqrt(n)) (the
//                  caller's mask entries mask / sqrt(n));
//   kK7NoTrace     C1, R3: tau2 carried in two rows (t % 2), no trace;
//   kK7Exp2        R3: exp as exp2f(x log2(e));
//   kK7Sched       C1: no |z|^2 partials (R3 reads the schedule, K7's);
//   kK7Compact, kK7Compact32  the support the first csub (f_b, 32) rows:
//                  C1 sums the strip's f_a slabs (float32, slab order),
//                  rounds to bf16 and takes H_{f_b}[0:csub, :] of the sum,
//                  the residual on those rows; R2C2 builds the strip's csub
//                  rows and takes H_{f_b}[:, 0:csub] into one slab of u a
//                  codeword; R3 adds that slab to every slab;
//   kK7Pair        R2C2, R3: two codewords an item (R2C2: both strips
//                  built, each row's two sums interleaved, then each
//                  codeword's products; its entries read from device
//                  memory: two strips leave no room to stage them); R3:
//                  each phase for both codewords before the next.
// The geometry (SlabGeo) also takes f_b (64, 128, 256 at L = 1024: FAL =
// L / f_b slabs a block) and, for f_b = 256, two (16-row, 8-column) tile
// pairs a warp; R3 takes m_b (128, 256, 512).  See amp_slab.cu for K7's
// algorithm, layout and bytes.

#pragma once

#include "amp_mma.cuh"
#include "amp_support.cuh"

namespace {

enum K7Variant {
  kK7 = 0, kK7NoRadix, kK7NoMm, kK7Bf16Radix, kK7MidBf16, kK7NoSoftmax,
  kK7NoConsume, kK7FoldHfb, kK7NoTrace, kK7Exp2, kK7Sched, kK7Compact,
  kK7Compact32, kK7Pair
};

constexpr int kSlabRows = 128;  // f_b at L >= 128
constexpr int kXchg = 8;        // values a thread exchanges a cluster round
constexpr int kAdjCap = 11264;  // packed z entries R2C2 stages a block
constexpr float kLog2e = 1.4426950408889634f;

// the H stage (amp_mma.cuh HStage) of a variant's H_L and of its R3's H_M
__host__ __device__ constexpr int k7_col_h(int v) {
  return v == kK7NoRadix     ? kHNoRadix
         : v == kK7NoMm      ? kHNoMm
         : v == kK7Bf16Radix ? kHBf16Radix
                             : kHProducts;
}
__host__ __device__ constexpr int k7_row_h(int v) {
  return (v == kK7Bf16Radix || v == kK7MidBf16) ? kHBf16Radix : k7_col_h(v);
}
// the compact layouts' support rows at slab height fb (0: not compact)
__host__ __device__ constexpr int k7_csub(int v, int fb) {
  return v == kK7Compact ? fb : v == kK7Compact32 ? 32 : 0;
}
// codewords an item of R2C2, a block of R3
__host__ __device__ constexpr int k7_cw(int v) { return v == kK7Pair ? 2 : 1; }
// the trace row of iteration t
__host__ __device__ constexpr int k7_row(int v, int t) {
  return v == kK7NoTrace ? (t & 1) : t;
}

// The column launches' geometry for L = CL * FAL * FB: a block owns FAL
// slabs of FB rows (LB rows, 1024 at most) of a 32-column strip, block c of
// a cluster of CL rows [c LB, (c + 1) LB).  A warp owns PPW (16-row tile i,
// 8-column tile j) pairs of every slab: FB / 4 / PPW warps.
template <int FB_, int FAL_, int CL_, int PPW_ = 1>
struct SlabGeo {
  static constexpr int FB = FB_, FAL = FAL_, CL = CL_, PPW = PPW_;
  static constexpr int LB = FAL * FB, L = CL * LB, FA = CL * FAL;
  static constexpr int NW = FB / 4 / PPW, NT = 32 * NW;
  // the support tables' row range (ops/split_support.py split_geometry)
  static constexpr int RR = L <= 64 ? 8 : L <= 256 ? 16 : 32;
  static constexpr int XBYTES = LB * kLdX * 2;           // one bf16 strip
  static constexpr int SCBYTES = CL > 1 ? kXchg * NT * 4 : 0;
  static constexpr int CAP = CL > 1 ? 1024 : 2048;       // C1's staged entries
  // C1: two strips, the cluster exchange, two sets of y, z, mask/n
  static constexpr int C1_BYTES = 2 * XBYTES + SCBYTES + 2 * 3 * CAP * 4;
  // R2C2: one strip, the exchange, the row offsets, the staged entries
  static constexpr int ADJ_BYTES = XBYTES + SCBYTES + (LB + 4) * 4 +
                                   kAdjCap * 8;
};

// R2C2's dynamic shared memory at variant V: two strips and no staged
// entries for the pair
template <class G, int V>
__host__ __device__ constexpr int adj_bytes() {
  return k7_cw(V) == 1 ? G::ADJ_BYTES
                       : 2 * G::XBYTES + G::SCBYTES + (G::LB + 4) * 4;
}

// bf16(z) with its column m (< 2^16) in one word: the bf16 bits above, so
// the word with its low half cleared is the float bf16(z) (amp_mono.cu's).
__device__ __forceinline__ uint32_t pack_entry(float z, int m) {
  return ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(z)) << 16) |
         (uint32_t)m;
}

// d = H_{f_b}[16 i .. 16 i + 15][0:K] X[0:K][8 j .. 8 j + 7] for the slab
// of bf16 rows at sx (kLdX a row) on mma.sync m16n8k16 (g = lane / 4,
// q = lane % 4): the A operand H_{f_b}[16 i + r][16 kk + k] =
// (-1)^(popc(i & kk) + popc(r & k)), the base 16 x 16 fragment ha negated
// as a whole when popc(i & kk) is odd; the B operand X[16 kk + k][8 j + n],
// two k-steps an ldmatrix.  d holds rows 16 i + g and + 8, columns 8 j +
// 2 q and + 1.
template <int K>
__device__ __forceinline__ void hfb_tile(const __nv_bfloat16* sx,
                                         float (&d)[4], int i, int j,
                                         const uint32_t (&ha)[4]) {
  const int lane = threadIdx.x & 31;
  d[0] = d[1] = d[2] = d[3] = 0.f;
#pragma unroll
  for (int k2 = 0; k2 < K / 32; ++k2) {
    uint32_t r[4];
    ldsm_x4_t(r, sx + (32 * k2 + lane) * kLdX + 8 * j);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t sg = (__popc(i & (2 * k2 + h)) & 1) ? kNeg : 0u;
      mma_bf16(d[0], d[1], d[2], d[3], ha[0] ^ sg, ha[1] ^ sg, ha[2] ^ sg,
               ha[3] ^ sg, r[2 * h], r[2 * h + 1]);
    }
  }
}

// H_{f_b}'s base fragment: +-1, or +-c with pos the bf16 bits of c
template <bool SCALED>
__device__ __forceinline__ void hfb_frag(uint32_t (&ha)[4], uint32_t pos) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  if constexpr (SCALED) {
    ha[0] = h_pair_c(g, 2 * q, pos);
    ha[1] = h_pair_c(g + 8, 2 * q, pos);
    ha[2] = h_pair_c(g, 2 * q + 8, pos);
    ha[3] = h_pair_c(g + 8, 2 * q + 8, pos);
  } else {
    ha[0] = h_pair(g, 2 * q);
    ha[1] = h_pair(g + 8, 2 * q);
    ha[2] = h_pair(g, 2 * q + 8);
    ha[3] = h_pair(g + 8, 2 * q + 8);
  }
}

// H_L of the block's bf16 strip sx (LB rows of kLdX) at tile pair (i, j):
// D = H_{f_b} X of its tile in every slab a (hfb_tile; kHNoMm: the values
// the product would read), then H_{f_a} across the block's slabs in
// registers (in the form HS) and across the cluster's blocks (rank c)
// through distributed shared memory.
template <class G, int HS>
__device__ __forceinline__ void slab_hl(const __nv_bfloat16* sx,
                                        float (&acc)[G::FAL][4], float* sc,
                                        int c, int i, int j,
                                        const uint32_t (&ha)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int a = 0; a < G::FAL; ++a) {
    if constexpr (HS == kHNoMm) {
      const __nv_bfloat16* px =
          sx + (a * G::FB + kTile * i + g) * kLdX + 8 * j + 2 * q;
      const float2 lo = bf16x2_at(px), hi = bf16x2_at(px + 8 * kLdX);
      acc[a][0] = lo.x;
      acc[a][1] = lo.y;
      acc[a][2] = hi.x;
      acc[a][3] = hi.y;
    } else {
      hfb_tile<G::FB>(sx + a * G::FB * kLdX, acc[a], i, j, ha);
    }
  }
  radix_fwht<HS, G::FAL>(acc);  // H_{f_a} across the block's slabs
  if constexpr (G::CL > 1) {
    // the rest of H_{f_a} across the cluster, kXchg values at a time
#pragma unroll
    for (int ch = 0; ch < G::FAL * 4 / kXchg; ++ch) {
      float v[kXchg];
#pragma unroll
      for (int e = 0; e < kXchg; ++e)
        v[e] = acc[(ch * kXchg + e) / 4][(ch * kXchg + e) % 4];
      cluster_fwht<G::CL, kXchg>(v, sc, c);
#pragma unroll
      for (int e = 0; e < kXchg; ++e)
        acc[(ch * kXchg + e) / 4][(ch * kXchg + e) % 4] = v[e];
    }
  }
}

// C1 of iteration t (RESID), or the standalone H_L of a bf16 tile into out
// (!RESID, active null).  Grid (CL * walkers): walker i (a block, or a
// cluster of CL blocks) takes the items (codeword, strip) i, i + walkers,
// ... of the active codewords, item it = b * M / 32 + strip.  At the top of
// an item cp.async starts the next item's bf16 strip (16 bytes a thread)
// and its support entries of y, z and mask/n into the other buffers, so
// the loads overlap this item's products and residual.  The residual runs
// in the products' layout: each lane finds its elements' support bits and
// entries in K1's tables (word and offset of (row range, column)), forms z
// there only, and adds its |z|^2 per slab in the earlier design's order
// (zeros off the support), so z and the partials are the dense design's.
// hpos: the bf16 bits of kK7FoldHfb's factor scale (unused otherwise).
template <class G, bool RESID, int V = kK7>
__global__ void __launch_bounds__(G::NT, 1)
slab_c1_kernel(const __nv_bfloat16* __restrict__ work,
               float* __restrict__ out,          // !RESID: (B, L, M)
               const float* __restrict__ yc, float* __restrict__ zc,
               uint32_t* __restrict__ zr, Support sp,
               const int32_t* __restrict__ perm,
               float* __restrict__ zpart,        // (B, FA * M / 32)
               const float* __restrict__ bpart,  // (B, FA)
               const float* __restrict__ trace,  // (T, B)
               const int32_t* __restrict__ active,  // (T + 1, B) or null
               int B, int M, int t, float P, float nn, uint32_t hpos) {
  constexpr int FB = G::FB, FAL = G::FAL, CL = G::CL, LB = G::LB;
  constexpr int L = G::L, FA = G::FA, NT = G::NT, NW = G::NW, CAP = G::CAP;
  constexpr int RR = G::RR;
  constexpr int HS = k7_col_h(V), CSUB = k7_csub(V, FB);
  constexpr bool CONSUME = V != kK7NoConsume;  // y, mask/n and z are read
  constexpr bool NORMS = V != kK7Sched;        // the |z|^2 partials
  static_assert(CSUB == 0 || (CL == 1 && G::PPW == 1),
                "the compact layouts run at L <= 1024, a tile pair a warp");
  extern __shared__ __align__(16) unsigned char c1_sm[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(c1_sm);
  float* sc = reinterpret_cast<float*>(c1_sm + 2 * G::XBYTES);
  float* es = reinterpret_cast<float*>(c1_sm + 2 * G::XBYTES + G::SCBYTES);
  __shared__ float red[NW][FAL];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3, i = warp >> 2, j = warp & 3;
  const int c = blockIdx.x % CL, walkers = gridDim.x / CL;
  const int row0 = c * LB, S = M / kStrip, items = B * S;
  const int32_t* act = active != nullptr ? active + (size_t)t * B : nullptr;
  // beta' = 0 before the first iteration: no forward transform there
  const bool transform = !RESID || t > 0;
  // the walker's next item of an active codeword from it on; the same in
  // every block of a cluster
  auto next = [&](int it) {
    while (act != nullptr && it < items && !act[it / S]) it += walkers;
    return it;
  };
  auto fetch = [&](int it, int slot) {
    const int b = it / S, s = it % S;
    if (transform) {
      const __nv_bfloat16* src =
          work + ((size_t)b * L + row0) * M + s * kStrip;
      __nv_bfloat16* dst = xs + slot * LB * kLdX;
      for (int e = threadIdx.x; e < LB * 4; e += NT) {
        const int r = e >> 2, p = e & 3;
        cp_async16(dst + r * kLdX + 8 * p, src + (size_t)r * M + 8 * p);
      }
    }
    if constexpr (RESID && CONSUME) {
      const int ib = s * CL + c;  // K1's column-stage block
      const int first = sp.block[ib], count = sp.block[ib + 1] - first;
      if (count <= CAP) {
        float* ys = es + slot * 3 * CAP;
        const size_t off = (size_t)b * sp.ns + first;
        for (int e = threadIdx.x; e < count; e += NT) {
          cp_async4(ys + e, yc + off + e);
          cp_async4(ys + 2 * CAP + e, sp.mask + first + e);
          if (t > 0) cp_async4(ys + CAP + e, zc + off + e);
        }
      }
    }
  };

  int it = next(blockIdx.x / CL);
  if (it >= items) return;  // uniform per cluster
  int slot = 0;
  fetch(it, 0);
  while (it < items) {
    const int nx = next(it + walkers);
    const int b = it / S, s = it % S;
    cp_async_wait_all();
    __syncthreads();  // this item's data is visible; the other buffers free
    if (nx < items) fetch(nx, slot ^ 1);
    if constexpr (CSUB > 0) {
      if (transform) {
        // slab 0 of the strip becomes bf16 of the sum of its slabs, in
        // slab order (row 0 of H_{f_a} is all +1)
        __nv_bfloat16* cur = xs + slot * LB * kLdX;
        for (int e = threadIdx.x; e < FB * kStrip / 2; e += NT) {
          const int r = e / (kStrip / 2), p = 2 * (e % (kStrip / 2));
          float2 sum = bf16x2_at(cur + r * kLdX + p);
#pragma unroll 1
          for (int a = 1; a < FAL; ++a) {
            const float2 x = bf16x2_at(cur + (a * FB + r) * kLdX + p);
            sum.x += x.x;
            sum.y += x.y;
          }
          *reinterpret_cast<uint32_t*>(cur + r * kLdX + p) =
              bf16_pair(sum.x, sum.y);
        }
        __syncthreads();
      }
    }
    if constexpr (G::PPW == 1) {
      // one tile pair a warp: (i, j) = (warp / 4, warp % 4).  This body is
      // K7's own, straight-line: the same work inside a loop or a lambda
      // over tile pairs compiled K7's C1 to more register moves and spills
      // (7 % slower a launch on an H100), hence the second body below.
      float acc[FAL][4];
      if (transform && (CSUB == 0 || kTile * i < CSUB)) {
        if constexpr (CSUB > 0) {
          uint32_t ha[4];
          hfb_frag<false>(ha, 0u);
          hfb_tile<FB>(xs + slot * LB * kLdX, acc[0], i, j, ha);
        } else {
          uint32_t ha[4];
          hfb_frag<V == kK7FoldHfb>(ha, hpos);
          slab_hl<G, HS>(xs + slot * LB * kLdX, acc, sc, c, i, j, ha);
        }
      } else {
#pragma unroll
        for (int a = 0; a < FAL; ++a)
          acc[a][0] = acc[a][1] = acc[a][2] = acc[a][3] = 0.f;
      }
      const int col = s * kStrip + 8 * j + 2 * q;
      if constexpr (!RESID) {
#pragma unroll
        for (int a = 0; a < FAL; ++a) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int l = row0 + a * FB + kTile * i + g + 8 * h;
            *reinterpret_cast<float2*>(out + ((size_t)b * L + l) * M +
                                       col) =
                make_float2(acc[a][2 * h], acc[a][2 * h + 1]);
          }
        }
      } else {
        float coef = 0.f;
        if (CONSUME && t > 0) {
          float bn = 0.f;
#pragma unroll 1
          for (int a = 0; a < FA; ++a) bn += bpart[(size_t)b * FA + a];
          coef = (P - bn / nn) / trace[(size_t)k7_row(V, t - 1) * B + b];
        }
        const int ib = s * CL + c;
        const int first = sp.block[ib];
        const bool staged = sp.block[ib + 1] - first <= CAP;
        const size_t cw = (size_t)b * sp.ns;
        const float* ys = es + slot * 3 * CAP - first;
        const float* ysrc = staged ? ys : yc + cw;
        const float* zsrc = staged ? ys + CAP : zc + cw;
        const float* msrc = staged ? ys + 2 * CAP : sp.mask;
        // a compact layout's support lies in slab 0
#pragma unroll
        for (int a = 0; a < (CSUB > 0 ? 1 : FAL); ++a) {
          float zz = 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int l = row0 + a * FB + kTile * i + g + 8 * h;
            const size_t tab = (size_t)(l / RR) * M + col;
            const int k = l % RR;
            float zv[2];
#pragma unroll
            for (int cc = 0; cc < 2; ++cc) {
              zv[cc] = 0.f;
              const uint32_t word = __ldg(sp.word + tab + cc);
              if ((word >> k) & 1u) {
                const int e = __ldg(sp.offset + tab + cc) +
                              __popc(word & ((1u << k) - 1u));
                float zk = acc[a][2 * h + cc];
                if constexpr (CONSUME) {
                  zk = ysrc[e] - msrc[e] * zk;
                  if (t > 0) zk += coef * zsrc[e];
                }
                zc[cw + e] = zk;
                zr[cw + __ldg(perm + e)] = pack_entry(zk, col + cc);
                zv[cc] = zk;
              }
            }
            zz += zv[0] * zv[0] + zv[1] * zv[1];
          }
          if constexpr (NORMS) {
            zz = warp_sum(zz);
            if (lane == 0) red[warp][a] = zz;
          }
        }
        if constexpr (NORMS) {
          if constexpr (CSUB > 0) {
            if (lane == 0) {
#pragma unroll
              for (int a = 1; a < FAL; ++a) red[warp][a] = 0.f;
            }
          }
          __syncthreads();
          if (threadIdx.x < FAL) {
            float sum = 0.f;
#pragma unroll
            for (int w = 0; w < NW; ++w) sum += red[w][threadIdx.x];
            zpart[((size_t)b * FA + c * FAL + threadIdx.x) * S + s] = sum;
          }
        }
      }
    } else {
      // PPW tile pairs a warp, one after another (the 256-row slabs'
      // factoring): the same products and residual, each slab's |z|^2
      // terms summed over the warp's pairs
      static_assert(RESID && CSUB == 0 && CL == 1,
                    "several tile pairs a warp: C1 at L <= 1024 only");
      float coef = 0.f;
      if (CONSUME && t > 0) {
        float bn = 0.f;
#pragma unroll 1
        for (int a = 0; a < FA; ++a) bn += bpart[(size_t)b * FA + a];
        coef = (P - bn / nn) / trace[(size_t)k7_row(V, t - 1) * B + b];
      }
      const int ib = s * CL + c;
      const int first = sp.block[ib];
      const bool staged = sp.block[ib + 1] - first <= CAP;
      const size_t cw = (size_t)b * sp.ns;
      const float* ys = es + slot * 3 * CAP - first;
      const float* ysrc = staged ? ys : yc + cw;
      const float* zsrc = staged ? ys + CAP : zc + cw;
      const float* msrc = staged ? ys + 2 * CAP : sp.mask;
      float zz[FAL];
#pragma unroll
      for (int a = 0; a < FAL; ++a) zz[a] = 0.f;
#pragma unroll 1
      for (int pp = 0; pp < G::PPW; ++pp) {
        const int pr = warp + NW * pp, pi = pr >> 2, pj = pr & 3;
        float acc[FAL][4];
        if (transform) {
          uint32_t ha[4];
          hfb_frag<V == kK7FoldHfb>(ha, hpos);
          slab_hl<G, HS>(xs + slot * LB * kLdX, acc, sc, c, pi, pj, ha);
        } else {
#pragma unroll
          for (int a = 0; a < FAL; ++a)
            acc[a][0] = acc[a][1] = acc[a][2] = acc[a][3] = 0.f;
        }
        const int col = s * kStrip + 8 * pj + 2 * q;
#pragma unroll
        for (int a = 0; a < FAL; ++a) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int l = row0 + a * FB + kTile * pi + g + 8 * h;
            const size_t tab = (size_t)(l / RR) * M + col;
            const int k = l % RR;
#pragma unroll
            for (int cc = 0; cc < 2; ++cc) {
              const uint32_t word = __ldg(sp.word + tab + cc);
              if ((word >> k) & 1u) {
                const int e = __ldg(sp.offset + tab + cc) +
                              __popc(word & ((1u << k) - 1u));
                float zk = acc[a][2 * h + cc];
                if constexpr (CONSUME) {
                  zk = ysrc[e] - msrc[e] * zk;
                  if (t > 0) zk += coef * zsrc[e];
                }
                zc[cw + e] = zk;
                zr[cw + __ldg(perm + e)] = pack_entry(zk, col + cc);
                zz[a] += zk * zk;
              }
            }
          }
        }
      }
      if constexpr (NORMS) {
#pragma unroll
        for (int a = 0; a < FAL; ++a) {
          const float v = warp_sum(zz[a]);
          if (lane == 0) red[warp][a] = v;
        }
        __syncthreads();
        if (threadIdx.x < FAL) {
          float sum = 0.f;
#pragma unroll
          for (int w = 0; w < NW; ++w) sum += red[w][threadIdx.x];
          zpart[((size_t)b * FA + c * FAL + threadIdx.x) * S + s] = sum;
        }
      }
    }
    slot ^= 1;
    it = nx;
  }
}

// R2C2 of iteration t: u = H_L bf16(H_M bf16(z)) of every active codeword
// (every codeword with active == nullptr: the standalone adjoint), from zr
// (B, ns), z's packed entries in row-major order (row l's are row_offset[l]
// .. row_offset[l + 1] - 1, in column order).  Walkers as C1's.  Thread
// (w, c) builds column m = 32 s + c of its rows w + NW k from each row's
// entries:
//   (H_M bf16(z))[l][m] = sum over the row's entries (m', z), in column
//   order, of (-1)^popc(m' & m) bf16(z),
// with the sign split as (-1)^popc(m'_hi & s) (the entry's, the same for
// the whole strip) times (-1)^popc(m'_lo & c) (bit 31 of the lane's mask
// xc shifted left by m'_lo), the float32 sum rounded to bf16 into the
// strip tile; then the strip's H_L (slab_hl) and u stored once.  The
// block's rows' packed words are staged as (bf16(z) with the strip's sign,
// m'_lo) pairs: cp.async brings them while the item before is in its
// products, and one pass turns them into pairs (at most kAdjCap; above,
// the terms are formed from device memory, the same values in the same
// order).  The pair (C = 2) takes codewords 2 p and 2 p + 1 an item.
template <class G, int V = kK7>
__global__ void __launch_bounds__(G::NT, 1)
slab_adj_kernel(const uint32_t* __restrict__ zr,
                const int32_t* __restrict__ row_offset, int ns,
                float* __restrict__ u,
                const int32_t* __restrict__ active,  // (T + 1, B) or null
                int B, int M, int t) {
  constexpr int FB = G::FB, FAL = G::FAL, CL = G::CL, LB = G::LB;
  constexpr int L = G::L, NT = G::NT, NW = G::NW;
  constexpr int C = k7_cw(V), HS = k7_col_h(V), CSUB = k7_csub(V, FB);
  // rows built a strip, and the rows of u a codeword (one slab: compact)
  constexpr int NR = CSUB > 0 ? CSUB : LB, LU = CSUB > 0 ? FB : L;
  static_assert(CSUB == 0 || (CL == 1 && G::PPW == 1),
                "the compact layouts run at L <= 1024, a tile pair a warp");
  extern __shared__ __align__(16) unsigned char adj_sm[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(adj_sm);
  float* sc = reinterpret_cast<float*>(adj_sm + C * G::XBYTES);
  int32_t* rows =
      reinterpret_cast<int32_t*>(adj_sm + C * G::XBYTES + G::SCBYTES);
  int2* ent = reinterpret_cast<int2*>(rows + LB + 4);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int c = blockIdx.x % CL, walkers = gridDim.x / CL;
  const int row0 = c * LB, S = M / kStrip, items = B / C * S;
  const int32_t* act = active != nullptr ? active + (size_t)t * B : nullptr;
  const int first = row_offset[row0];
  const int count = row_offset[row0 + LB] - first;
  const bool staged = C == 1 && count <= kAdjCap;
  // bit 31 - k of xc is popc(k & lane) & 1
  uint32_t xc = 0u;
#pragma unroll
  for (int k = 0; k < 32; ++k)
    xc |= (uint32_t)(__popc(k & lane) & 1) << (31 - k);
  auto next = [&](int it) {
    while (act != nullptr && it < items && !act[it / S * C]) it += walkers;
    return it;
  };
  // the packed words of an item's rows into the pairs' second halves
  auto fetch = [&](int it) {
    const uint32_t* src = zr + (size_t)(it / S) * ns + first;
    for (int e = threadIdx.x; e < count; e += NT) cp_async4(&ent[e].y, src + e);
  };
  // (bf16(z) with the strip's sign, as float bits; m' % 32) of a packed word
  auto pair = [](uint32_t p, int s) {
    const uint32_t hi = (p >> 5) & 31u;
    const uint32_t sgn = (uint32_t)(__popc(hi & (uint32_t)s) & 1) << 31;
    return make_int2((int)((p & 0xFFFF0000u) ^ sgn), (int)(p & 31u));
  };
  auto term = [&](int2 p) {
    return __uint_as_float(((xc << p.y) & 0x80000000u) ^ (uint32_t)p.x);
  };
  for (int e = threadIdx.x; e <= LB; e += NT) rows[e] = row_offset[row0 + e];
  int it = next(blockIdx.x / CL);
  if (it >= items) return;  // uniform per cluster
  if (staged) fetch(it);
  const int2* ep = ent - first;
  while (it < items) {
    const int nx = next(it + walkers);
    const int p = it / S, s = it % S;
    cp_async_wait_all();
    __syncthreads();  // staged words, row offsets visible; strip tile free
    if (staged) {
      for (int e = threadIdx.x; e < count; e += NT)
        ent[e] = pair((uint32_t)ent[e].y, s);
      __syncthreads();
    }
    const uint32_t* zb[C];
#pragma unroll
    for (int cw = 0; cw < C; ++cw) zb[cw] = zr + (size_t)(p * C + cw) * ns;
#pragma unroll 4
    for (int k = 0; k < NR / NW; ++k) {
      const int lr = warp + NW * k;
      const int j1 = rows[lr + 1];
      float acc[C];
#pragma unroll
      for (int cw = 0; cw < C; ++cw) acc[cw] = 0.f;
      if (staged) {
#pragma unroll 4
        for (int e = rows[lr]; e < j1; ++e) acc[0] += term(ep[e]);
      } else {
        for (int e = rows[lr]; e < j1; ++e) {
#pragma unroll
          for (int cw = 0; cw < C; ++cw) acc[cw] += term(pair(zb[cw][e], s));
        }
      }
#pragma unroll
      for (int cw = 0; cw < C; ++cw)
        xs[cw * LB * kLdX + lr * kLdX + lane] = __float2bfloat16_rn(acc[cw]);
    }
    __syncthreads();  // the strip tile is built; the pairs are read
    if (staged && nx < items) fetch(nx);
    const int col0 = s * kStrip + 2 * q;
#pragma unroll
    for (int cw = 0; cw < C; ++cw) {
      const size_t b = (size_t)p * C + cw;
#pragma unroll 1
      for (int pp = 0; pp < G::PPW; ++pp) {
        const int pr = warp + NW * pp, i = pr >> 2, j = pr & 3;
        const int col = col0 + 8 * j;
        float v[FAL][4];
        uint32_t ha[4];
        hfb_frag<false>(ha, 0u);
        if constexpr (CSUB > 0) {
          hfb_tile<CSUB>(xs, v[0], i, j, ha);
        } else {
          slab_hl<G, HS>(xs + cw * LB * kLdX, v, sc, c, i, j, ha);
        }
#pragma unroll
        for (int a = 0; a < (CSUB > 0 ? 1 : FAL); ++a) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int l = row0 + a * FB + kTile * i + g + 8 * h;
            *reinterpret_cast<float2*>(u + (b * LU + l) * M + col) =
                make_float2(v[a][2 * h], v[a][2 * h + 1]);
          }
        }
      }
    }
    it = nx;
  }
}

// ------------------------------------------------------------------- rows
//
// The H_M stage of a row block is amp_mma.cuh's slab_hm.

// out = bf16(H_M bf16(x)) for every row of x (B, L, M), 16 rows per block
// (the standalone transform's first stage).
template <int M>
__global__ void __launch_bounds__(SlabRows<M>::THREADS)
slab_hm_kernel(const float* __restrict__ x, __nv_bfloat16* __restrict__ out,
               int L) {
  using S = SlabRows<M>;
  __shared__ __align__(16) __nv_bfloat16 sA[kTile * S::LDA];
  const int b = blockIdx.y;
  const size_t base = ((size_t)b * L + (size_t)blockIdx.x * kTile) * M;
  for (int e = threadIdx.x; e < kTile * M / 4; e += S::THREADS) {
    const int r = e / (M / 4), c4 = e % (M / 4);
    const float4 v =
        *reinterpret_cast<const float4*>(x + base + (size_t)r * M + 4 * c4);
    *reinterpret_cast<uint2*>(sA + r * S::LDA + 4 * c4) =
        make_uint2(bf16_pair(v.x, v.y), bf16_pair(v.z, v.w));
  }
  __syncthreads();
  slab_hm<M>(sA, out + base);
}

// R3 of iteration t, one block per (slab, codeword; the pair: two
// codewords), the slab's fb rows 16 at a time.  u holds H(z) on entry
// (compact: one slab a codeword, added to every slab); work holds bf16(H_M
// bf16(beta'_new)) on exit unless this is the codeword's last iteration;
// beta holds beta' and, after the last iteration, the true-scale beta.  One
// warp per row at a time; lane i holds columns i + 32 e.  The pair runs at
// fixed T (tol 0, no pins).
template <int M, int V = kK7, int MB = SlabRows<M>::MB>
__global__ void __launch_bounds__(SlabRows<M, MB>::THREADS)
slab_row_kernel(const float* __restrict__ u, float* __restrict__ beta,
                __nv_bfloat16* __restrict__ work,
                const float* __restrict__ zpart,  // (B, FA, M / 32)
                float* __restrict__ bpart,        // (B, FA)
                float* __restrict__ trace,        // (T, B)
                int32_t* __restrict__ iters,      // (B,)
                int32_t* __restrict__ active,     // (T + 1, B)
                const int32_t* __restrict__ pin,  // (B, L) or null
                const float* __restrict__ sched,  // (T,) or null
                const float* __restrict__ sqi, const float* __restrict__ sqo,
                int B, int L, int fb, int t, int last, float n,
                float inv_sqrt_n, float tol) {
  using S = SlabRows<M, MB>;
  constexpr int EPL = M / 32, NS = M / kStrip;
  constexpr int C = k7_cw(V), HS = k7_row_h(V);
  constexpr bool COMPACT = k7_csub(V, 1) != 0;
  constexpr bool LINEAR = V == kK7NoSoftmax || V == kK7NoConsume;
  __shared__ __align__(16) __nv_bfloat16 sA[C * kTile * S::LDA];
  __shared__ float red[S::NW];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int a = blockIdx.x, b0 = blockIdx.y * C, fa = gridDim.x;
  const bool lead = a == 0 && threadIdx.x == 0;
  float tau2_prev[C];
#pragma unroll
  for (int cw = 0; cw < C; ++cw)
    tau2_prev[cw] =
        t > 0 ? trace[(size_t)k7_row(V, t - 1) * B + b0 + cw] : INFINITY;
  if (!active[(size_t)t * B + b0]) {  // frozen: uniform per block
    if (lead) {
#pragma unroll
      for (int cw = 0; cw < C; ++cw) {
        trace[(size_t)k7_row(V, t) * B + b0 + cw] = tau2_prev[cw];
        active[(size_t)(t + 1) * B + b0 + cw] = 0;
      }
    }
    return;
  }
  float tau2[C];
  bool conv = false;
#pragma unroll
  for (int cw = 0; cw < C; ++cw) {
    const int b = b0 + cw;
    if (sched != nullptr) {
      tau2[cw] = sched[t];
    } else {
      // each slab's strips, then the slabs in slab order
      float zz = 0.f;
#pragma unroll 1
      for (int sl = 0; sl < fa; ++sl) {
        float zs = 0.f;
#pragma unroll
        for (int k = 0; k < NS; ++k)
          zs += zpart[((size_t)b * fa + sl) * NS + k];
        zz += zs;
      }
      tau2[cw] = zz / n;
    }
    conv = conv || fabsf(tau2[cw] - tau2_prev[cw]) < tol * tau2[cw];
  }
  const bool fin = last || conv;  // this codeword's last iteration

  float bb[C];
#pragma unroll
  for (int cw = 0; cw < C; ++cw) bb[cw] = 0.f;
#pragma unroll 1
  for (int tile = 0; tile < fb / kTile; ++tile) {
    const int l0 = a * fb + kTile * tile;
    for (int r = warp; r < kTile; r += S::NW) {
      const int l = l0 + r;
      size_t off[C];
      float v[C][EPL];
#pragma unroll
      for (int cw = 0; cw < C; ++cw) {
        const size_t b = b0 + cw;
        off[cw] = ((b * L + l0) * M) + (size_t)r * M + lane;
        const size_t uoff =
            COMPACT ? (b * fb + kTile * tile + r) * M + lane : off[cw];
#pragma unroll
        for (int e = 0; e < EPL; ++e) v[cw][e] = u[uoff + 32 * e];
      }
      if (t > 0) {
#pragma unroll
        for (int cw = 0; cw < C; ++cw) {
#pragma unroll
          for (int e = 0; e < EPL; ++e) v[cw][e] += beta[off[cw] + 32 * e];
        }
      }
      if constexpr (LINEAR) {
        const float sc = 1e-3f / inv_sqrt_n;
#pragma unroll
        for (int cw = 0; cw < C; ++cw) {
          const float ai = sqi[l] / tau2[cw];
#pragma unroll
          for (int e = 0; e < EPL; ++e) v[cw][e] = (ai * v[cw][e]) * sc;
        }
      } else {
        float mx[C], se[C];
#pragma unroll
        for (int cw = 0; cw < C; ++cw) {
          const float ai = sqi[l] / tau2[cw];
          mx[cw] = -INFINITY;
#pragma unroll
          for (int e = 0; e < EPL; ++e) {
            v[cw][e] = ai * v[cw][e];
            mx[cw] = fmaxf(mx[cw], v[cw][e]);
          }
        }
#pragma unroll
        for (int cw = 0; cw < C; ++cw) mx[cw] = warp_max(mx[cw]);
#pragma unroll
        for (int cw = 0; cw < C; ++cw) {
          se[cw] = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) {
            v[cw][e] = V == kK7Exp2 ? exp2f((v[cw][e] - mx[cw]) * kLog2e)
                                    : expf(v[cw][e] - mx[cw]);
            se[cw] += v[cw][e];
          }
        }
#pragma unroll
        for (int cw = 0; cw < C; ++cw) se[cw] = warp_sum(se[cw]);
#pragma unroll
        for (int cw = 0; cw < C; ++cw) {
          const float so = sqo[l] / se[cw];
#pragma unroll
          for (int e = 0; e < EPL; ++e) v[cw][e] = so * v[cw][e];
        }
      }
      if (pin != nullptr) {
#pragma unroll
        for (int cw = 0; cw < C; ++cw) {
          const int p = pin[(size_t)(b0 + cw) * L + l];
          if (p >= 0) {
#pragma unroll
            for (int e = 0; e < EPL; ++e)
              v[cw][e] = (lane + 32 * e == p) ? sqo[l] : 0.f;
          }
        }
      }
      if (fin) {
#pragma unroll
        for (int cw = 0; cw < C; ++cw) {
#pragma unroll
          for (int e = 0; e < EPL; ++e)
            beta[off[cw] + 32 * e] = v[cw][e] * inv_sqrt_n;
        }
      } else {
#pragma unroll
        for (int cw = 0; cw < C; ++cw) {
#pragma unroll
          for (int e = 0; e < EPL; ++e) {
            beta[off[cw] + 32 * e] = v[cw][e];
            bb[cw] += v[cw][e] * v[cw][e];
            sA[cw * kTile * S::LDA + r * S::LDA + lane + 32 * e] =
                __float2bfloat16_rn(v[cw][e]);
          }
        }
      }
    }
    if (!fin) {  // uniform per block
      __syncthreads();
#pragma unroll
      for (int cw = 0; cw < C; ++cw)
        slab_hm<M, MB, HS>(sA + cw * kTile * S::LDA,
                           work + ((size_t)(b0 + cw) * L + l0) * M);
      __syncthreads();  // sA is refilled by the next tile
    }
  }
  if (!fin) {
#pragma unroll
    for (int cw = 0; cw < C; ++cw) {
      const float sum = block_sum<S::NW>(bb[cw], red);
      if (threadIdx.x == 0) bpart[(size_t)(b0 + cw) * fa + a] = sum;
    }
  }
  if (lead) {
#pragma unroll
    for (int cw = 0; cw < C; ++cw) {
      const int b = b0 + cw;
      trace[(size_t)k7_row(V, t) * B + b] = tau2[cw];
      active[(size_t)(t + 1) * B + b] = fin ? 0 : 1;
      if (fin) iters[b] = t + 1;
    }
  }
}

// ------------------------------------------------------------- launchers

// Launch kernel with as many walkers (blocks, or clusters of CL blocks) as
// are resident at once, at most one per item.
template <int CL, typename K, typename... Args>
int walk(K kernel, int threads, int bytes, int items, cudaStream_t st,
         Args... args) {
  int rc = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc) return rc;
  int walkers = 0;
  rc = resident_walkers<CL>(kernel, threads, bytes, st, &walkers);
  if (rc) return rc;
  walkers = walkers < items ? walkers : items;
  ClusterLaunch<CL> lc(dim3(CL * walkers), threads, bytes, st);
  rc = (int)cudaLaunchKernelEx(&lc.cfg, kernel, args...);
  return rc ? rc : (int)cudaGetLastError();
}

// K7's column launches (variant V) for the geometry G.
template <class G>
struct SlabCols {
  template <bool RESID, int V = kK7>
  static int c1(const __nv_bfloat16* work, float* out, const float* yc,
                float* zc, uint32_t* zr, const Support& sp,
                const int32_t* perm, float* zpart, const float* bpart,
                const float* trace, const int32_t* active, int B, int M,
                int t, float P, float nn, cudaStream_t st,
                uint32_t hpos = 0x3F80u) {
    return walk<G::CL>(slab_c1_kernel<G, RESID, V>, G::NT, G::C1_BYTES,
                       B * (M / kStrip), st, work, out, yc, zc, zr, sp, perm,
                       zpart, bpart, trace, active, B, M, t, P, nn, hpos);
  }
  template <int V = kK7>
  static int adj(const uint32_t* zr, const int32_t* row_offset, int ns,
                 float* u, const int32_t* active, int B, int M, int t,
                 cudaStream_t st) {
    return walk<G::CL>(slab_adj_kernel<G, V>, G::NT, adj_bytes<G, V>(),
                       B / k7_cw(V) * (M / kStrip), st, zr, row_offset, ns,
                       u, active, B, M, t);
  }
};

// K7's column launches for f_b = FB, FAL slabs a block, clusters of CL
template <int FB, int FAL, int CL, int PPW = 1>
using SlabColsOf = SlabCols<SlabGeo<FB, FAL, CL, PPW>>;

// R3 at variant V with m_b = MB: grid (L / fb, B / codewords a block).
template <int M, int V = kK7, int MB = SlabRows<M>::MB>
int slab_row_launch(const float* u, float* beta, __nv_bfloat16* work,
                    const float* zpart, float* bpart, float* trace,
                    int32_t* iters, int32_t* active, const int32_t* pin,
                    const float* sched, const float* sqi, const float* sqo,
                    int B, int L, int fb, int t, int last, float n,
                    float inv_sqrt_n, float tol, cudaStream_t st) {
  slab_row_kernel<M, V, MB>
      <<<dim3(L / fb, B / k7_cw(V)), SlabRows<M, MB>::THREADS, 0, st>>>(
          u, beta, work, zpart, bpart, trace, iters, active, pin, sched, sqi,
          sqo, B, L, fb, t, last, n, inv_sqrt_n, tol);
  return (int)cudaGetLastError();
}

}  // namespace
