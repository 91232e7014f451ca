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
// Built by sparc_ldpc_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// and called through ctypes (plain C interface below).

#include "amp_support.cuh"
#include "amp_mma.cuh"

namespace {

constexpr int kSlabRows = 128;  // f_b at L >= 128
constexpr int kXchg = 8;        // values a thread exchanges a cluster round
constexpr int kAdjCap = 11264;  // packed z entries R2C2 stages a block

// The column launches' geometry for L = CL * FAL * FB: a block owns FAL
// slabs of FB rows (LB rows, 1024 at most) of a 32-column strip, block c of
// a cluster of CL rows [c LB, (c + 1) LB).  A warp owns one (16-row tile i,
// 8-column tile j) pair of every slab: FB / 16 * 4 = FB / 4 warps.
template <int FB_, int FAL_, int CL_>
struct SlabGeo {
  static constexpr int FB = FB_, FAL = FAL_, CL = CL_;
  static constexpr int LB = FAL * FB, L = CL * LB, FA = CL * FAL;
  static constexpr int NW = FB / 4, NT = 32 * NW;
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

// bf16(z) with its column m (< 2^16) in one word: the bf16 bits above, so
// the word with its low half cleared is the float bf16(z) (amp_mono.cu's).
__device__ __forceinline__ uint32_t pack_entry(float z, int m) {
  return ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(z)) << 16) |
         (uint32_t)m;
}

// H_L of the block's bf16 strip sx (LB rows of kLdX): warp (i, j) =
// (warp / 4, warp % 4) gets D = H_{f_b} X of its tile in every slab a, then
// H_{f_a} across the block's slabs in registers and across the cluster's
// blocks (rank c) through distributed shared memory.  For the mma
// m16n8k16 (g = lane / 4, q = lane % 4) the A operand is
// H_{f_b}[16 i + r][16 kk + k] = (-1)^(popc(i & kk) + popc(r & k)): a base
// 16 x 16 fragment, negated as a whole when popc(i & kk) is odd; the B
// operand X[16 kk + k][8 j + n] of the slab, two k-steps an ldmatrix.  acc
// holds rows 16 i + g and + 8 of each slab, columns 8 j + 2 q and + 1.
template <class G>
__device__ __forceinline__ void slab_hl(const __nv_bfloat16* sx,
                                        float (&acc)[G::FAL][4], float* sc,
                                        int c) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3, i = warp >> 2, j = warp & 3;
  const uint32_t ha0 = h_pair(g, 2 * q), ha1 = h_pair(g + 8, 2 * q);
  const uint32_t ha2 = h_pair(g, 2 * q + 8), ha3 = h_pair(g + 8, 2 * q + 8);
#pragma unroll
  for (int a = 0; a < G::FAL; ++a) {
    acc[a][0] = acc[a][1] = acc[a][2] = acc[a][3] = 0.f;
#pragma unroll
    for (int k2 = 0; k2 < G::FB / 32; ++k2) {
      uint32_t r[4];
      ldsm_x4_t(r, sx + (a * G::FB + 32 * k2 + lane) * kLdX + 8 * j);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t sg = (__popc(i & (2 * k2 + h)) & 1) ? kNeg : 0u;
        mma_bf16(acc[a][0], acc[a][1], acc[a][2], acc[a][3], ha0 ^ sg,
                 ha1 ^ sg, ha2 ^ sg, ha3 ^ sg, r[2 * h], r[2 * h + 1]);
      }
    }
  }
  tile_fwht<G::FAL>(acc);  // H_{f_a} across the block's slabs
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
template <class G, bool RESID>
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
               int B, int M, int t, float P, float nn) {
  constexpr int FB = G::FB, FAL = G::FAL, CL = G::CL, LB = G::LB;
  constexpr int L = G::L, FA = G::FA, NT = G::NT, NW = G::NW, CAP = G::CAP;
  constexpr int RR = G::RR;
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
    if constexpr (RESID) {
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
    float acc[FAL][4];
    if (transform) {
      slab_hl<G>(xs + slot * LB * kLdX, acc, sc, c);
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
          *reinterpret_cast<float2*>(out + ((size_t)b * L + l) * M + col) =
              make_float2(acc[a][2 * h], acc[a][2 * h + 1]);
        }
      }
    } else {
      float coef = 0.f;
      if (t > 0) {
        float bn = 0.f;
#pragma unroll 1
        for (int a = 0; a < FA; ++a) bn += bpart[(size_t)b * FA + a];
        coef = (P - bn / nn) / trace[(size_t)(t - 1) * B + b];
      }
      const int ib = s * CL + c;
      const int first = sp.block[ib];
      const bool staged = sp.block[ib + 1] - first <= CAP;
      const size_t cw = (size_t)b * sp.ns;
      const float* ys = es + slot * 3 * CAP - first;
      const float* ysrc = staged ? ys : yc + cw;
      const float* zsrc = staged ? ys + CAP : zc + cw;
      const float* msrc = staged ? ys + 2 * CAP : sp.mask;
#pragma unroll
      for (int a = 0; a < FAL; ++a) {
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
              float zk = ysrc[e] - msrc[e] * acc[a][2 * h + cc];
              if (t > 0) zk += coef * zsrc[e];
              zc[cw + e] = zk;
              zr[cw + __ldg(perm + e)] = pack_entry(zk, col + cc);
              zv[cc] = zk;
            }
          }
          zz += zv[0] * zv[0] + zv[1] * zv[1];
        }
        zz = warp_sum(zz);
        if (lane == 0) red[warp][a] = zz;
      }
      __syncthreads();
      if (threadIdx.x < FAL) {
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < NW; ++w) sum += red[w][threadIdx.x];
        zpart[((size_t)b * FA + c * FAL + threadIdx.x) * S + s] = sum;
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
// order).
template <class G>
__global__ void __launch_bounds__(G::NT, 1)
slab_adj_kernel(const uint32_t* __restrict__ zr,
                const int32_t* __restrict__ row_offset, int ns,
                float* __restrict__ u,
                const int32_t* __restrict__ active,  // (T + 1, B) or null
                int B, int M, int t) {
  constexpr int FB = G::FB, FAL = G::FAL, CL = G::CL, LB = G::LB;
  constexpr int L = G::L, NT = G::NT, NW = G::NW;
  extern __shared__ __align__(16) unsigned char adj_sm[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(adj_sm);
  float* sc = reinterpret_cast<float*>(adj_sm + G::XBYTES);
  int32_t* rows =
      reinterpret_cast<int32_t*>(adj_sm + G::XBYTES + G::SCBYTES);
  int2* ent = reinterpret_cast<int2*>(rows + LB + 4);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3, i = warp >> 2, j = warp & 3;
  const int c = blockIdx.x % CL, walkers = gridDim.x / CL;
  const int row0 = c * LB, S = M / kStrip, items = B * S;
  const int32_t* act = active != nullptr ? active + (size_t)t * B : nullptr;
  const int first = row_offset[row0];
  const int count = row_offset[row0 + LB] - first;
  const bool staged = count <= kAdjCap;
  // bit 31 - k of xc is popc(k & lane) & 1
  uint32_t xc = 0u;
#pragma unroll
  for (int k = 0; k < 32; ++k)
    xc |= (uint32_t)(__popc(k & lane) & 1) << (31 - k);
  auto next = [&](int it) {
    while (act != nullptr && it < items && !act[it / S]) it += walkers;
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
    const int b = it / S, s = it % S;
    cp_async_wait_all();
    __syncthreads();  // staged words, row offsets visible; strip tile free
    if (staged) {
      for (int e = threadIdx.x; e < count; e += NT)
        ent[e] = pair((uint32_t)ent[e].y, s);
      __syncthreads();
    }
    const uint32_t* zb = zr + (size_t)b * ns;
#pragma unroll 4
    for (int k = 0; k < LB / NW; ++k) {
      const int lr = warp + NW * k;
      const int j1 = rows[lr + 1];
      float acc = 0.f;
      if (staged) {
#pragma unroll 4
        for (int e = rows[lr]; e < j1; ++e) acc += term(ep[e]);
      } else {
        for (int e = rows[lr]; e < j1; ++e) acc += term(pair(zb[e], s));
      }
      xs[lr * kLdX + lane] = __float2bfloat16_rn(acc);
    }
    __syncthreads();  // the strip tile is built; the pairs are read
    if (staged && nx < items) fetch(nx);
    float v[FAL][4];
    slab_hl<G>(xs, v, sc, c);
    const int col = s * kStrip + 8 * j + 2 * q;
#pragma unroll
    for (int a = 0; a < FAL; ++a) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int l = row0 + a * FB + kTile * i + g + 8 * h;
        *reinterpret_cast<float2*>(u + ((size_t)b * L + l) * M + col) =
            make_float2(v[a][2 * h], v[a][2 * h + 1]);
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

// R3 of iteration t, one block per (slab, codeword), the slab's fb rows 16
// at a time.  u holds H(z) on entry; work holds bf16(H_M bf16(beta'_new))
// on exit unless this is the codeword's last iteration; beta holds beta'
// and, after the last iteration, the true-scale beta.  One warp per row at a
// time; lane i holds columns i + 32 e.
template <int M>
__global__ void __launch_bounds__(SlabRows<M>::THREADS)
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
  using S = SlabRows<M>;
  constexpr int EPL = M / 32, NS = M / kStrip;
  __shared__ __align__(16) __nv_bfloat16 sA[kTile * S::LDA];
  __shared__ float red[S::NW];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int a = blockIdx.x, b = blockIdx.y, fa = gridDim.x;
  const bool lead = a == 0 && threadIdx.x == 0;
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
    // each slab's strips, then the slabs in slab order
    float zz = 0.f;
#pragma unroll 1
    for (int sl = 0; sl < fa; ++sl) {
      float zs = 0.f;
#pragma unroll
      for (int k = 0; k < NS; ++k) zs += zpart[((size_t)b * fa + sl) * NS + k];
      zz += zs;
    }
    tau2 = zz / n;
  }
  const bool conv = fabsf(tau2 - tau2_prev) < tol * tau2;
  const bool fin = last || conv;  // this codeword's last iteration

  float bb = 0.f;
#pragma unroll 1
  for (int tile = 0; tile < fb / kTile; ++tile) {
    const int l0 = a * fb + kTile * tile;
    const size_t base = ((size_t)b * L + l0) * M;
    for (int r = warp; r < kTile; r += S::NW) {
      const int l = l0 + r;
      const size_t off = base + (size_t)r * M + lane;
      float v[EPL];
#pragma unroll
      for (int e = 0; e < EPL; ++e) v[e] = u[off + 32 * e];
      if (t > 0) {
#pragma unroll
        for (int e = 0; e < EPL; ++e) v[e] += beta[off + 32 * e];
      }
      const float ai = sqi[l] / tau2;
      float mx = -INFINITY;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        v[e] = ai * v[e];
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
      const float so = sqo[l] / se;
#pragma unroll
      for (int e = 0; e < EPL; ++e) v[e] = so * v[e];
      if (pin != nullptr) {
        const int p = pin[(size_t)b * L + l];
        if (p >= 0) {
#pragma unroll
          for (int e = 0; e < EPL; ++e) v[e] = (lane + 32 * e == p) ? sqo[l] : 0.f;
        }
      }
      if (fin) {
#pragma unroll
        for (int e = 0; e < EPL; ++e) beta[off + 32 * e] = v[e] * inv_sqrt_n;
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          beta[off + 32 * e] = v[e];
          bb += v[e] * v[e];
          sA[r * S::LDA + lane + 32 * e] = __float2bfloat16_rn(v[e]);
        }
      }
    }
    if (!fin) {  // uniform per block
      __syncthreads();
      slab_hm<M>(sA, work + base);
      __syncthreads();  // sA is refilled by the next tile
    }
  }
  if (!fin) {
    const float sum = block_sum<S::NW>(bb, red);
    if (threadIdx.x == 0) bpart[(size_t)b * fa + a] = sum;
  }
  if (lead) {
    trace[(size_t)t * B + b] = tau2;
    active[(size_t)(t + 1) * B + b] = fin ? 0 : 1;
    if (fin) iters[b] = t + 1;
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

template <class G>
struct SlabCols {
  template <bool RESID>
  static int c1(const __nv_bfloat16* work, float* out, const float* yc,
                float* zc, uint32_t* zr, const Support& sp,
                const int32_t* perm, float* zpart, const float* bpart,
                const float* trace, const int32_t* active, int B, int M,
                int t, float P, float nn, cudaStream_t st) {
    return walk<G::CL>(slab_c1_kernel<G, RESID>, G::NT, G::C1_BYTES,
                       B * (M / kStrip), st, work, out, yc, zc, zr, sp, perm,
                       zpart, bpart, trace, active, B, M, t, P, nn);
  }
  static int adj(const uint32_t* zr, const int32_t* row_offset, int ns,
                 float* u, const int32_t* active, int B, int M, int t,
                 cudaStream_t st) {
    return walk<G::CL>(slab_adj_kernel<G>, G::NT, G::ADJ_BYTES,
                       B * (M / kStrip), st, zr, row_offset, ns, u, active,
                       B, M, t);
  }
};

// K7's column launches for f_b = FB, FAL slabs a block, clusters of CL
template <int FB, int FAL, int CL>
using SlabColsOf = SlabCols<SlabGeo<FB, FAL, CL>>;

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
