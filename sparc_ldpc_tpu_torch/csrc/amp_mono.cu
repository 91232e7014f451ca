// Whole-trial AMP decode, monolithic form, for Hopper (sm_90a).
//
// Replaces the TPU kernel sparc_ldpc_tpu/ops/amp_kernel.py::_amp_kernel (K6,
// the route of amp_kernel="fused" at L <= 1024: in-kernel encode, early
// stop, pinning, SE schedule; no in-kernel noise).  It runs the iteration
// of amp_split.cu (same scale-free scheme, freeze table, partials and
// pins, and y and z kept on the row support only, in K1's layout) with the
// transform of the monolithic kernel:
//
//   T(x) = H_L (bf16(x) H_M)
//
// The reference computes both factors as dense matrix products with bf16
// Hadamard matrices: bf16(x) @ H_M rounds the data to bf16 and accumulates
// in float32, and H_L @ (that) takes the float32 intermediate as it is (its
// first operand, H_L, is the one cast to bf16).  So each transform rounds
// its data once, before H_M, and applies H_L in float32 -- unlike the split
// form, which rounds before both stages.  An iteration is three launches:
//   column (C1, mono_col_kernel): H_L in float32 of w = bf16(beta') H_M
//     (the work tile, from R3), the residual and Onsager term on the row
//     support only (K1's tables: z and y compact, (B, ns) in K1's order of
//     the entries), the strip's |z|^2, and bf16(z) packed with its column
//     in row-major order of the entries for the next launch;
//   column (R2C2, mono_adj_kernel): the adjoint from the compact z: each
//     strip's columns of bf16(z) H_M built directly from a row's support
//     entries (about n / L = 9 at the headline, each +-bf16(z), summed in
//     float32: the products with +-1 are exact), then H_L in float32, the
//     result u written once into the work tile;
//   rows (R3, mono_row_kernel): + beta', the max-subtracted softmax, pin,
//     |beta'|^2, and, unless it is the codeword's last iteration,
//     bf16(beta'_new) H_M on the tensor cores (mma.sync m16n8k16, bf16 data,
//     float32 accumulation; the H_M fragments made in registers from the
//     parity of popcount(k & n)) into the work tile for the next C1.
// The encode is the split form's (k1_encode_kernel: the one-hot row's H_M
// in closed form, H_L in float32, y written on the support), so the
// codeword's power is exact to float32 where the reference's two-pass
// hi/lo bf16 encode reaches about 2^-16.
//
// What bounds it: device-memory bytes.  Per element and iteration C1 reads
// the float32 work tile (4 bytes), R2C2 writes it (4), R3 reads it and
// beta' and writes both (16): 24 bytes, beside 12 bytes an entry of the
// support (y, z read, z written) and the packed z.  The earlier design
// moved 48: C1 read y, z, mask/n and w and wrote z densely (20 bytes), R2
// read the dense z and wrote a product (8), C2 read and rewrote it in
// place (8), and its R2 multiplied the mostly-zero z by the dense H_M on
// the tensor cores.  R2C2's work is the sparse product's: a shift, a logic
// operation and an add a term, about n / L terms an element (on an H100,
// PERF.md, it is held by those instructions, not by its bytes; summing a
// row's terms in buckets by m' % 32 and five butterflies across the lanes,
// with __match_any_sync finding the terms of one bucket, took 10.07 ms a
// headline launch against 3.78).
//
// Determinism: no float atomics; the same fixed-order partial sums as the
// split form, each row's support entries summed in column order, and each
// mma accumulates its k-steps in a fixed order.
//
// Built by sparc_ldpc_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// and called through ctypes (plain C interface below).

#include "amp_support.cuh"

namespace {

constexpr int kTileRows = 16;  // rows of one mma tile, and of a row block

// Warps of a row block: one per 64 columns (8 n-tiles of 8 columns each).
template <int M>
struct RowShape {
  static constexpr int NW = M >= 64 ? M / 64 : 1;
  static constexpr int LDA = M + 8;  // padded bf16 row stride: no bank conflicts
};

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// bf16 bits of H[k][n] = (-1)^popc(k & n).
__device__ __forceinline__ uint32_t h_bits(int k, int n) {
  return (__popc(k & n) & 1) ? 0xBF80u : 0x3F80u;
}

// out[r][n] = sum_k A[r][k] H_M[k][n] for the 16 rows of the bf16 tile sA
// (row stride LDA), float32, into out (row stride M).
//
// For the tile of k-step k0 = 16 i and columns n0 = 8 j, H_M[k0 + k][n0 + n]
// (k < 16, n < 8) has parity popc(k0 & n0) + bit3(k) bit3(n0) + popc(k & n),
// the three bit sets being disjoint: a base 16 x 8 fragment, negated in its
// k >= 8 half when bit 3 of n0 is set, and as a whole when popc(k0 & n0) is
// odd (xor with the two bf16 sign bits).
//
// Fragments of mma.m16n8k16 (g = lane / 4, q = lane % 4): A holds
// A[g][2q..2q+1], A[g+8][2q..], A[g][2q+8..], A[g+8][2q+8..]; B holds
// B[2q..2q+1][g], B[2q+8..2q+9][g]; D holds D[g][2q..2q+1], D[g+8][2q..].
template <int M>
__device__ __forceinline__ void hm_mma(const __nv_bfloat16* sA,
                                       float* __restrict__ out) {
  constexpr int NW = RowShape<M>::NW, LDA = RowShape<M>::LDA;
  constexpr int NTW = M / 8 / NW;  // n-tiles per warp
  constexpr uint32_t kNeg = 0x80008000u;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const uint32_t b0 = h_bits(2 * q, g) | (h_bits(2 * q + 1, g) << 16);
  const uint32_t b1 = h_bits(2 * q + 8, g) | (h_bits(2 * q + 9, g) << 16);
  const int nb = warp * NTW * 8;
  float acc[NTW][4];
#pragma unroll
  for (int j = 0; j < NTW; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  for (int k0 = 0; k0 < M; k0 += 16) {
    const __nv_bfloat16* pa = sA + g * LDA + k0 + 2 * q;
    const uint32_t a0 = *reinterpret_cast<const uint32_t*>(pa);
    const uint32_t a1 = *reinterpret_cast<const uint32_t*>(pa + 8 * LDA);
    const uint32_t a2 = *reinterpret_cast<const uint32_t*>(pa + 8);
    const uint32_t a3 = *reinterpret_cast<const uint32_t*>(pa + 8 * LDA + 8);
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      const int n0 = nb + 8 * j;
      const uint32_t s = (__popc(k0 & n0) & 1) ? kNeg : 0u;
      const uint32_t f = (n0 & 8) ? kNeg : 0u;
      mma_bf16(acc[j], a0, a1, a2, a3, b0 ^ s, b1 ^ s ^ f);
    }
  }
#pragma unroll
  for (int j = 0; j < NTW; ++j) {
    const int col = nb + 8 * j + 2 * q;
    *reinterpret_cast<float2*>(out + (size_t)g * M + col) =
        make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(out + (size_t)(g + 8) * M + col) =
        make_float2(acc[j][2], acc[j][3]);
  }
}

// R3 of iteration t.  work holds u = H_L (bf16(z) H_M) on entry and, unless this
// is the codeword's last iteration, bf16(beta'_new) H_M on exit.  beta
// holds beta' and, after the codeword's last iteration, the true-scale beta.
// One warp per row at a time; lane i holds columns i + 32 j.
template <int M>
__global__ void __launch_bounds__(32 * RowShape<M>::NW)
mono_row_kernel(float* __restrict__ work, float* __restrict__ beta,
                const float* __restrict__ zpart,  // (B, M / 32)
                float* __restrict__ bpart,        // (B, L)
                float* __restrict__ trace,        // (T, B)
                int32_t* __restrict__ iters,      // (B,)
                int32_t* __restrict__ active,     // (T + 1, B)
                const int32_t* __restrict__ pin,  // (B, L) or null
                const float* __restrict__ sched,  // (T,) or null
                const float* __restrict__ sqi, const float* __restrict__ sqo,
                int B, int L, int t, int last, float n,
                float inv_sqrt_n, float tol) {
  constexpr int NS = M / kStrip;  // |z|^2 partials (one block per strip)
  constexpr int NW = RowShape<M>::NW, LDA = RowShape<M>::LDA, EPL = M / 32;
  __shared__ __align__(16) __nv_bfloat16 sA[kTileRows * LDA];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const bool lead = blockIdx.x == 0 && threadIdx.x == 0;
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
    float zz = 0.f;
#pragma unroll
    for (int s = 0; s < NS; ++s) zz += zpart[(size_t)b * NS + s];
    tau2 = zz / n;
  }
  const bool conv = fabsf(tau2 - tau2_prev) < tol * tau2;
  const bool fin = last || conv;  // this codeword's last iteration
  const size_t base = ((size_t)b * L + (size_t)blockIdx.x * kTileRows) * M;

  for (int r = warp; r < kTileRows; r += NW) {
    const int l = blockIdx.x * kTileRows + r;
    const size_t off = base + (size_t)r * M + lane;
    float v[EPL];
#pragma unroll
    for (int i = 0; i < EPL; ++i) v[i] = work[off + 32 * i];
    if (t > 0) {
#pragma unroll
      for (int i = 0; i < EPL; ++i) v[i] += beta[off + 32 * i];
    }
    const float ai = sqi[l] / tau2;
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < EPL; ++i) {
      v[i] = ai * v[i];
      mx = fmaxf(mx, v[i]);
    }
    mx = warp_max(mx);
    float se = 0.f;
#pragma unroll
    for (int i = 0; i < EPL; ++i) {
      v[i] = expf(v[i] - mx);
      se += v[i];
    }
    se = warp_sum(se);
    const float so = sqo[l] / se;
#pragma unroll
    for (int i = 0; i < EPL; ++i) v[i] = so * v[i];
    if (pin != nullptr) {
      const int p = pin[(size_t)b * L + l];
      if (p >= 0) {
#pragma unroll
        for (int i = 0; i < EPL; ++i) v[i] = (lane + 32 * i == p) ? sqo[l] : 0.f;
      }
    }
    if (fin) {
#pragma unroll
      for (int i = 0; i < EPL; ++i) beta[off + 32 * i] = v[i] * inv_sqrt_n;
    } else {
      float bb = 0.f;
#pragma unroll
      for (int i = 0; i < EPL; ++i) {
        beta[off + 32 * i] = v[i];
        bb += v[i] * v[i];
        sA[r * LDA + lane + 32 * i] = __float2bfloat16_rn(v[i]);
      }
      bb = warp_sum(bb);
      if (lane == 0) bpart[(size_t)b * L + l] = bb;
    }
  }
  if (!fin) {  // uniform per block
    __syncthreads();
    hm_mma<M>(sA, work + base);
  }
  if (lead) {
    trace[(size_t)t * B + b] = tau2;
    active[(size_t)(t + 1) * B + b] = fin ? 0 : 1;
    if (fin) iters[b] = t + 1;
  }
}

// Support entries (K1's order) of a column-stage block that C1 stages in
// shared memory, and entries of a codeword that R2C2 stages (8 bytes each,
// beside the transpose buffer and the row offsets); a launch with more
// reads them from device memory.
template <int W, int R>
__host__ __device__ constexpr int mono_col_smem_bytes() {
  return W * R * kStrip * 4 + 3 * entry_cap<W, R>() * 4 + 2 * 32 * W * 4;
}
constexpr int kAdjCap = 11264;
template <int W, int R>
__host__ __device__ constexpr int mono_adj_smem_bytes() {
  return W * R * kStrip * 4 + (W * R + 4) * 4 + kAdjCap * 8;
}

// bf16(z) with its column m (< 2^16) in one word: the bf16 bits above, so
// the word with its low half cleared is the float bf16(z).
__device__ __forceinline__ uint32_t pack_entry(float z, int m) {
  return ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(z)) << 16) |
         (uint32_t)m;
}

// C1 of iteration t.  work holds w = bf16(beta') H_M (float32, from R3) on
// entry and is only read.  The walk of K1's column stage (k1_col_kernel at
// FA = 1): walker i takes the items (codeword, strip) i, i + walkers, ...
// of the active codewords; cp.async brings an item's float32 strip of the
// work tile (16 bytes a thread) and its support data (y, z, mask/n, each
// thread's word and first entry) into shared memory while the item before
// is finished.  The strip's buffer is also the transpose buffer: a thread
// reads its rows in layout A, runs H_L's first butterflies and writes them
// back where it read them, and after a barrier reads layout B; then the
// next strip's copy starts and overlaps H_L's last butterflies, the
// residual and the reductions.  On the thread's support rows z = y -
// mask/n * v + coef * z in K1's order, z written compact in K1's order and,
// as bf16 with its column, at its row-major place (row_index) in zr; the
// strip's |z|^2 and the next item's |beta'|^2 in one block reduction.
template <int W, int R, int M>
__global__ void __launch_bounds__(32 * W, 1)
mono_col_kernel(const float* __restrict__ work, const float* __restrict__ yc,
                float* __restrict__ zc, uint32_t* __restrict__ zr,
                Support sp, const int32_t* __restrict__ row_index,
                float* __restrict__ zpart,        // (B, M / 32)
                const float* __restrict__ bpart,  // (B, L) row |beta'|^2
                const float* __restrict__ trace,  // (T, B)
                const int32_t* __restrict__ active,  // (T + 1, B)
                int B, int t, float P, float nn) {
  extern __shared__ __align__(16) float mc_sm[];
  __shared__ float red[2 * W];
  constexpr int L = W * R, NT = 32 * W, S = M / kStrip;
  constexpr int CAP = entry_cap<W, R>();
  float* sm = mc_sm;  // strip and transpose buffer, then the support data
  float* ys = sm + L * kStrip;
  float* zs = ys + CAP;
  float* ms = zs + CAP;
  uint32_t* tword = reinterpret_cast<uint32_t*>(ms + CAP);
  int32_t* toff = reinterpret_cast<int32_t*>(tword + NT);
  const int w = threadIdx.x >> 5, c = threadIdx.x & 31;
  const int walkers = gridDim.x, items = B * S;
  const int32_t* act = active + (size_t)t * B;
  auto next = [&](int it) {
    while (it < items && !act[it / S]) it += walkers;
    return it;
  };
  // cp.async of an item's float32 strip of the work tile into sm
  auto fetch_work = [&](int it) {
    const float* src =
        work + (size_t)(it / S) * L * M + (size_t)(it % S) * kStrip;
    for (int q = threadIdx.x; q < L * 8; q += NT) {
      const int r = q >> 3, p = q & 7;
      cp_async16(sm + r * kStrip + 4 * p, src + (size_t)r * M + 4 * p);
    }
  };
  auto fetch_entries = [&](int it) {
    const int s = it % S;
    const size_t tab = (size_t)w * M + s * kStrip + c;
    cp_async4(tword + threadIdx.x, sp.word + tab);
    cp_async4(toff + threadIdx.x, sp.offset + tab);
    const int first = sp.block[s], count = sp.block[s + 1] - first;
    if (count > CAP) return;
    const size_t off = (size_t)(it / S) * sp.ns + first;
    for (int i = threadIdx.x; i < count; i += NT) {
      cp_async4(ys + i, yc + off + i);
      cp_async4(ms + i, sp.mask + first + i);
      if (t > 0) cp_async4(zs + i, zc + off + i);
    }
  };
  auto bterms = [&](int it) {
    float acc = 0.f;
    if (t > 0 && it < items) {
      const float* bp = bpart + (size_t)(it / S) * L;
      for (int l = threadIdx.x; l < L; l += NT) acc += bp[l];
    }
    return acc;
  };

  int it = next(blockIdx.x);
  if (it >= items) return;
  if (t > 0) fetch_work(it);
  fetch_entries(it);
  float bnorm2 = block_sum2<W>(bterms(it), 0.f, red).x;
  while (it < items) {
    const int nx = next(it + walkers);
    const int b = it / S, s = it % S, m = s * kStrip + c;
    const int first = sp.block[s];
    const bool staged = sp.block[s + 1] - first <= CAP;
    const float tau2_prev = t > 0 ? trace[(size_t)(t - 1) * B + b] : 1.f;
    const float bnext = bterms(nx);  // consumed after this item's residual
    cp_async_wait_all();
    __syncthreads();  // this item's strip and support data are visible
    const uint32_t word = tword[threadIdx.x];
    float v[R];
    float coef = 0.f;  // beta' = 0 and z = 0 before the first iteration
    if (t > 0) {
      coef = (P - bnorm2 / nn) / tau2_prev;
#pragma unroll
      for (int k = 0; k < R; ++k) v[k] = sm[(w + W * k) * kStrip + c];
      reg_fwht<R, R>(v);
      // layout A to B in place: each thread rewrites the places it read
#pragma unroll
      for (int k = 0; k < R; ++k) sm[(w + W * k) * kStrip + c] = v[k];
      __syncthreads();
#pragma unroll
      for (int k = 0; k < R; ++k) v[k] = sm[(R * w + k) * kStrip + c];
      __syncthreads();  // every thread has read the strip
      if (nx < items) fetch_work(nx);
      reg_fwht<R, W>(v);
    } else {
#pragma unroll
      for (int k = 0; k < R; ++k) v[k] = 0.f;
    }
    const size_t cw = (size_t)b * sp.ns;
    const float* ysrc = staged ? ys - first : yc + cw;
    const float* zsrc = staged ? zs - first : zc + cw;
    const float* msrc = staged ? ms - first : sp.mask;
    const int e0 = toff[threadIdx.x];
    float zz = 0.f;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      if ((word >> k) & 1u) {
        const int e = e0 + __popc(word & ((1u << k) - 1u));
        float zk = ysrc[e] - msrc[e] * v[k];
        if (t > 0) zk += coef * zsrc[e];
        zc[cw + e] = zk;
        zr[cw + row_index[e]] = pack_entry(zk, m);
        zz += zk * zk;
      }
    }
    // this item's |z|^2 and the next item's |beta'|^2; the barriers also
    // end every thread's reads of the support data
    const float2 sums = block_sum2<W>(zz, bnext, red);
    if (threadIdx.x == 0) zpart[(size_t)b * S + s] = sums.x;
    if (nx < items) fetch_entries(nx);
    bnorm2 = sums.y;
    it = nx;
  }
}

// R2C2 of iteration t: work = u = H_L (bf16(z) H_M) of every active
// codeword, from zr (B, ns), z's packed entries in row-major order (row l's
// are row_offset[l] .. row_offset[l + 1] - 1, in column order).  Walkers as
// C1's over (codeword, strip) items.  Thread (w, c) builds column
// m = 32 s + c of its rows w + W k (layout A) from the row's entries:
//   (bf16(z) H_M)[l][m] = sum over the row's entries (m', z), in column
//   order, of (-1)^popc(m' & m) bf16(z),
// with the sign split as (-1)^popc(m'_hi & s) (the entry's, the same for
// the whole strip) times (-1)^popc(m'_lo & c) (m'_lo = m' % 32: bit 31 of
// the lane's mask xc shifted left by m'_lo), so a term costs a shift, a
// logic operation and an add.  Each item stages its codeword's entries in
// shared memory as (bf16(z) with the strip's sign, m'_lo) pairs: cp.async
// brings the packed words while the item before is transformed, and one
// pass turns them into pairs (ns <= kAdjCap; above, the terms are formed
// from device memory, the same values in the same order).  Then H_L in
// float32 (layout A to B) and the strip is stored.  With active == nullptr
// every codeword runs (the standalone adjoint, amp_mono_adjoint).
template <int W, int R, int M>
__global__ void __launch_bounds__(32 * W, 1)
mono_adj_kernel(const uint32_t* __restrict__ zr,
                const int32_t* __restrict__ row_offset, int ns,
                float* __restrict__ work,
                const int32_t* __restrict__ active, int B, int t) {
  extern __shared__ __align__(16) float ma_sm[];
  constexpr int L = W * R, NT = 32 * W, S = M / kStrip;
  float* sm = ma_sm;  // transpose buffer, row offsets, staged entries
  int32_t* rows = reinterpret_cast<int32_t*>(sm + L * kStrip);
  int2* ent = reinterpret_cast<int2*>(rows + L + 4);
  const int w = threadIdx.x >> 5, c = threadIdx.x & 31;
  const int walkers = gridDim.x, items = B * S;
  const bool staged = ns <= kAdjCap;
  const int32_t* act = active != nullptr ? active + (size_t)t * B : nullptr;
  // bit 31 - k of xc is popc(k & c) & 1
  uint32_t xc = 0u;
#pragma unroll
  for (int k = 0; k < 32; ++k) xc |= (uint32_t)(__popc(k & c) & 1) << (31 - k);
  auto next = [&](int it) {
    while (act != nullptr && it < items && !act[it / S]) it += walkers;
    return it;
  };
  // the packed words of an item's codeword into the pairs' second halves
  auto fetch = [&](int it) {
    const uint32_t* src = zr + (size_t)(it / S) * ns;
    for (int i = threadIdx.x; i < ns; i += NT) cp_async4(&ent[i].y, src + i);
  };
  // (bf16(z) with the strip's sign, as float bits; m' % 32) of a packed word
  auto pair = [](uint32_t p, int s) {
    const uint32_t hi = (p >> 5) & 31u;
    const uint32_t sgn = (uint32_t)(__popc(hi & (uint32_t)s) & 1) << 31;
    return make_int2((int)((p & 0xFFFF0000u) ^ sgn), (int)(p & 31u));
  };
  auto term = [&](int2 q) {
    return __uint_as_float(((xc << q.y) & 0x80000000u) ^ (uint32_t)q.x);
  };
  for (int i = threadIdx.x; i <= L; i += NT) rows[i] = row_offset[i];
  int it = next(blockIdx.x);
  if (it >= items) return;
  if (staged) fetch(it);
  while (it < items) {
    const int nx = next(it + walkers);
    const int b = it / S, s = it % S;
    cp_async_wait_all();
    __syncthreads();  // the staged words (and the row offsets) are visible
    if (staged) {
      for (int i = threadIdx.x; i < ns; i += NT)
        ent[i] = pair((uint32_t)ent[i].y, s);
      __syncthreads();
    }
    const uint32_t* zb = zr + (size_t)b * ns;
    float v[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int l = w + W * k;
      const int j1 = rows[l + 1];
      float acc = 0.f;
      if (staged) {
#pragma unroll 4
        for (int j = rows[l]; j < j1; ++j) acc += term(ent[j]);
      } else {
        for (int j = rows[l]; j < j1; ++j) acc += term(pair(zb[j], s));
      }
      v[k] = acc;
    }
    __syncthreads();  // every thread has read the staged entries
    if (staged && nx < items) fetch(nx);
    reg_fwht<R, R>(v);
    a_to_b<W, R>(v, sm, w, c);
    reg_fwht<R, W>(v);
    float* dst = work + (size_t)b * L * M + s * kStrip + c;
#pragma unroll
    for (int k = 0; k < R; ++k) dst[(size_t)(R * w + k) * M] = v[k];
    it = nx;
  }
}

// ------------------------------------------------------------- launchers

// C1 and R2C2 for the column geometry (W, R) of L = W R <= 1024.
template <int W, int R>
struct MonoCols {
  static int encode(const float* y_n, const Support& sp, const float* sqo,
                    const int32_t* enc_idx, float* yc, int B, int M,
                    cudaStream_t st) {
    auto kernel = k1_encode_kernel<W, R, 1>;
    const int bytes = W * R * kStrip * (int)sizeof(float);
    int rc = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (rc) return rc;
    kernel<<<dim3(M / kStrip, B), 32 * W, bytes, st>>>(
        y_n, sp, sqo, enc_idx, nullptr, 0.f, yc, M);
    return (int)cudaGetLastError();
  }
  // Launch kernel with as many walkers as are resident, at most the items.
  template <typename K, typename... Args>
  static int walk(K kernel, int bytes, int B, int M, cudaStream_t st,
                  Args... args) {
    int rc = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (rc) return rc;
    int walkers = 0;
    rc = resident_walkers<1>(kernel, 32 * W, bytes, st, &walkers);
    if (rc) return rc;
    const int items = B * (M / kStrip);
    walkers = walkers < items ? walkers : items;
    kernel<<<walkers, 32 * W, bytes, st>>>(args...);
    return (int)cudaGetLastError();
  }
  template <int M>
  static int col(const float* work, const float* yc, float* zc, uint32_t* zr,
                 const Support& sp, const int32_t* row_index, float* zpart,
                 const float* bpart, const float* trace,
                 const int32_t* active, int B, int t, float P, float nn,
                 cudaStream_t st) {
    return walk(mono_col_kernel<W, R, M>, mono_col_smem_bytes<W, R>(), B, M,
                st, work, yc, zc, zr, sp, row_index, zpart, bpart, trace,
                active, B, t, P, nn);
  }
  template <int M>
  static int adj(const uint32_t* zr, const int32_t* row_offset, int ns,
                 float* work, const int32_t* active, int B, int t,
                 cudaStream_t st) {
    return walk(mono_adj_kernel<W, R, M>, mono_adj_smem_bytes<W, R>(), B, M,
                st, zr, row_offset, ns, work, active, B, t);
  }
};

template <class C>
struct MonoOf;
template <int W, int R>
struct MonoOf<Cols<W, R, 1>> {
  using type = MonoCols<W, R>;
};

#define MONO_CASES_M(CALL)                        \
  case 32: { constexpr int MM = 32; return CALL; }     \
  case 64: { constexpr int MM = 64; return CALL; }     \
  case 128: { constexpr int MM = 128; return CALL; }   \
  case 256: { constexpr int MM = 256; return CALL; }   \
  case 512: { constexpr int MM = 512; return CALL; }   \
  case 1024: { constexpr int MM = 1024; return CALL; }

int mono_encode(const float* y_n, const Support& sp, const float* sqo,
                const int32_t* enc_idx, float* yc, int B, int L, int M,
                cudaStream_t st) {
  DISPATCH_L1024(L, MonoOf<C>::type::encode(y_n, sp, sqo, enc_idx, yc, B, M,
                                            st))
}

template <class Q>
int mono_col_m(const float* work, const float* yc, float* zc, uint32_t* zr,
               const Support& sp, const int32_t* row_index, float* zpart,
               const float* bpart, const float* trace, const int32_t* active,
               int B, int M, int t, float P, float nn, cudaStream_t st) {
  switch (M) {
    MONO_CASES_M((Q::template col<MM>(work, yc, zc, zr, sp, row_index, zpart,
                                      bpart, trace, active, B, t, P, nn, st)))
    default: return kBadShape;
  }
}

int col_step(const float* work, const float* yc, float* zc, uint32_t* zr,
             const Support& sp, const int32_t* row_index, float* zpart,
             const float* bpart, const float* trace, const int32_t* active,
             int B, int L, int M, int t, float P, float nn, cudaStream_t st) {
  DISPATCH_L1024(L, (mono_col_m<MonoOf<C>::type>(
                        work, yc, zc, zr, sp, row_index, zpart, bpart, trace,
                        active, B, M, t, P, nn, st)))
}

template <class Q>
int mono_adj_m(const uint32_t* zr, const int32_t* row_offset, int ns,
               float* work, const int32_t* active, int B, int M, int t,
               cudaStream_t st) {
  switch (M) {
    MONO_CASES_M((Q::template adj<MM>(zr, row_offset, ns, work, active, B, t,
                                      st)))
    default: return kBadShape;
  }
}

int adj_step(const uint32_t* zr, const int32_t* row_offset, int ns,
             float* work, const int32_t* active, int B, int L, int M, int t,
             cudaStream_t st) {
  DISPATCH_L1024(L, (mono_adj_m<MonoOf<C>::type>(
                        zr, row_offset, ns, work, active, B, M, t, st)))
}

template <int M>
struct MonoRows {
  static constexpr int NT = 32 * RowShape<M>::NW;
  static int row(float* work, float* beta, const float* zpart, float* bpart,
                 float* trace, int32_t* iters, int32_t* active,
                 const int32_t* pin, const float* sched, const float* sqi,
                 const float* sqo, int B, int L, int t, int last, float n,
                 float inv_sqrt_n, float tol, cudaStream_t st) {
    mono_row_kernel<M><<<dim3(L / kTileRows, B), NT, 0, st>>>(
        work, beta, zpart, bpart, trace, iters, active, pin, sched, sqi, sqo,
        B, L, t, last, n, inv_sqrt_n, tol);
    return (int)cudaGetLastError();
  }
};

#define DISPATCH_MONO_M(M, CALL)                         \
  switch (M) {                                           \
    case 32: { using Q = MonoRows<32>; return CALL; }    \
    case 64: { using Q = MonoRows<64>; return CALL; }    \
    case 128: { using Q = MonoRows<128>; return CALL; }  \
    case 256: { using Q = MonoRows<256>; return CALL; }  \
    case 512: { using Q = MonoRows<512>; return CALL; }  \
    case 1024: { using Q = MonoRows<1024>; return CALL; } \
    default: return kBadShape;                           \
  }

int rows_softmax(float* work, float* beta, const float* zpart, float* bpart,
                 float* trace, int32_t* iters, int32_t* active,
                 const int32_t* pin, const float* sched, const float* sqi,
                 const float* sqo, int B, int L, int M, int t, int last,
                 float n, float inv_sqrt_n, float tol, cudaStream_t st) {
  DISPATCH_MONO_M(M, Q::row(work, beta, zpart, bpart, trace, iters, active,
                            pin, sched, sqi, sqo, B, L, t, last, n,
                            inv_sqrt_n, tol, st))
}

bool supported(int B, int L, int M) {
  return B >= 1 && B <= 65535 && pow2_in(L, 32, 1024) && pow2_in(M, 32, 1024);
}

}  // namespace

extern "C" {

// Whole-trial AMP of the monolithic form for B codewords.  Inputs: y_n
// (B, L, M) the channel noise (enc_idx given) or the whole observation
// (enc_idx null), read on the row support only.  The row support, ns
// entries in K1's order (ops/split_support.py): mask_c (ns,) mask/n of each
// entry, offset and word (L / R, M), block (M / 32 + 1,), perm (ns,)
// each entry's place in row-major order, row_offset (L + 1,) each row's
// first entry in row-major order.  sqi, sqo (L,); enc_idx (B, L) int32 or
// null; pin (B, L) int32 (-1 = unpinned) or null; sched (T,) SE tau2
// schedule or null; tol the early-stop threshold (0 = fixed T).  Outputs:
// beta (B, L, M) true scale, trace (T, B), iters (B,) int32.  active
// (T + 1, B) int32 holds the freeze flags and must arrive with row 0 all
// ones.  Scratch: yc, zc (B, ns) float, zr (B, ns) uint32, work (B, L, M)
// float; zpart (B, M / 32); bpart (B, L).  L, M powers of two in
// [32, 1024].  Returns 0, a cudaError_t, or -1 for an unsupported shape.
int amp_mono_run(const float* y_n, const float* mask_c, const int32_t* offset,
                 const uint32_t* word, const int32_t* block,
                 const int32_t* perm, const int32_t* row_offset, int ns,
                 const float* sqi, const float* sqo, const int32_t* enc_idx,
                 const int32_t* pin, const float* sched, float* beta,
                 float* trace, int32_t* iters, int32_t* active, float* yc,
                 float* zc, uint32_t* zr, float* work, float* zpart,
                 float* bpart, int B, int L, int M, int T, float P, float n,
                 float inv_sqrt_n, float tol, void* stream) {
  if (!supported(B, L, M) || T < 1 || y_n == nullptr || ns < 0)
    return kBadShape;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Support sp;
  sp.mask = mask_c;
  sp.offset = offset;
  sp.word = word;
  sp.block = block;
  sp.ns = ns;
  int rc = mono_encode(y_n, sp, sqo, enc_idx, yc, B, L, M, st);
  if (rc) return rc;
  const float nn = n * n;
  for (int t = 0; t < T; ++t) {
    rc = col_step(work, yc, zc, zr, sp, perm, zpart, bpart, trace,
                  active, B, L, M, t, P, nn, st);
    if (rc) return rc;
    rc = adj_step(zr, row_offset, ns, work, active, B, L, M, t, st);
    if (rc) return rc;
    rc = rows_softmax(work, beta, zpart, bpart, trace, iters, active, pin,
                      sched, sqi, sqo, B, L, M, t, t == T - 1, n, inv_sqrt_n,
                      tol, st);
    if (rc) return rc;
  }
  return 0;
}

// The decode's adjoint alone (R2C2 on every codeword): out (B, L, M) =
// H_L (bf16(z) H_M) from zr (B, ns), z's entries packed as mono_col_kernel
// writes them (bf16 bits above, the column below) in row-major order, with
// row_offset (L + 1,).
int amp_mono_adjoint(const uint32_t* zr, const int32_t* row_offset, int ns,
                     float* out, int B, int L, int M, void* stream) {
  if (!supported(B, L, M) || ns < 0) return kBadShape;
  return adj_step(zr, row_offset, ns, out, nullptr, B, L, M, 0,
                  static_cast<cudaStream_t>(stream));
}

const char* amp_mono_error_string(int code) {
  if (code == kBadShape) return "unsupported shape";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
