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
//   tot = clip(llr);  mcv = 0                 (check messages)
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
// rolls.  Here device memory sees one LLR read and one posterior write a
// codeword; what bounds the decode is how many codewords decode at once
// on an SM, the instructions and on-chip accesses of the layer
// recurrence, and, where most codewords stop early, the latency of the
// few that run every iteration.  So:
//
// (a) Check state instead of edge messages.  A check's messages of one
//     layer are all rebuilt from (min1, min2, the signs of its blocks'
//     m_vc as bits, the bits of the blocks whose |m_vc| equalled min1):
//     exc = eq ? min2 : min1, the magnitude w(exc) = clip(alpha * exc) or
//     clip(max(exc - beta, 0)), and the sign sign_prod * sign_a applied by
//     flipping w's sign bit.  That is the plain engine's float bit for bit:
//     (alpha * s) * exc = s * (alpha * exc) and clip(s * x) = s * clip(x)
//     exactly for s = +-1, signed zeros included.  The first iteration's
//     messages are +0.0.  A codeword keeps its totals (K Z floats, and Z
//     scratch words) and one 16-byte state per (layer, check): about
//     K Z 4 + J Z 16 bytes, 4 960 for the z = 31 array code (14 880 with
//     per-edge messages).
// (b) A codeword's own barrier and its own exit.  A group of Z L threads
//     (rounded up to warps) serves one codeword: at Z L <= 32 one warp,
//     synchronised by __syncwarp; above, a named barrier of the group's
//     warps (bar.sync id, 32 w).  A codeword leaves the moment its
//     syndrome passes; the syndrome stops at a warp's first failing layer.
// (c) A work queue.  The grid is persistent (as many blocks as are
//     resident); each group takes its next codeword from a device counter
//     (atomicAdd), zeroed on the stream before the launch, so a codeword
//     that runs every iteration holds one group and nothing else.
// (d) A layer's edges in registers.  L lanes serve a check (two above 12
//     edges a layer, which halves the chain of dependent operations a
//     layer takes), each with S compile-time edge slots; each slot's
//     address comes from the host's address table (16-byte reads through
//     the read-only cache) and its m_vc stays in registers from the min
//     pass to the update pass.  An edge costs one read and one write of
//     the totals in shared memory an iteration, plus the syndrome's read;
//     the lanes' (min1, min2) and bits meet by warp shuffles.
// (e) The zero-block pass only where it changes a bit.  clip(y) + 0 is
//     idempotent once y has been through it (no -0.0 is left), so after
//     iteration 0, which runs every (layer, zero block), only the zero
//     blocks whose column the previous layer (cyclically) wrote run it:
//     the host's reduced list (ops/bp_qc_kernel.py `layer_table`).
//
// Within a layer check zc reads and writes tot[k][(zc + s) % Z], which no
// other check of the layer touches (a circulant is a permutation), and the
// zero-block pass touches columns the layer does not: a layer needs no
// barrier inside and one barrier after it.
//
// Bitwise equality: the subtractions, additions and multiplications use
// __fsub_rn / __fadd_rn / __fmul_rn, which nvcc never contracts into a
// fused multiply-add.  The sign is `x < 0` (so -0.0 counts as positive, as
// in the reference) and the clip is min(max(x, -c), c).
//
// Built by sparc_ldpc_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// and called through ctypes (plain C interface below).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBadShape = -1;        // return code for an unsupported shape
constexpr int kMaxSmem = 227 * 1024; // shared memory a block may use
constexpr int kWarpBlockThreads = 128;  // a block of one-warp codewords
constexpr int kBlockThreads = 256;   // a block of larger groups
constexpr int kMaxGroups = 15;       // named barriers 1..15 (0 is the block's)

__device__ __forceinline__ float clipf(float x, float c) {
  return fminf(fmaxf(x, -c), c);
}

// x with its sign bit flipped when bit is 1: exactly (bit ? -1 : 1) * x
__device__ __forceinline__ float flip(float x, uint32_t bit) {
  return __uint_as_float(__float_as_uint(x) ^ (bit << 31));
}

struct Params {
  const float* llr;
  const int32_t* tab;
  const int32_t* addr;
  float* tot_out;
  uint8_t* hard_out;
  int32_t* iters_out;
  uint8_t* ok_out;
  int32_t* counter;
  int B, J, K, Z, nA, nZ, nR, max_iters, oms;
  float alpha, beta, clip;
  int tab_bytes;   // the block's copy of the table, 16-byte aligned
  int cw_bytes;    // one group's codeword: state, totals, scratch, slot
};

// A check's message magnitude from exc (min1 or min2), unsigned.
__device__ __forceinline__ float magnitude(const Params& p, float exc) {
  const float w = p.oms ? fmaxf(__fsub_rn(exc, p.beta), 0.f)
                        : __fmul_rn(p.alpha, exc);
  return clipf(w, p.clip);
}

// Synchronisation of one codeword's group: the warp itself, or the
// group's warps on named barrier `id`.
template <bool WARP>
__device__ __forceinline__ void group_sync(int id, int n) {
  if (WARP) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
  }
}

template <bool WARP>
__device__ __forceinline__ bool group_any(bool v, int id, int n) {
  if (WARP) return __any_sync(0xffffffffu, v);
  uint32_t r;
  asm volatile(
      "{ .reg .pred p, q;\n"
      "  setp.ne.u32 p, %1, 0;\n"
      "  bar.red.or.pred q, %2, %3, p;\n"
      "  selp.u32 %0, 1, 0, q; }"
      : "=r"(r)
      : "r"((uint32_t)v), "r"(id), "r"(n)
      : "memory");
  return r != 0;
}

// Table layout (int32, from the host): layer_start[J + 1] (layer j has
// layer_start[j + 1] - layer_start[j] active blocks), zero_start[J + 1],
// zero_k[nZ], red_start[J + 1], red_k[nR]: zero_* lists every zero block
// of each layer (the pass of iteration 0), red_* the zero blocks whose
// column the previous layer wrote (the pass of every later one).
// The address table (int32, from the host, read through the read-only
// cache): for every layer j, check t, lane r < L of the check and slot
// m < S, the word of the totals that edge i = r S + m of the layer reads,
// k Z + (t + s) % Z for its i-th active block in increasing column
// order, or n + t past the layer's degree (a scratch word past the
// totals, so a layer's loads need no guard); as int4 chunks of four
// slots, [j][m / 4][t L + r] (neighbouring threads on neighbouring words).
// The block's shared copy of the table: the degrees, zero_start,
// red_start, and the zero lists' columns as k Z.
//
// A codeword's group has Z L threads (rounded up to warps): L lanes a
// check, each with S of the layer's edge slots (L S <= 32).  The lanes'
// min1 / min2 and bits are combined by shuffles within the warp.
template <int S, int L, bool WARP>
__global__ void __launch_bounds__(WARP ? kWarpBlockThreads : 1024)
    bp_qc_layered_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr unsigned kFull = 0xffffffffu;
  const int J = p.J, Z = p.Z, n = p.K * p.Z;
  const int4* g_addr = reinterpret_cast<const int4*>(p.addr);
  int* s_deg = reinterpret_cast<int*>(smem);
  int* s_zstart = s_deg + J;
  int* s_rstart = s_zstart + J + 1;
  int* s_zcol = s_rstart + J + 1;
  int* s_rcol = s_zcol + p.nZ;
  {
    const int32_t* t_lstart = p.tab;
    const int32_t* t_zstart = t_lstart + J + 1;
    const int32_t* t_zk = t_zstart + J + 1;
    const int32_t* t_rstart = t_zk + p.nZ;
    const int32_t* t_rk = t_rstart + J + 1;
    for (int i = threadIdx.x; i <= J; i += blockDim.x) {
      if (i < J) s_deg[i] = t_lstart[i + 1] - t_lstart[i];
      s_zstart[i] = t_zstart[i];
      s_rstart[i] = t_rstart[i];
    }
    for (int i = threadIdx.x; i < p.nZ; i += blockDim.x)
      s_zcol[i] = t_zk[i] * Z;
    for (int i = threadIdx.x; i < p.nR; i += blockDim.x)
      s_rcol[i] = t_rk[i] * Z;
  }
  __syncthreads();  // the only block-wide barrier

  const int gsize = WARP ? 32 : (Z * L + 31) / 32 * 32;  // a codeword's
  const int g = threadIdx.x / gsize, u = threadIdx.x % gsize;
  const int t = u / L, lane = u % L, lo = lane * S;  // check, first slot
  const bool chk = t < Z;
  const int rows = Z * L;  // rows of the address table
  const int bar_id = 1 + g;
  unsigned char* mine = smem + p.tab_bytes + (size_t)g * p.cw_bytes;
  uint4* state = reinterpret_cast<uint4*>(mine);  // [J][Z]
  float* tot = reinterpret_cast<float*>(state + (size_t)J * Z);
  int* slot = reinterpret_cast<int*>(mine + p.cw_bytes - 16);
  // 16-byte accesses where every row starts on 16 bytes
  const bool vec =
      (n & 3) == 0 &&
      ((reinterpret_cast<uintptr_t>(p.llr) |
        reinterpret_cast<uintptr_t>(p.tot_out)) & 15) == 0 &&
      (reinterpret_cast<uintptr_t>(p.hard_out) & 3) == 0;

  for (;;) {
    int b = 0;
    if (WARP) {
      if (u == 0) b = atomicAdd(p.counter, 1);
      b = __shfl_sync(kFull, b, 0);
    } else {
      if (u == 0) *slot = atomicAdd(p.counter, 1);
      group_sync<WARP>(bar_id, gsize);
      b = *slot;
    }
    if (b >= p.B) break;

    // the codeword's clipped LLRs; each thread touches the same words
    // here as in the write-out below
    if (vec) {
      const float4* src = reinterpret_cast<const float4*>(p.llr + (size_t)b * n);
      float4* dst = reinterpret_cast<float4*>(tot);
      for (int i = u; i < n / 4; i += gsize) {
        float4 v = __ldg(src + i);
        v.x = clipf(v.x, p.clip);
        v.y = clipf(v.y, p.clip);
        v.z = clipf(v.z, p.clip);
        v.w = clipf(v.w, p.clip);
        dst[i] = v;
      }
    } else {
      for (int i = u; i < n; i += gsize)
        tot[i] = clipf(__ldg(p.llr + (size_t)b * n + i), p.clip);
    }
    group_sync<WARP>(bar_id, gsize);

    int it = 0, ok = 0;
    while (it < p.max_iters) {
      const bool first = it == 0;
      const int* zstart = first ? s_zstart : s_rstart;
      const int* zcol = first ? s_zcol : s_rcol;
      for (int j = 0; j < J; ++j) {
        // this lane's edges: slots lo .. lo + cnt - 1 of the layer
        const int cnt = chk ? min(max(s_deg[j] - lo, 0), S) : 0;
        const int4* arow =
            g_addr + (size_t)j * (S / 4) * rows + (chk ? u : 0);
        // the previous iteration's messages, from the check state
        uint4 st = make_uint4(0u, 0u, 0u, 0u);
        if (!first && chk) st = state[j * Z + t];
        const float ow1 = first ? 0.f : magnitude(p, __uint_as_float(st.x));
        const float ow2 = first ? 0.f : magnitude(p, __uint_as_float(st.y));
        const uint32_t osg =
            (st.z ^ ((__popc(st.z) & 1) ? 0xffffffffu : 0u)) >> lo;
        const uint32_t oeq = st.w >> lo;
        // every load first (padded slots read the scratch word), then the
        // arithmetic, the padding masked out
        int ad[S];
        float mv[S];
#pragma unroll
        for (int c = 0; c < S / 4; ++c) {
          const int4 v = __ldg(arow + c * rows);
          ad[4 * c] = v.x;
          ad[4 * c + 1] = v.y;
          ad[4 * c + 2] = v.z;
          ad[4 * c + 3] = v.w;
        }
#pragma unroll
        for (int m = 0; m < S; ++m) mv[m] = tot[ad[m]];
        float m1 = INFINITY, m2 = INFINITY;
        uint32_t sg = 0u;
#pragma unroll
        for (int m = 0; m < S; ++m) {
          const float old =
              flip(((oeq >> m) & 1u) ? ow2 : ow1, (osg >> m) & 1u);
          mv[m] = clipf(__fsub_rn(mv[m], old), p.clip);
          const float mag = m < cnt ? fabsf(mv[m]) : INFINITY;
          m2 = fminf(m2, fmaxf(m1, mag));
          m1 = fminf(m1, mag);
          sg |= ((uint32_t)(mv[m] < 0.f) & (uint32_t)(m < cnt)) << m;
        }
        sg <<= lo;
        // the check's lanes: the two smallest of the union, every sign bit
#pragma unroll
        for (int o = 1; o < L; o <<= 1) {
          const float b1 = __shfl_xor_sync(kFull, m1, o);
          const float b2 = __shfl_xor_sync(kFull, m2, o);
          sg |= __shfl_xor_sync(kFull, sg, o);
          m2 = fminf(fmaxf(m1, b1), fminf(m2, b2));
          m1 = fminf(m1, b1);
        }
        const float w1 = magnitude(p, m1), w2 = magnitude(p, m2);
        const uint32_t nsg =
            (sg ^ ((__popc(sg) & 1) ? 0xffffffffu : 0u)) >> lo;
        uint32_t eq = 0u;
#pragma unroll
        for (int m = 0; m < S; ++m) {
          if (m < cnt) {
            const bool e1 = fabsf(mv[m]) == m1;
            eq |= (uint32_t)e1 << m;
            tot[ad[m]] = __fadd_rn(mv[m], flip(e1 ? w2 : w1, (nsg >> m) & 1u));
          }
        }
        eq <<= lo;
#pragma unroll
        for (int o = 1; o < L; o <<= 1) eq |= __shfl_xor_sync(kFull, eq, o);
        if (chk && lane == 0)
          state[j * Z + t] =
              make_uint4(__float_as_uint(m1), __float_as_uint(m2), sg, eq);
        if (chk) {
          for (int i = zstart[j] + lane; i < zstart[j + 1]; i += L) {
            float* q = tot + zcol[i] + t;
            *q = __fadd_rn(clipf(*q, p.clip), 0.f);
          }
        }
        group_sync<WARP>(bar_id, gsize);
      }
      // the syndrome, layer by layer; a warp stops at its first layer
      // with a failing check (the group's vote below sees it)
      bool bad = false;
      for (int j = 0; j < J; ++j) {
        const int cnt = chk ? min(max(s_deg[j] - lo, 0), S) : 0;
        const int4* arow =
            g_addr + (size_t)j * (S / 4) * rows + (chk ? u : 0);
        uint32_t par = 0u;
#pragma unroll
        for (int c = 0; c < S / 4; ++c) {
          const int4 v = __ldg(arow + c * rows);
          const int ad[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int m = 0; m < 4; ++m)
            par ^= (uint32_t)(tot[ad[m]] < 0.f) & (uint32_t)(4 * c + m < cnt);
        }
#pragma unroll
        for (int o = 1; o < L; o <<= 1) par ^= __shfl_xor_sync(kFull, par, o);
        bad = par != 0u;
        if (__any_sync(kFull, bad)) break;
      }
      ++it;
      if (!group_any<WARP>(bad, bar_id, gsize)) {
        ok = 1;
        break;
      }
    }

    if (vec) {
      const float4* src = reinterpret_cast<const float4*>(tot);
      float4* dst = reinterpret_cast<float4*>(p.tot_out + (size_t)b * n);
      uchar4* hard = reinterpret_cast<uchar4*>(p.hard_out + (size_t)b * n);
      for (int i = u; i < n / 4; i += gsize) {
        const float4 v = src[i];
        dst[i] = v;
        hard[i] = make_uchar4(v.x < 0.f, v.y < 0.f, v.z < 0.f, v.w < 0.f);
      }
    } else {
      for (int i = u; i < n; i += gsize) {
        p.tot_out[(size_t)b * n + i] = tot[i];
        p.hard_out[(size_t)b * n + i] = tot[i] < 0.f;
      }
    }
    if (u == 0) {
      p.iters_out[b] = it;
      p.ok_out[b] = ok;
    }
    group_sync<WARP>(bar_id, gsize);
  }
}

template <int S, int L, bool WARP>
int launch(Params p, cudaStream_t stream) {
  auto kern = bp_qc_layered_kernel<S, L, WARP>;
  // shared memory: the table (degrees, the zero lists) and each group's
  // codeword (its check state, its totals and scratch words, its queue
  // slot)
  const long tab = 4L * (p.J + 2 * (p.J + 1) + p.nZ + p.nR);
  const long cw = 16L * p.J * p.Z +
                  ((long)(p.K + 1) * p.Z * 4 + 15) / 16 * 16 + 16;
  p.tab_bytes = (int)((tab + 15) / 16 * 16);
  if (p.tab_bytes + cw > kMaxSmem) return kBadShape;
  p.cw_bytes = (int)cw;
  const int gsize = WARP ? 32 : (p.Z * L + 31) / 32 * 32;
  int groups = (WARP ? kWarpBlockThreads : kBlockThreads) / gsize;
  if (groups < 1) groups = 1;
  if (groups > kMaxGroups) groups = kMaxGroups;
  while (groups > 1 && p.tab_bytes + groups * cw > kMaxSmem) --groups;
  const int threads = groups * gsize;
  const int smem = p.tab_bytes + groups * p.cw_bytes;
  int rc, dev = 0, sms = 0, per_sm = 0;
  if ((rc = (int)cudaFuncSetAttribute(
           kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)))
    return rc;
  if ((rc = (int)cudaGetDevice(&dev))) return rc;
  if ((rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                        dev)))
    return rc;
  if ((rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, threads, smem)))
    return rc;
  if (per_sm < 1) return kBadShape;
  const long resident = (long)per_sm * sms;  // the persistent grid
  const long want = ((long)p.B + groups - 1) / groups;
  const int grid = (int)(want < resident ? want : resident);
  if ((rc = (int)cudaMemsetAsync(p.counter, 0, sizeof(int32_t), stream)))
    return rc;
  kern<<<grid, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// The (lanes a check, slots a lane) layouts the host may ask for:
// ops/bp_qc_kernel.py EDGE_LAYOUTS.
template <bool WARP>
int dispatch(const Params& p, int slots, int lanes, cudaStream_t s) {
  switch (lanes * 100 + slots) {
    case 108: return launch<8, 1, WARP>(p, s);
    case 112: return launch<12, 1, WARP>(p, s);
    case 208: return launch<8, 2, WARP>(p, s);
    case 212: return launch<12, 2, WARP>(p, s);
    case 216: return launch<16, 2, WARP>(p, s);
  }
  return kBadShape;
}

}  // namespace

extern "C" {

// Layered min-sum (method 0) or offset min-sum (method 1) for B codewords
// of n = K * Z bits.  llr (B, n) float32; tab the int32 table described
// above, with nZ zero and nR reduced zero blocks over the J layers (and
// nA active ones); addr the address table for `lanes` lanes a check of
// `slots` edge slots each (lanes * slots at least the largest degree, at
// most 32); counter one int32 of scratch (the work queue).  Outputs: tot
// (B, n) float32 posteriors, hard (B, n) uint8 decisions tot < 0, iters
// (B,) int32 and ok (B,) bytes 0/1.  Returns 0, a cudaError_t, or -1 for
// an unsupported shape.
int bp_qc_layered_run(const float* llr, const int32_t* tab,
                      const int32_t* addr, float* tot, uint8_t* hard,
                      int32_t* iters, uint8_t* ok, int32_t* counter, int B,
                      int J, int K, int Z, int nA, int nZ, int nR,
                      int slots, int lanes, int max_iters, int method,
                      float alpha, float beta, float clip, void* stream) {
  if (B < 1 || J < 1 || K < 1 || Z < 1 || lanes < 1 || Z * lanes > 1024 ||
      nA < 1 || nA + nZ != J * K || nR < 0 || nR > nZ || max_iters < 0 ||
      (method != 0 && method != 1))
    return kBadShape;
  Params p{llr, tab, addr, tot, hard, iters, ok, counter, B, J, K, Z, nA,
           nZ, nR, max_iters, method, alpha, beta, clip, 0, 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return Z * lanes <= 32 ? dispatch<true>(p, slots, lanes, s)
                         : dispatch<false>(p, slots, lanes, s);
}

const char* bp_qc_layered_error_string(int code) {
  if (code == kBadShape) return "unsupported shape";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
