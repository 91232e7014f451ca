// Device code of the row-support layout (ops/split_support.py), shared by
// the split form's K1 (amp_split.cu) and the mono form's K6 (amp_mono.cu):
// the support tables, the compact encode with its in-kernel noise, the
// column stage's helpers (block sums of two values, cp.async, the sparse
// H_FA of a cluster) and the launch of FA-block clusters.  See
// amp_split.cu for the layout.

#pragma once

#include "amp_common.cuh"

namespace {

namespace cg = cooperative_groups;

// The support tables of the (L, M) tile (ops/split_support.py): entry e of
// the kernel's order, of ns, has mask/n mask[e]; (row-range g, column m)
// holds the rows R g + k whose bit k of word[g M + m] is set, entries
// offset[g M + m] on; column-stage block ib = strip * FA + cluster rank
// holds entries block[ib] .. block[ib + 1] - 1.
struct Support {
  const float* mask;
  const int32_t* offset;
  const uint32_t* word;
  const int32_t* block;
  int ns;
};

// Support entries of one column-stage block staged in shared memory; a
// block with more (a dense mask) reads them from device memory.
template <int W, int R>
__host__ __device__ constexpr int entry_cap() {
  return W * R * kStrip < 2048 ? W * R * kStrip : 2048;
}

// Sums of x and of y over a block of NW warps, each in block_sum's fixed
// order; every thread gets both.
template <int NW>
__device__ __forceinline__ float2 block_sum2(float x, float y, float* red) {
  x = warp_sum(x);
  y = warp_sum(y);
  __syncthreads();  // earlier readers of red are done
  if ((threadIdx.x & 31) == 0) {
    red[threadIdx.x >> 5] = x;
    red[NW + (threadIdx.x >> 5)] = y;
  }
  __syncthreads();
  float2 s = make_float2(0.f, 0.f);
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    s.x += red[i];
    s.y += red[NW + i];
  }
  return s;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// H_FA across the FA blocks of a cluster (block a holds rows 1024 a + the
// same local rows in the same layout), above L = 1024, on the support
// only.  The forward transform's result is read on the thread's support
// rows alone (its word): there v[k] = sum_a' (-1)^popc(a & a') x_a'[k] in
// amp_common.cuh's cluster_fwht's order, so the same values, from one
// remote read per other block and support row instead of all R values.
// With TAIL the blocks wait until every remote read is done; without, the
// caller's next cluster barrier must come before any block writes its sm.
template <int FA, int R, bool TAIL>
__device__ __forceinline__ void k1_cluster_on_support(float (&v)[R],
                                                      float* sm, int a,
                                                      uint32_t word) {
  if constexpr (FA > 1) {
    cg::cluster_group cl = cg::this_cluster();
    const int nt = blockDim.x;
    __syncthreads();  // this block's earlier readers of sm are done
#pragma unroll
    for (int k = 0; k < R; ++k) sm[k * nt + threadIdx.x] = v[k];
    cl.sync();
#pragma unroll
    for (int k = 0; k < R; ++k) {
      if ((word >> k) & 1u) {
        float s = 0.f;
#pragma unroll
        for (int a2 = 0; a2 < FA; ++a2) {
          const float x = a2 == a
                              ? v[k]
                              : cl.map_shared_rank(sm, a2)[k * nt + threadIdx.x];
          s = (__popc(a & a2) & 1) ? s - x : s + x;
        }
        v[k] = s;
      }
    }
    if constexpr (TAIL) cl.sync();
  }
}

// Encode: y on the support, compact.  As amp_common.cuh's amp_encode_kernel
// (the one-hot row's H_M in closed form, H_L in float32), then in layout B
// each thread draws the Philox blocks of its support rows only and writes
// noise + mask/n * v there.  Grid (FA * M / 32, B).
template <int W, int R, int FA>
__global__ void __launch_bounds__(32 * W, 1)
k1_encode_kernel(const float* __restrict__ y_n, Support sp,
                 const float* __restrict__ sqo,
                 const int32_t* __restrict__ enc_idx,
                 const uint32_t* __restrict__ seeds, float sigma,
                 float* __restrict__ yc, int M) {
  extern __shared__ float sm[];
  constexpr int L = FA * W * R;
  static_assert(R % 4 == 0, "a Philox block feeds four rows of a thread");
  const int w = threadIdx.x >> 5, c = threadIdx.x & 31;
  const int b = blockIdx.y, a = blockIdx.x % FA;
  const int m = (blockIdx.x / FA) * kStrip + c;
  const int l0 = a * W * R;  // this block's first row
  const size_t tab = (size_t)(a * W + w) * M + m;
  const uint32_t word = sp.word[tab];
  int e = sp.offset[tab];
  float v[R];
  if (enc_idx != nullptr) {
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int l = l0 + w + W * k;
      const float s = sqo[l];
      v[k] = (__popc(enc_idx[(size_t)b * L + l] & m) & 1) ? -s : s;
    }
    reg_fwht<R, R>(v);
    a_to_b<W, R>(v, sm, w, c);
    reg_fwht<R, W>(v);
    k1_cluster_on_support<FA, R, true>(v, sm, a, word);
  } else {
#pragma unroll
    for (int k = 0; k < R; ++k) v[k] = 0.f;
  }
  uint2 key = make_uint2(0u, 0u);
  if (seeds != nullptr) key = make_uint2(seeds[2 * b], seeds[2 * b + 1]);
  float* yb = yc + (size_t)b * sp.ns;
#pragma unroll
  for (int g = 0; g < R / 4; ++g) {
    if (((word >> (4 * g)) & 0xFu) == 0u) continue;
    float e4[4] = {0.f, 0.f, 0.f, 0.f};
    if (seeds != nullptr) normal4(key, m, (l0 + R * w) / 4 + g, e4);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = 4 * g + i;
      if ((word >> k) & 1u) {
        const float noise =
            seeds != nullptr
                ? __fmul_rn(sigma, e4[i])
                : y_n[((size_t)b * L + l0 + R * w + k) * M + m];
        yb[e] = noise + sp.mask[e] * v[k];
        ++e;
      }
    }
  }
}

// Launch config of FA-block clusters along x (a plain launch at FA = 1).
template <int FA>
struct ClusterLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  ClusterLaunch(dim3 grid, int threads, int bytes, cudaStream_t st) {
    cfg.gridDim = grid;
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = st;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = FA;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = FA > 1 ? 1 : 0;
  }
};

// Walkers (blocks, or clusters of FA blocks) of `kernel` resident on the
// current device at once with `threads` threads and `bytes` of dynamic
// shared memory (set beforehand), queried once per kernel and device.
template <int FA, typename... Args>
int resident_walkers(void (*kernel)(Args...), int threads, int bytes,
                     cudaStream_t st, int* out) {
  struct Entry {
    const void* kernel;
    int dev, count;
  };
  static Entry cache[64];
  static int used = 0;
  int dev = 0;
  int rc = (int)cudaGetDevice(&dev);
  if (rc) return rc;
  const void* key = reinterpret_cast<const void*>(kernel);
  for (int i = 0; i < used; ++i) {
    if (cache[i].kernel == key && cache[i].dev == dev) {
      *out = cache[i].count;
      return 0;
    }
  }
  int count = 0;
  if constexpr (FA == 1) {
    int per_sm = 0, sms = 0;
    rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                            threads, bytes);
    if (!rc)
      rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                       dev);
    count = per_sm * sms;
  } else {
    ClusterLaunch<FA> lc(dim3(FA), threads, bytes, st);
    rc = (int)cudaOccupancyMaxActiveClusters(&count, kernel, &lc.cfg);
  }
  if (rc) return rc;
  if (count < 1) count = 1;
  if (used < 64) cache[used++] = Entry{key, dev, count};
  *out = count;
  return 0;
}

}  // namespace
