// Paged decode attention: a C-row query block per slot attends over that
// slot's K/V pages, found through its block table.
//   q (B, C, H, hd), k/v pages (P, ps, KVH, hd), pos pages (P, ps) int32,
//   block table (B, max_pages) int32, q_pos (B, C) int32 -> out (B, C, H, hd)
//
// Replaces the Pallas TPU kernel `paged_decode_attention` (`_paged_kernel`)
// in src/repro/kernels/paged_attention/kernel.py.
//
// Semantics kept from it: query head kvh * n_rep + r reads KV head kvh; a
// key counts only if its position is >= 0 (unwritten entries hold -1 and an
// unmapped block-table entry, -1, folds its whole page to -1), if
// q_pos - k_pos >= 0 when causal, and if q_pos - k_pos < window when
// windowed; masked scores are NEG_INF = -1e30 (not -inf), so a masked key
// contributes an exact 0 once any valid key has been seen; a K-block of
// `kblock` block-table entries that are all unmapped is skipped; the
// softmax runs online in float32 and the output is acc / max(l, 1e-30).
// Rows with no valid key are garbage here as in every implementation, and
// callers mask them out.
//
// Bound on the H100: memory, and at decode sizes latency.  Each (slot, KV
// head) reads its mapped pages' K and V once (2 * hd elements per
// position) and does ~4 * n_rep * C flops per element read, far below the
// ~295 flops per byte balance point.  The least time is the mapped pages'
// K/V/pos bytes plus q and out, over 3.35 TB/s: 0.99 us at the
// tmux-12l-768h slice (B 8, 12 KV heads of 64, ~8.4 pages of 16 per slot),
// where one block per (slot, KV head) walking its pages one after another
// with synchronous staging spent ~25 us in exposed load latency.
//
// Design (split-K, "flash-decoding", over an asynchronous page ring):
//
//   * The block-table axis is split across S <= 8 blocks per (slot, KV
//     head), launched as one thread-block cluster along x: grid (S, KVH,
//     B).  Split s takes the contiguous entries [s E, s E + E), E a
//     multiple of kblock; the Python plan (repro_torch/kernels/
//     paged_attention/kernel.py: `plan`) picks S from max_pages and the SM
//     count (480 blocks at the slice: S = 5 of 2 entries).
//   * A producer warp streams each K-block's pages through a ring of >= 3
//     stages with full/empty mbarriers: one TMA load per mapped page and
//     tensor, through 4-D maps over (hd, KVH, ps, P) with a box (hd, 1, ps,
//     1) -- one page of one KV head -- at the page the block table names.
//     Unmapped entries issue no load; the full barrier expects only the
//     mapped pages' bytes.  So the loads of the next stages overlap the
//     math of this one.
//   * Four consumer warps.  G = hd * size / 16 lanes (a power of two, at
//     most 32) hold a key row, 16 bytes each, so a warp reads 32 * 16
//     contiguous bytes, free of bank conflicts, and 32 / G keys are in
//     flight per warp.  Each lane group is its own online-softmax stream
//     (running max m, sum l, f32 accumulator over its lanes' columns) for
//     all R = C * n_rep query rows, kept in registers, so the math needs
//     no block barrier.  A score is the group's dot product (q pre-scaled
//     by scale * log2 e, exp2 below), reduced with log2 G shuffles, and
//     one exp2 per key and row updates the stream (one of the rescale and
//     the weight is exp2(0)).  Keys of unmapped entries in a mapped K-block
//     are neither read nor counted.
//   * The block first reads its split's table entries and then their key
//     positions into shared memory (one round trip each, the second while
//     the first pages are in flight), so no global read sits between one
//     K-block and the next; ring stage and parity advance by counting and
//     a row splits into (entry, offset) by a shift, so the loops hold no
//     integer division (dividing by the runtime page size and ring depth
//     was a measurable share of each K-block's time).
//   * Merge: the lane groups of a warp merge by shuffles, the four warps
//     through shared memory into the block's (m, l, acc); after a cluster
//     barrier the S blocks share the R x hd outputs, each reading the S
//     partials of its outputs through distributed shared memory (all S
//     loads of an output in flight at once), weighting each by exp2(m - M)
//     (M the row's max over the partials) and writing acc / max(l, 1e-30).
//     One launch, no device scratch.  A partial that saw no key keeps
//     m = -1e30, l = 0, acc = 0; beside any partial with a valid key its
//     weight is exp2(-1e30 - M) = 0 exactly, and -1e30 - (-1e30) = 0 gives
//     weight 1, never NaN.
//
// Math on CUDA cores: at C * n_rep = 1 query row per block there is
// nothing for a tensor core to do.
//
// Where the time goes (clock64 traces of one block, H100): a K-block's
// handoff and math are latency -- shared-memory reads, the shuffle chain,
// the barrier handoff -- not bytes, so the split count, not the ring depth,
// sets the time.  Tried and dropped, each slower or no faster at the slice
// or at 64 pages per slot: a ring of 8 or 16 stages; cp.async 16-byte
// copies by the producer warp instead of TMA; each warp taking whole
// K-blocks in turn with one rescale per 4 keys (fewer warps busy at the
// slice); loading a warp's next row before its math (the wait for the next
// K-block's pages then delays this one's math).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kConsumerWarps = 4;
constexpr int kThreads = 32 * (kConsumerWarps + 1);  // + the producer warp
constexpr int kMaxSplits = 8;                          // portable cluster
constexpr int kMaxRows = 16;                           // C * n_rep

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The VEC = 16 / sizeof(T) values of a 16-byte chunk, as floats.
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

// Bytes of one staged page of one KV head (ps x hd, dense), rounded up so
// that every TMA destination stays 128-byte aligned.
__host__ __device__ __forceinline__ int page_bytes(int ps, int hd,
                                                   int size) {
  return (ps * hd * size + 127) / 128 * 128;
}

// Dynamic shared memory, in this order after 1024 bytes of alignment
// slack: the ring (stages x [kblock K pages, kblock V pages]), q (R x hd
// f32), the consumer warps' partial accumulators (4 x R x hd f32), maxima
// and sums (4 x R each), the block's merged partial (R x hd, R, R), the
// split's block-table entries and their key positions (entries x (1 + ps)
// int32), then (8-byte aligned) the full and empty barriers.
inline size_t smem_bytes(int R, int hd, int ps, int kblock, int size,
                         int stages, int entries) {
  return 1024 + (size_t)stages * 2 * kblock * page_bytes(ps, hd, size) +
         4 * ((size_t)R * hd + (size_t)kConsumerWarps * R * (hd + 2) +
              (size_t)R * (hd + 2) + (size_t)entries * (1 + ps)) +
         8 + 16 * (size_t)stages;
}

// RT: query rows held in registers (>= R = C * n_rep).
template <typename T, int RT>
__global__ void __launch_bounds__(kThreads) paged_split_kernel(
    const __grid_constant__ CUtensorMap mk,
    const __grid_constant__ CUtensorMap mv, const T* __restrict__ q,
    const int* __restrict__ pos_pages, const int* __restrict__ block_table,
    const int* __restrict__ q_pos, T* __restrict__ out, int C, int H,
    int KVH, int hd, int ps, int max_pages, int kblock, int entries,
    int stages, float scale_log2, int causal, int window) {
  using namespace hopper;
  constexpr int VEC = 16 / sizeof(T);
  cg::cluster_group cluster = cg::this_cluster();
  const int split = blockIdx.x, S = gridDim.x;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int n_rep = H / KVH, R = C * n_rep;
  const int pb = page_bytes(ps, hd, sizeof(T));
  const int stage_bytes = 2 * kblock * pb;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align1024(smem_raw);
  float* qs = reinterpret_cast<float*>(ring + (size_t)stages * stage_bytes);
  float* part_acc = qs + R * hd;
  float* part_m = part_acc + kConsumerWarps * R * hd;
  float* part_l = part_m + kConsumerWarps * R;
  float* blk_acc = part_l + kConsumerWarps * R;
  float* blk_m = blk_acc + R * hd;
  float* blk_l = blk_m + R;
  int* bts = reinterpret_cast<int*>(blk_l + R);  // this split's entries
  int* kpos = bts + entries;                     // and their key positions
  uint64_t* full = reinterpret_cast<uint64_t*>(
      (reinterpret_cast<uintptr_t>(kpos + entries * ps) + 7) &
      ~uintptr_t(7));
  uint64_t* empty = full + stages;

  const int e0 = split * entries;
  const int n_e = min(entries, max_pages - e0);  // >= 1 (the plan's rule)
  const size_t page_elems = (size_t)ps * hd;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumerWarps);
    }
    fence_barrier_init();
  }
  // One round trip for everything the block reads besides K and V's
  // pages: q (pre-scaled into log2 space) and the split's table entries.
  for (int i = threadIdx.x; i < R * hd; i += kThreads) {
    const int r = i / hd, c = r / n_rep, head = kvh * n_rep + r % n_rep;
    qs[i] = to_f(q[(((size_t)b * C + c) * H + head) * hd + i % hd]) *
            scale_log2;
  }
  for (int i = threadIdx.x; i < n_e; i += kThreads)
    bts[i] = block_table[(size_t)b * max_pages + e0 + i];
  __syncthreads();

  if (warp == kConsumerWarps) {  // producer
    if (lane == 0) {
      int s = 0, phase = 0;  // ring stage and its use's parity
      for (int k0 = 0; k0 < n_e; k0 += kblock) {
        int mapped = 0;
        for (int j = 0; j < kblock && k0 + j < n_e; ++j)
          mapped += bts[k0 + j] >= 0;
        if (!mapped) continue;  // the consumers skip it too
        mbar_wait(empty + s, phase ^ 1);
        mbar_arrive_expect_tx(full + s,
                              2u * mapped * page_elems * sizeof(T));
        uint8_t* st = ring + (size_t)s * stage_bytes;
        for (int j = 0; j < kblock && k0 + j < n_e; ++j) {
          const int page = bts[k0 + j];
          if (page < 0) continue;
          tma_load_4d(st + j * pb, &mk, full + s, 0, kvh, 0, page);
          tma_load_4d(st + (kblock + j) * pb, &mv, full + s, 0, kvh, 0,
                      page);
        }
        if (++s == stages) s = 0, phase ^= 1;
      }
    }
  } else {
    // Key positions of the split (-1 for unmapped entries), staged while
    // the first pages are in flight.
    for (int i = threadIdx.x; i < n_e * ps; i += 32 * kConsumerWarps) {
      const int page = bts[i / ps];
      kpos[i] = page >= 0 ? pos_pages[(size_t)page * ps + i % ps] : -1;
    }
    named_bar_sync(1, 32 * kConsumerWarps);
    // Lane group `grp` of G lanes holds one key row; lane `gl` of it the
    // VEC columns [gl VEC, gl VEC + VEC).
    const int G = hd / VEC, KPW = 32 / G;
    const int grp = lane / G, gl = lane % G;
    float m[RT], l[RT], acc[RT][VEC];
    int qp[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      m[r] = kNegInf;
      l[r] = 0.f;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[r][e] = 0.f;
      qp[r] = r < R ? q_pos[(size_t)b * C + r / n_rep] : 0;
    }
    const int KB = kblock * ps;
    const int row_bytes = hd * (int)sizeof(T);
    // Rows of a K-block split into (entry, offset) by a shift where the
    // page size is a power of two (no integer division in the loop).
    const int ps_shift = (ps & (ps - 1)) ? -1 : __ffs(ps) - 1;
    int s = 0, phase = 0;  // ring stage and its use's parity
    for (int k0 = 0; k0 < n_e; k0 += kblock) {
      bool any = false;
      for (int j = 0; j < kblock && k0 + j < n_e; ++j) any |= bts[k0 + j] >= 0;
      if (!any) continue;
      const uint8_t* kst = ring + (size_t)s * stage_bytes + gl * 16;
      const uint8_t* vst = kst + (size_t)kblock * pb;
      mbar_wait(full + s, phase);
      // Warp-uniform trip count: the warp takes KPW keys at a time.
      for (int row0 = warp * KPW; row0 < KB; row0 += KPW * kConsumerWarps) {
        const int row = row0 + grp;
        const int j = ps_shift >= 0 ? row >> ps_shift : row / ps;
        const int o = row - j * ps;
        const bool live = row < KB && k0 + j < n_e && bts[k0 + j] >= 0;
        const int kp = live ? kpos[k0 * ps + row] : -1;
        float kf[VEC], vf[VEC];
        uint4 ku = make_uint4(0u, 0u, 0u, 0u), vu = ku;
        if (live) {
          const int off = j * pb + o * row_bytes;
          ku = *reinterpret_cast<const uint4*>(kst + off);
          vu = *reinterpret_cast<const uint4*>(vst + off);
        }
        unpack(ku, kf);
        unpack(vu, vf);
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          if (r >= R) break;  // R is uniform over the block
          const float4* qr =
              reinterpret_cast<const float4*>(qs + r * hd + gl * VEC);
          float dot = 0.f;
#pragma unroll
          for (int v = 0; v < VEC / 4; ++v) {
            const float4 x = qr[v];
            dot += x.x * kf[4 * v] + x.y * kf[4 * v + 1] +
                   x.z * kf[4 * v + 2] + x.w * kf[4 * v + 3];
          }
          for (int off = G / 2; off > 0; off >>= 1)
            dot += __shfl_xor_sync(~0u, dot, off);
          const int diff = qp[r] - kp;
          const bool keep = kp >= 0 && (!causal || diff >= 0) &&
                            (window < 0 || diff < window);
          const float sc = keep ? dot : kNegInf;
          if (live) {
            // One of alpha = exp2(m - m_new) and p = exp2(sc - m_new) is
            // exp2(0) = 1; the other is exp2(-|sc - m|).
            const bool up = sc > m[r];
            const float e = exp2f(-fabsf(sc - m[r]));
            const float alpha = up ? e : 1.f, p = up ? 1.f : e;
            l[r] = l[r] * alpha + p;
#pragma unroll
            for (int e2 = 0; e2 < VEC; ++e2)
              acc[r][e2] = fmaf(acc[r][e2], alpha, p * vf[e2]);
            m[r] = up ? sc : m[r];
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + s);
      if (++s == stages) s = 0, phase ^= 1;
    }
    // The warp's KPW streams merge into lane group 0.
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      if (r >= R) break;
      for (int off = G; off < 32; off <<= 1) {
        const float mo = __shfl_xor_sync(~0u, m[r], off);
        const float lo = __shfl_xor_sync(~0u, l[r], off);
        const float mx = fmaxf(m[r], mo);
        const float ws = exp2f(m[r] - mx), wo = exp2f(mo - mx);
        l[r] = l[r] * ws + lo * wo;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float ao = __shfl_xor_sync(~0u, acc[r][e], off);
          acc[r][e] = acc[r][e] * ws + ao * wo;
        }
        m[r] = mx;
      }
      if (grp == 0) {
        float* dst = part_acc + ((size_t)warp * R + r) * hd + gl * VEC;
#pragma unroll
        for (int e = 0; e < VEC; ++e) dst[e] = acc[r][e];
        if (gl == 0) {
          part_m[warp * R + r] = m[r];
          part_l[warp * R + r] = l[r];
        }
      }
    }
    named_bar_sync(1, 32 * kConsumerWarps);
    // The four warps merge into the block's partial.
    for (int i = threadIdx.x; i < R * hd; i += 32 * kConsumerWarps) {
      const int r = i / hd;
      float mx = kNegInf;
#pragma unroll
      for (int w = 0; w < kConsumerWarps; ++w)
        mx = fmaxf(mx, part_m[w * R + r]);
      float a = 0.f, sum = 0.f;
#pragma unroll
      for (int w = 0; w < kConsumerWarps; ++w) {
        const float wt = exp2f(part_m[w * R + r] - mx);
        a += wt * part_acc[(size_t)w * R * hd + i];
        sum += wt * part_l[w * R + r];
      }
      blk_acc[i] = a;
      if (i % hd == 0) {
        blk_m[r] = mx;
        blk_l[r] = sum;
      }
    }
  }

  cluster.sync();  // every block's partial is in its shared memory
  // The cluster's blocks merge the S partials, each taking a share of the
  // R x hd outputs and reading the S partials through distributed shared
  // memory (the loads of one output are independent, so they overlap).
  for (int i = split * kThreads + threadIdx.x; i < R * hd;
       i += S * kThreads) {
    const int r = i / hd;
    float ms[kMaxSplits], ls[kMaxSplits], as[kMaxSplits];
    float mx = kNegInf;
#pragma unroll
    for (int src = 0; src < kMaxSplits; ++src) {
      if (src < S) {
        ms[src] = *cluster.map_shared_rank(blk_m + r, src);
        ls[src] = *cluster.map_shared_rank(blk_l + r, src);
        as[src] = *cluster.map_shared_rank(blk_acc + i, src);
        mx = fmaxf(mx, ms[src]);
      }
    }
    float o = 0.f, sum = 0.f;
#pragma unroll
    for (int src = 0; src < kMaxSplits; ++src) {
      if (src < S) {
        const float wt = exp2f(ms[src] - mx);
        o += wt * as[src];
        sum += wt * ls[src];
      }
    }
    const int c = r / n_rep, head = kvh * n_rep + r % n_rep;
    out[(((size_t)b * C + c) * H + head) * hd + i % hd] =
        from_f<T>(o / fmaxf(sum, 1e-30f));
  }
  cluster.sync();  // no block leaves while another may still read it
}

// 4-D tensor map over a (P, ps, KVH, hd) page pool, no swizzle: one box is
// one page of one KV head, ps rows of hd, landing densely.
int pool_map(CUtensorMap* map, CUtensorMapDataType type, int size,
             const void* base, long long P, int ps, int KVH, int hd) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)KVH,
                              (cuuint64_t)ps, (cuuint64_t)P};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * size,
                                 (cuuint64_t)KVH * hd * size,
                                 (cuuint64_t)ps * KVH * hd * size};
  const cuuint32_t box[4] = {(cuuint32_t)hd, 1, (cuuint32_t)ps, 1};
  return hopper::make_tensor_map(map, type, 4, base, dims, strides, box,
                                 CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <typename T, int RT>
int launch_rows(const CUtensorMap& mk, const CUtensorMap& mv, const void* q,
                const void* pos_pages, const void* block_table,
                const void* q_pos, void* out, int B, int C, int H, int KVH,
                int hd, int ps, int max_pages, int kblock, float scale,
                int causal, int window, int splits, int entries, int stages,
                size_t smem, cudaStream_t stream) {
  auto kernel = paged_split_kernel<T, RT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, KVH, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, mk, mv, static_cast<const T*>(q),
      static_cast<const int*>(pos_pages),
      static_cast<const int*>(block_table), static_cast<const int*>(q_pos),
      static_cast<T*>(out), C, H, KVH, hd, ps, max_pages, kblock, entries,
      stages, scale * kLog2e, causal, window);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* pos_pages, const void* block_table, const void* q_pos,
           void* out, int B, int C, int H, int KVH, int hd, int ps,
           int max_pages, int kblock, float scale, int causal, int window,
           int splits, int entries, int stages, long long P,
           cudaStream_t stream) {
  const int size = sizeof(T), R = KVH > 0 ? C * (H / KVH) : 0;
  const int G = hd * size / 16;  // lanes per key row: a power of two
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  const size_t smem = smem_bytes(R, hd, ps, kblock, size, stages, entries);
  if (KVH < 1 || H % KVH || R < 1 || R > kMaxRows || hd * size % 16 ||
      G < 1 || G > 32 || (G & (G - 1)) || ps < 1 || ps > 256 || kblock < 1 ||
      stages < 3 || splits < 1 || splits > kMaxSplits || entries < 1 ||
      entries % kblock || (long long)splits * entries < max_pages ||
      (long long)(splits - 1) * entries >= max_pages ||
      smem > (size_t)limit ||
      (reinterpret_cast<uintptr_t>(k_pages) |
       reinterpret_cast<uintptr_t>(v_pages)) % 16)
    return (int)cudaErrorInvalidValue;
  const CUtensorMapDataType type = size == 2
                                       ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap mk, mv;
  int e = pool_map(&mk, type, size, k_pages, P, ps, KVH, hd);
  if (!e) e = pool_map(&mv, type, size, v_pages, P, ps, KVH, hd);
  if (e) return e;
#define PAGED_LAUNCH(RT)                                                     \
  launch_rows<T, RT>(mk, mv, q, pos_pages, block_table, q_pos, out, B, C, H, \
                     KVH, hd, ps, max_pages, kblock, scale, causal, window,  \
                     splits, entries, stages, smem, stream)
  if (R == 1) return PAGED_LAUNCH(1);
  if (R <= 4) return PAGED_LAUNCH(4);
  return PAGED_LAUNCH(16);
#undef PAGED_LAUNCH
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; window < 0 means no window; P pool
// pages; the plan's splits (blocks per cluster), entries per split (a
// multiple of kblock) and ring stages.  Returns the cudaError_t of the
// launch; a plan this kernel cannot run is refused
// (cudaErrorInvalidValue).
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* pos_pages, const void* block_table, const void* q_pos,
    void* out, int dtype, int B, int C, int H, int KVH, int hd, int ps,
    int max_pages, int kblock, float scale, int causal, int window,
    int splits, int entries, int stages, long long P, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_pages, v_pages, pos_pages, block_table, q_pos,
                         out, B, C, H, KVH, hd, ps, max_pages, kblock, scale,
                         causal, window, splits, entries, stages, P, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, pos_pages, block_table,
                                 q_pos, out, B, C, H, KVH, hd, ps, max_pages,
                                 kblock, scale, causal, window, splits,
                                 entries, stages, P, s);
  return (int)cudaErrorInvalidValue;
}
