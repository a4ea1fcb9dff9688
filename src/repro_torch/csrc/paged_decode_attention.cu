// Paged decode attention: a C-row query block per slot attends over that
// slot's K/V pages, found through its block table.
//   q (B, C, H, hd), k/v pages (P, ps, KVH, hd), pos pages (P, ps) int32,
//   block table (B, max_pages) int32, q_pos (B, C) int32 -> out (B, C, H, hd)
//
// Replaces the Pallas TPU kernel `paged_decode_attention` (`_paged_kernel`)
// in src/repro/kernels/paged_attention/kernel.py.
//
// Semantics kept from it: query head kvh * n_rep + r reads KV head kvh; a
// key counts only if its position is >= 0 (unwritten entries hold -1; an
// unmapped block-table entry, -1, contributes no key), if q_pos - k_pos >=
// 0 when causal, and if q_pos - k_pos < window when windowed; masked
// scores are NEG_INF = -1e30 (not -inf), so a masked key contributes an
// exact 0 once any valid key has been seen; the softmax runs online in
// float32 and the output is acc / max(l, 1e-30).  Rows with no valid key
// are garbage here as in every implementation, and callers mask them out.
// It takes every shape the TPU kernel takes: any C * n_rep query rows, any
// kblock_pages, page size and head_dim (<= 256), float32 and bfloat16.
//
// Bound on the H100: memory, and at decode sizes latency.  Each (slot, KV
// head) reads its mapped pages' K and V once (2 * hd elements per
// position) and does ~4 * n_rep * C flops per element read, far below the
// ~295 flops per byte balance point.  The least time is the mapped pages'
// K/V/pos bytes plus q and out, over 3.35 TB/s: 0.99 us at the
// tmux-12l-768h slice (B 8, 12 KV heads of 64, ~8.4 pages of 16 per slot).
//
// Design (split-K, "flash-decoding", over an asynchronous page ring):
//
//   * The block-table axis is split across S <= 8 blocks per (slot, KV
//     head, row group), launched as one thread-block cluster along x: grid
//     (S, KVH, B * groups).  Split s takes the contiguous entries [s E,
//     s E + E), E a multiple of kblock_pages (the only thing kblock_pages
//     sets: the split boundaries); the Python plan (repro_torch/kernels/
//     paged_attention/kernel.py: `plan`) picks S from max_pages and the SM
//     count (480 blocks at the slice: S = 5 of 2 entries).
//   * Row groups.  The R = C * n_rep query rows of a (slot, KV head) are
//     cut into `groups` groups of at most 16 rows (8 where a lane holds
//     two 16-byte vectors), one per block along z, so registers and
//     shared memory depend on the group, not on R.  Each group's blocks
//     read the (slot, KV head)'s pages again: with G groups the pages
//     cross from L2 to the SMs G times (they are read from device memory
//     about once, the groups' blocks running together).  C * n_rep <= 16,
//     every serving slice's decode step, is one group.
//   * A ring stage holds one TMA box of one page of one KV head: box_rows
//     <= min(ps, 256) rows (a page larger than a box, or than the shared
//     memory a stage may take, streams as several boxes), the K and V
//     boxes and the box's key positions, so shared memory does not depend
//     on kblock_pages.  A producer warp keeps the ring full with full /
//     empty mbarriers: lane 0 issues one TMA load per tensor through 4-D
//     maps over (hd, KVH, ps, P), box (hd, 1, box_rows, 1), and the 32
//     lanes copy the positions with 4-byte cp.async, each lane's copies
//     counted on the full barrier by cp.async.mbarrier.arrive.  Unmapped
//     entries issue nothing.  Where a key row is not a multiple of 16
//     bytes (TMA's stride rule) or a pool is not 16-byte aligned, the
//     `copy` body stages the box with plain loads into rows padded with
//     zeros to 16 bytes.
//   * Four consumer warps.  A key row is `vecs` 16-byte vectors; a lane
//     group of G lanes (a power of two, <= 32) holds it, lane gl taking
//     vectors gl, gl + G (VPL = 2 vectors per lane where vecs > 32, f32
//     hd > 128); lanes past vecs hold zeros.  32 / G keys are in flight
//     per warp, each lane group its own online-softmax stream (running max
//     m, sum l, f32 accumulator over its lanes' columns) for the group's
//     rows, in registers, so the math needs no block barrier.  A score is
//     the group's dot product (q pre-scaled by scale * log2 e, exp2 below)
//     reduced with log2 G shuffles; one exp2 per key and row updates the
//     stream (one of the rescale and the weight is exp2(0)).
//   * Merge: the lane groups of a warp merge by shuffles, the four warps
//     through shared memory into the block's (m, l, acc); after a cluster
//     barrier the S blocks share the group's outputs, each reading the S
//     partials of its outputs through distributed shared memory, weighting
//     each by exp2(m - M) and writing acc / max(l, 1e-30).  One launch, no
//     device scratch.  A partial that saw no key keeps m = -1e30, l = 0,
//     acc = 0; beside any partial with a valid key its weight is
//     exp2(-1e30 - M) = 0 exactly, and -1e30 - (-1e30) = 0 gives weight 1,
//     never NaN.
//
// Math on CUDA cores: at C * n_rep = 1 query row per block there is
// nothing for a tensor core to do.
//
// Where the time goes (clock64 traces of one block, H100): a stage's
// handoff and math are latency -- shared-memory reads, the shuffle chain,
// the barrier handoff -- not bytes, so the split count, not the ring depth,
// sets the time.  Tried and dropped, each slower or no faster at the slice
// or at 64 pages per slot: a ring of 8 or 16 stages; cp.async 16-byte
// copies by the producer warp instead of TMA; each warp taking whole
// K-blocks in turn with one rescale per 4 keys (fewer warps busy at the
// slice); loading a warp's next row before its math (the wait for the next
// stage's pages then delays this one's math).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "hopper.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kConsumerWarps = 4;
constexpr int kThreads = 32 * (kConsumerWarps + 1);  // + the producer warp
constexpr int kMaxSplits = 8;                          // portable cluster

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

__host__ __device__ __forceinline__ int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Shared memory of a block, in this order after 1024 bytes of alignment
// slack: the ring (stages x [K box, V box, positions], each part rounded
// up to 128 bytes, a TMA destination's alignment; box rows of vecs * 16
// bytes), q (gr x hdp f32, hdp = vecs * 16 / size), the consumer warps'
// partial accumulators (4 x gr x hdp f32), maxima and sums (4 x gr each),
// the block's merged partial (gr x hdp, gr, gr), the split's block-table
// entries (n_bt int32), then (8-byte aligned) the full and empty barriers.
struct Layout {
  int box_bytes, pos_bytes, stage_bytes, hdp;
  __host__ __device__ Layout(int box_rows, int vecs, int size) {
    box_bytes = round_up(box_rows * vecs * 16, 128);
    pos_bytes = round_up(box_rows * 4, 128);
    stage_bytes = 2 * box_bytes + pos_bytes;
    hdp = vecs * 16 / size;
  }
};

inline size_t smem_bytes(const Layout& lay, int stages, int gr, int n_bt) {
  return 1024 + (size_t)stages * lay.stage_bytes +
         4 * ((size_t)gr * lay.hdp +
              (size_t)kConsumerWarps * gr * (lay.hdp + 2) +
              (size_t)gr * (lay.hdp + 2) + (size_t)n_bt) +
         8 + 16 * (size_t)stages;
}

// RT: query rows held in registers (>= the group's rows); VPL: 16-byte
// vectors per lane of a key row; TMA: 1 stages boxes with TMA, 0 with
// plain copies into 16-byte-padded rows.
template <typename T, int RT, int VPL, int TMA>
__global__ void __launch_bounds__(kThreads) paged_split_kernel(
    const __grid_constant__ CUtensorMap mk,
    const __grid_constant__ CUtensorMap mv, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const T* __restrict__ q,
    const int* __restrict__ pos_pages, const int* __restrict__ block_table,
    const int* __restrict__ q_pos, T* __restrict__ out, int C, int H,
    int KVH, int hd, int ps, int max_pages, int entries, int stages,
    int groups, int gr, int box_rows, int G, float scale_log2, int causal,
    int window) {
  using namespace hopper;
  using Raw = std::conditional_t<sizeof(T) == 2, uint16_t, uint32_t>;
  constexpr int VEC = 16 / sizeof(T);
  cg::cluster_group cluster = cg::this_cluster();
  const int split = blockIdx.x, S = gridDim.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z / groups, group = blockIdx.z % groups;
  const int n_rep = H / KVH, R = C * n_rep;
  const int r0 = group * gr, Rb = min(gr, R - r0);  // this block's rows
  const int vecs = (hd * (int)sizeof(T) + 15) / 16;
  const Layout lay(box_rows, vecs, sizeof(T));
  const int hdp = lay.hdp, row_bytes = vecs * 16;
  const int n_boxes = (ps + box_rows - 1) / box_rows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  const int e0 = split * entries;
  const int n_e = min(entries, max_pages - e0);  // >= 1 (the plan's rule)

  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align1024(smem_raw);
  float* qs = reinterpret_cast<float*>(ring + (size_t)stages *
                                                  lay.stage_bytes);
  float* part_acc = qs + gr * hdp;
  float* part_m = part_acc + kConsumerWarps * gr * hdp;
  float* part_l = part_m + kConsumerWarps * gr;
  float* blk_acc = part_l + kConsumerWarps * gr;
  float* blk_m = blk_acc + gr * hdp;
  float* blk_l = blk_m + gr;
  int* bts = reinterpret_cast<int*>(blk_l + gr);  // this split's entries
  uint64_t* full = reinterpret_cast<uint64_t*>(
      (reinterpret_cast<uintptr_t>(bts + n_e) + 7) & ~uintptr_t(7));
  uint64_t* empty = full + stages;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      // TMA: lane 0's expect_tx arrival and one cp.async arrival per lane;
      // copy: one arrival per lane.
      mbar_init(full + s, TMA ? 33 : 32);
      mbar_init(empty + s, kConsumerWarps);
    }
    fence_barrier_init();
  }
  // One round trip for everything the block reads besides the pages: the
  // group's q rows (pre-scaled into log2 space, zero past hd) and the
  // split's table entries.
  for (int i = threadIdx.x; i < Rb * hdp; i += kThreads) {
    const int r = r0 + i / hdp, col = i % hdp;
    const int c = r / n_rep, head = kvh * n_rep + r % n_rep;
    qs[i] = col < hd
                ? to_f(q[(((size_t)b * C + c) * H + head) * hd + col]) *
                      scale_log2
                : 0.f;
  }
  for (int i = threadIdx.x; i < n_e; i += kThreads)
    bts[i] = block_table[(size_t)b * max_pages + e0 + i];
  __syncthreads();

  if (warp == kConsumerWarps) {  // producer: all 32 lanes
    int s = 0, phase = 0;        // ring stage and its use's parity
    for (int e = 0; e < n_e; ++e) {
      const int page = bts[e];
      if (page < 0) continue;  // the consumers skip it too
      for (int bx = 0; bx < n_boxes; ++bx) {
        const int o0 = bx * box_rows, rows = min(box_rows, ps - o0);
        mbar_wait(empty + s, phase ^ 1);
        uint8_t* kst = ring + (size_t)s * lay.stage_bytes;
        uint8_t* vst = kst + lay.box_bytes;
        int* kp = reinterpret_cast<int*>(vst + lay.box_bytes);
        const int* pg = pos_pages + (size_t)page * ps + o0;
        if constexpr (TMA) {
          if (lane == 0) {
            // A box is box_rows rows whatever lies past the page's end
            // (TMA fills those rows with zeros): they count in full.
            mbar_arrive_expect_tx(full + s,
                                  2u * box_rows * hd * (uint32_t)sizeof(T));
            tma_load_4d(kst, &mk, full + s, 0, kvh, o0, page);
            tma_load_4d(vst, &mv, full + s, 0, kvh, o0, page);
          }
          for (int i = lane; i < rows; i += 32) cp_async_4(kp + i, pg + i);
          cp_async_mbar_arrive(full + s);
        } else {
          const size_t rs = (size_t)KVH * hd;  // elements row to row
          const Raw* kg = reinterpret_cast<const Raw*>(k_pages) +
                          ((size_t)page * ps + o0) * rs + (size_t)kvh * hd;
          const Raw* vg = reinterpret_cast<const Raw*>(v_pages) +
                          ((size_t)page * ps + o0) * rs + (size_t)kvh * hd;
          Raw* kd = reinterpret_cast<Raw*>(kst);
          Raw* vd = reinterpret_cast<Raw*>(vst);
          for (int i = lane; i < rows * hdp; i += 32) {
            const int r = i / hdp, col = i % hdp;
            const bool in = col < hd;
            kd[i] = in ? kg[r * rs + col] : Raw(0);
            vd[i] = in ? vg[r * rs + col] : Raw(0);
          }
          for (int i = lane; i < rows; i += 32) kp[i] = pg[i];
          mbar_arrive(full + s);
        }
        if (++s == stages) s = 0, phase ^= 1;
      }
    }
  } else {
    // Lane group `grp` of G lanes holds one key row; lane `gl` of it the
    // vectors gl + G j, j < VPL (those < vecs).
    const int KPW = 32 / G;
    const int grp = lane / G, gl = lane % G;
    float m[RT], l[RT], acc[RT][VPL * VEC];
    int qp[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      m[r] = kNegInf;
      l[r] = 0.f;
#pragma unroll
      for (int e = 0; e < VPL * VEC; ++e) acc[r][e] = 0.f;
      qp[r] = r < Rb ? q_pos[(size_t)b * C + (r0 + r) / n_rep] : 0;
    }
    int s = 0, phase = 0;  // ring stage and its use's parity
    for (int e = 0; e < n_e; ++e) {
      if (bts[e] < 0) continue;
      for (int bx = 0; bx < n_boxes; ++bx) {
        const int rows = min(box_rows, ps - bx * box_rows);
        const uint8_t* kst = ring + (size_t)s * lay.stage_bytes;
        const uint8_t* vst = kst + lay.box_bytes;
        const int* kp = reinterpret_cast<const int*>(vst + lay.box_bytes);
        mbar_wait(full + s, phase);
        // Warp-uniform trip count: the warp takes KPW keys at a time.
        for (int row0 = warp * KPW; row0 < rows;
             row0 += KPW * kConsumerWarps) {
          const int row = row0 + grp;
          const bool live = row < rows;
          const int kpos = live ? kp[row] : -1;
          float kf[VPL][VEC], vf[VPL][VEC];
#pragma unroll
          for (int j = 0; j < VPL; ++j) {
            const int vi = gl + G * j;
            uint4 ku = make_uint4(0u, 0u, 0u, 0u), vu = ku;
            if (live && vi < vecs) {
              const int off = row * row_bytes + vi * 16;
              ku = *reinterpret_cast<const uint4*>(kst + off);
              vu = *reinterpret_cast<const uint4*>(vst + off);
            }
            unpack(ku, kf[j]);
            unpack(vu, vf[j]);
          }
#pragma unroll
          for (int r = 0; r < RT; ++r) {
            if (r >= Rb) break;  // Rb is uniform over the block
            float dot = 0.f;
#pragma unroll
            for (int j = 0; j < VPL; ++j) {
              const int vi = gl + G * j;
              if (vi < vecs) {
                const float4* qr = reinterpret_cast<const float4*>(
                    qs + r * hdp + vi * VEC);
#pragma unroll
                for (int v4 = 0; v4 < VEC / 4; ++v4) {
                  const float4 x = qr[v4];
                  dot += x.x * kf[j][4 * v4] + x.y * kf[j][4 * v4 + 1] +
                         x.z * kf[j][4 * v4 + 2] + x.w * kf[j][4 * v4 + 3];
                }
              }
            }
            for (int off = G / 2; off > 0; off >>= 1)
              dot += __shfl_xor_sync(~0u, dot, off);
            const int diff = qp[r] - kpos;
            const bool keep = kpos >= 0 && (!causal || diff >= 0) &&
                              (window < 0 || diff < window);
            const float sc = keep ? dot : kNegInf;
            if (live) {
              // One of alpha = exp2(m - m_new) and p = exp2(sc - m_new) is
              // exp2(0) = 1; the other is exp2(-|sc - m|).
              const bool up = sc > m[r];
              const float ex = exp2f(-fabsf(sc - m[r]));
              const float alpha = up ? ex : 1.f, p = up ? 1.f : ex;
              l[r] = l[r] * alpha + p;
#pragma unroll
              for (int j = 0; j < VPL; ++j)
#pragma unroll
                for (int e2 = 0; e2 < VEC; ++e2)
                  acc[r][j * VEC + e2] =
                      fmaf(acc[r][j * VEC + e2], alpha, p * vf[j][e2]);
              m[r] = up ? sc : m[r];
            }
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + s);
        if (++s == stages) s = 0, phase ^= 1;
      }
    }
    // The warp's KPW streams merge into lane group 0.
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      if (r >= Rb) break;
      for (int off = G; off < 32; off <<= 1) {
        const float mo = __shfl_xor_sync(~0u, m[r], off);
        const float lo = __shfl_xor_sync(~0u, l[r], off);
        const float mx = fmaxf(m[r], mo);
        const float ws = exp2f(m[r] - mx), wo = exp2f(mo - mx);
        l[r] = l[r] * ws + lo * wo;
#pragma unroll
        for (int e = 0; e < VPL * VEC; ++e) {
          const float ao = __shfl_xor_sync(~0u, acc[r][e], off);
          acc[r][e] = acc[r][e] * ws + ao * wo;
        }
        m[r] = mx;
      }
      if (grp == 0) {
        float* dst = part_acc + ((size_t)warp * gr + r) * hdp;
#pragma unroll
        for (int j = 0; j < VPL; ++j) {
          const int vi = gl + G * j;
          if (vi < vecs) {
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              dst[vi * VEC + e] = acc[r][j * VEC + e];
          }
        }
        if (gl == 0) {
          part_m[warp * gr + r] = m[r];
          part_l[warp * gr + r] = l[r];
        }
      }
    }
    named_bar_sync(1, 32 * kConsumerWarps);
    // The four warps merge into the block's partial.
    for (int i = threadIdx.x; i < Rb * hdp; i += 32 * kConsumerWarps) {
      const int r = i / hdp;
      float mx = kNegInf;
#pragma unroll
      for (int w = 0; w < kConsumerWarps; ++w)
        mx = fmaxf(mx, part_m[w * gr + r]);
      float a = 0.f, sum = 0.f;
#pragma unroll
      for (int w = 0; w < kConsumerWarps; ++w) {
        const float wt = exp2f(part_m[w * gr + r] - mx);
        a += wt * part_acc[(size_t)w * gr * hdp + i];
        sum += wt * part_l[w * gr + r];
      }
      blk_acc[i] = a;
      if (i % hdp == 0) {
        blk_m[r] = mx;
        blk_l[r] = sum;
      }
    }
  }

  cluster.sync();  // every block's partial is in its shared memory
  // The cluster's blocks merge the S partials, each taking a share of the
  // group's Rb x hd outputs and reading the S partials through distributed
  // shared memory (the loads of one output are independent, so they
  // overlap).
  for (int i = split * kThreads + threadIdx.x; i < Rb * hd;
       i += S * kThreads) {
    const int r = i / hd, col = i % hd, ia = r * hdp + col;
    float ms[kMaxSplits], ls[kMaxSplits], as[kMaxSplits];
    float mx = kNegInf;
#pragma unroll
    for (int src = 0; src < kMaxSplits; ++src) {
      if (src < S) {
        ms[src] = *cluster.map_shared_rank(blk_m + r, src);
        ls[src] = *cluster.map_shared_rank(blk_l + r, src);
        as[src] = *cluster.map_shared_rank(blk_acc + ia, src);
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
    const int c = (r0 + r) / n_rep, head = kvh * n_rep + (r0 + r) % n_rep;
    out[(((size_t)b * C + c) * H + head) * hd + col] =
        from_f<T>(o / fmaxf(sum, 1e-30f));
  }
  cluster.sync();  // no block leaves while another may still read it
}

// 4-D tensor map over a (P, ps, KVH, hd) page pool, no swizzle: one box is
// box_rows rows of one page of one KV head, landing densely.
int pool_map(CUtensorMap* map, CUtensorMapDataType type, int size,
             const void* base, long long P, int ps, int KVH, int hd,
             int box_rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)KVH,
                              (cuuint64_t)ps, (cuuint64_t)P};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * size,
                                 (cuuint64_t)KVH * hd * size,
                                 (cuuint64_t)ps * KVH * hd * size};
  const cuuint32_t box[4] = {(cuuint32_t)hd, 1, (cuuint32_t)box_rows, 1};
  return hopper::make_tensor_map(map, type, 4, base, dims, strides, box,
                                 CU_TENSOR_MAP_SWIZZLE_NONE);
}

struct Args {
  const void *q, *k_pages, *v_pages, *pos_pages, *block_table, *q_pos;
  void* out;
  int B, C, H, KVH, hd, ps, max_pages;
  float scale;
  int causal, window, splits, entries, stages, groups, gr, box_rows, G;
  size_t smem;
};

template <typename T, int RT, int VPL, int TMA>
int launch_body(const CUtensorMap& mk, const CUtensorMap& mv, const Args& a,
                cudaStream_t stream) {
  auto kernel = paged_split_kernel<T, RT, VPL, TMA>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)a.smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.splits, a.KVH, a.B * a.groups);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = a.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, mk, mv, static_cast<const T*>(a.k_pages),
      static_cast<const T*>(a.v_pages), static_cast<const T*>(a.q),
      static_cast<const int*>(a.pos_pages),
      static_cast<const int*>(a.block_table),
      static_cast<const int*>(a.q_pos), static_cast<T*>(a.out), a.C, a.H,
      a.KVH, a.hd, a.ps, a.max_pages, a.entries, a.stages, a.groups, a.gr,
      a.box_rows, a.G, a.scale * kLog2e, a.causal, a.window);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const Args& a, int vpl, int rt, int tma, long long P,
           cudaStream_t stream) {
  const int size = sizeof(T);
  const int vecs = (a.hd * size + 15) / 16;
  const int R = a.KVH > 0 ? a.C * (a.H / a.KVH) : 0;
  const int n_bt = a.entries < a.max_pages ? a.entries : a.max_pages;
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  const bool aligned = (reinterpret_cast<uintptr_t>(a.k_pages) |
                        reinterpret_cast<uintptr_t>(a.v_pages)) %
                           16 ==
                       0;
  // The plan's rules, checked again: the rows of every group, a lane group
  // (power of two) wide enough for the key row, every entry in exactly one
  // non-empty split, boxes of at most 256 rows, TMA only on 16-byte rows
  // and pools, shared memory within the card's.
  if (a.KVH < 1 || a.H % a.KVH || R < 1 || a.hd < 1 || a.hd > 256 ||
      a.ps < 1 || a.groups < 1 || a.gr < 1 || a.gr > rt ||
      (long long)a.groups * a.gr < R || (long long)(a.groups - 1) * a.gr >= R ||
      a.G < 1 || a.G > 32 || (a.G & (a.G - 1)) || a.G * vpl < vecs ||
      a.box_rows < 1 || a.box_rows > 256 ||
      a.box_rows > a.ps || a.stages < 2 || a.splits < 1 ||
      a.splits > kMaxSplits || a.entries < 1 ||
      (long long)a.splits * a.entries < a.max_pages ||
      (long long)(a.splits - 1) * a.entries >= a.max_pages ||
      (long long)a.B * a.groups > 65535 || a.smem > (size_t)limit ||
      a.smem != smem_bytes(Layout(a.box_rows, vecs, size), a.stages, a.gr,
                           n_bt) ||
      (tma && (a.hd * size % 16 || !aligned)))
    return (int)cudaErrorInvalidValue;
  CUtensorMap mk = {}, mv = {};
  if (tma) {
    const CUtensorMapDataType type = size == 2
                                         ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                         : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    int e = pool_map(&mk, type, size, a.k_pages, P, a.ps, a.KVH, a.hd,
                     a.box_rows);
    if (!e)
      e = pool_map(&mv, type, size, a.v_pages, P, a.ps, a.KVH, a.hd,
                   a.box_rows);
    if (e) return e;
  }
  // Instantiations: the TMA body at 1, 4 and 16 rows (8 with two vectors
  // per lane), the copy body at the widest only.
  if (vpl == 1 && tma) {
    if (rt == 1) return launch_body<T, 1, 1, 1>(mk, mv, a, stream);
    if (rt == 4) return launch_body<T, 4, 1, 1>(mk, mv, a, stream);
    if (rt == 16) return launch_body<T, 16, 1, 1>(mk, mv, a, stream);
  }
  if (vpl == 1 && !tma && rt == 16)
    return launch_body<T, 16, 1, 0>(mk, mv, a, stream);
  if constexpr (sizeof(T) == 4) {  // two vectors per lane: f32 hd > 128
    if (vpl == 2 && tma) {
      if (rt == 1) return launch_body<T, 1, 2, 1>(mk, mv, a, stream);
      if (rt == 4) return launch_body<T, 4, 2, 1>(mk, mv, a, stream);
      if (rt == 8) return launch_body<T, 8, 2, 1>(mk, mv, a, stream);
    }
    if (vpl == 2 && !tma && rt == 8)
      return launch_body<T, 8, 2, 0>(mk, mv, a, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; window < 0 means no window; P pool
// pages.  The rest is the Python plan's: splits (blocks per cluster),
// entries per split (a multiple of kblock_pages), ring stages, row groups
// and rows per group, box rows, lanes per key row, vectors per lane, rows
// held in registers, and the body (1 TMA, 0 plain copies).  Returns the
// cudaError_t of the launch; a plan this kernel cannot run is refused
// (cudaErrorInvalidValue).
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* pos_pages, const void* block_table, const void* q_pos,
    void* out, int dtype, int B, int C, int H, int KVH, int hd, int ps,
    int max_pages, float scale, int causal, int window, int splits,
    int entries, int stages, int groups, int gr, int box_rows, int lanes,
    int vpl, int rt, int tma, long long smem, long long P, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (smem < 0) return (int)cudaErrorInvalidValue;
  const Args a{q,     k_pages, v_pages, pos_pages, block_table, q_pos,
               out,   B,       C,       H,         KVH,         hd,
               ps,    max_pages, scale, causal,    window,      splits,
               entries, stages, groups, gr,        box_rows,    lanes,
               (size_t)smem};
  if (dtype == 0) return launch<float>(a, vpl, rt, tma, P, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, vpl, rt, tma, P, s);
  return (int)cudaErrorInvalidValue;
}
