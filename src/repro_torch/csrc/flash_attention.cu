// Flash attention over a full sequence (the cache-free forward of a causal
// decoder):
//   q (B, Lq, H, hd), k/v (B, Lk, H, hd), KV already repeated for GQA
//   -> out (B, Lq, H, hd) in q's dtype.
//
// Replaces the Pallas TPU kernel `flash_attention` (`_flash_kernel`) in
// src/repro/kernels/attention/kernel.py.
//
// Semantics kept from it: s = (q . k) * scale accumulated in float32; a
// key counts if its index is < Lk and, when causal, if it is <= the
// query's index (both absolute, aligned top-left, so Lq != Lk is allowed);
// masked scores are NEG_INF = -1e30, not -inf; the running max and sum are
// float32; the output is acc / max(l, 1e-30).  Query rows past Lq are
// never written.  Like the TPU kernel, it takes any head_dim (here 1 to
// 256): both bodies pad the head axis with zeros to HDP, the next multiple
// of 64, which adds 0 to every score and writes no column past hd.  One
// departure, in the bf16 Hopper body only: the probabilities P are rounded
// to bf16 for the P.V product on the tensor cores (the TPU kernel
// keeps them in float32; the running sum l is taken over the float32 P).
// That adds at most 2^-9 of relative error per term, well inside the
// bf16 tolerance of 1e-2 x max(1, max|out|) the kernel is held to.
//
// Bound on the H100: at the qwen1.5-4b evaluation shape (B 2, L 1032, H 20,
// hd 128, causal, bf16) the 4 * hd flops per valid (query, key) pair are
// 10.9 GFLOP per call (0.011 ms at the bf16 tensor-core rate) against 42 MB
// of q, k, v and out (0.013 ms at 3.35 TB/s): the two bounds are close, and
// at longer sequences the flops bound alone.  So the bf16 body is built for
// the tensor cores' full rate, which only `wgmma` reaches.
//
// Shared design: one block per (head, batch row, query tile), reading q, k
// and v through their strides straight from (B, L, H, hd), so none of the
// TPU wrapper's fold / transpose / pad copies exist.  The block walks the
// key axis in tiles from tile 0 upwards -- the loop inside the block takes
// the place of the TPU's sequential K grid axis -- with the running max
// and sum of each query row in registers.  Under `causal` the loop stops
// at the tile holding the block's last diagonal key; the TPU kernel streams
// the masked tiles as zeros, so the function is the same.  Tile 0 always
// holds a valid key for every row that is written, so an all-masked tile
// never comes first (its p = exp(0) = 1 would otherwise count).  Query
// tiles are dispatched heaviest first (blockIdx.z == 0 holds the last
// query rows) so that the long causal rows do not start last.  The launch
// plan (body, tile sizes, ring stages, threads, shared memory) is computed
// in Python (repro_torch/kernels/attention/kernel.py: `plan`) and checked
// here against what each body was compiled for.
//
// bf16 where hd is a multiple of 8 and the tensors start on 16-byte
// boundaries (TMA's stride rules; the evaluation path), warp-specialised in
// the manner of FlashAttention-3: a block of 384 threads covers a 128-row
// query tile.
//   - Warpgroup 2 is the producer: one thread issues TMA loads (4-D tensor
//     maps over (B, L, H, hd), 64-column boxes with the 128-byte swizzle,
//     columns past hd filled with zeros by TMA) of Q once and of BK-key K
//     and V tiles into a ring of KST stages, each stage with full and empty
//     mbarriers; `setmaxnreg` drops it to 24 registers.
//   - Warpgroups 0 and 1 each own 64 query rows and rise to 240
//     registers.  S = Q K^T is one `wgmma` chain (m64nBKk16, both operands
//     K-major in shared memory); the online softmax runs in float32 on the
//     accumulators (log2 units, ex2.approx); P is packed to bf16 in
//     registers in the A-fragment layout and O += P V is a second `wgmma`
//     chain (n64 / n128 pieces across HDP) with A from registers and V
//     N-major in shared memory (the transposed-B mode of 16-bit types).
//     Tile kt's S is issued together with tile kt-1's P V, so a
//     warpgroup's softmax overlaps its own P V, and the two warpgroups take
//     turns issuing (named barriers), so one's softmax overlaps the
//     other's products.  A K stage is freed as soon as its S is computed,
//     a V stage after its P V.
//   - Tiles per width: HDP 64 and 128 take 96-key tiles and 3 stages
//     (with 128 keys, S (64 registers), P (32) and O (64) live at once
//     made ptxas spill P and serialise every wgmma, warning C7512; on an
//     H100 96 ran faster than 64 and 128 at the evaluation shape and at L
//     8192).  HDP 192 and 256 keep the 128-row Q tile with 48-key tiles
//     and 3 stages (157 and 209 KB).  ptxas gives every thread of a
//     384-thread block at most 168 registers whatever setmaxnreg grants
//     later: at 192, O (96), S (24) and P (12) fit, where 64-key tiles
//     spilled 48 bytes (C7512) and ran slower on an H100; at 256, O
//     alone is 128 and every key tile tried (32, 48, 64) spills and
//     serialises the wgmma (C7512), so that width runs well behind
//     scaled_dot_product_attention (splitting O's columns between the two
//     consumer warpgroups is the way out, not taken here).
//   - Query tiles are laid from the end of the sequence, so the ragged
//     one is the first (rows below 0 read TMA's zeros, are masked as
//     keys-after-query and never written): under `causal` it does the
//     least work, where a ragged last tile would do the most.
//   - TMA fills keys past Lk with zeros, which would score 0 and count:
//     they are masked explicitly, like the causal upper triangle, on the
//     tiles that reach past Lk or the diagonal.
//
// float32, and bf16 that TMA cannot read: no tensor-core path keeps
// float32 products, so 256 threads work on CUDA cores, 64-row query tiles
// against 64-key tiles: tiles converted to float32 (HDP columns, zeros past
// hd) in shared memory, thread (rg, cg) = (tid / 16, tid % 16) scoring rows
// 4 rg .. 4 rg + 3 against keys cg + 16 j (keys interleaved so that a
// quarter-warp's 16-byte reads of K fall in distinct banks) and holding a
// 4-row register tile of O (HDP / 16 columns); the next tile is loaded
// into registers while the current one is consumed where it takes at most
// 8 16-byte chunks per thread (f32 to HDP 128, bf16 to 256), else it is
// loaded when it is staged.  Rows whose bytes are a multiple of 16 on
// 16-byte-aligned tensors move in 16-byte chunks, others element by
// element.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;  // 16 row groups x 16 threads
constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per staged tile
constexpr int kPS = kBK + 4;   // float stride of a row of P in shared memory

// ---------------------------------------------------------------------------
// CUDA cores (float32, and bf16 that TMA cannot read)
// ---------------------------------------------------------------------------

// Reductions over the 16 threads of a row group (lanes 0-15 or 16-31).
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(~0u, x, o));
  return x;
}
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(~0u, x, o);
  return x;
}

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

// A 64-row tile of q, k or v moves as 16-byte chunks of kVec elements:
// each thread holds kChunks of them between the global load and the
// shared-memory store (as float32, kStride floats per row).
template <typename T, int HDP>
struct TileShape {
  static constexpr int kVec = 16 / sizeof(T);       // elements per chunk
  static constexpr int kChunkRow = HDP / kVec;      // chunks per row
  static constexpr int kChunks = 64 * kChunkRow / kThreads;
  static constexpr int kStride = HDP + 4;           // floats per staged row
  static constexpr bool kPrefetch = kChunks <= 8;   // next tile in registers
};

// Loads rows [row0, row0 + 64) of a (L, row_stride) view, columns [0, HDP):
// zeros past L and past hd; 16-byte loads when `vec` (hd * size a multiple
// of 16 and 16-byte-aligned rows), else element by element.
template <typename T, int HDP>
__device__ __forceinline__ void load_tile(
    uint4 (&r)[TileShape<T, HDP>::kChunks], const T* __restrict__ base,
    int row0, int L, size_t row_stride, int hd, bool vec) {
  using S = TileShape<T, HDP>;
  using Raw = std::conditional_t<sizeof(T) == 2, uint16_t, uint32_t>;
#pragma unroll
  for (int j = 0; j < S::kChunks; ++j) {
    const int idx = threadIdx.x + kThreads * j;
    const int row = idx / S::kChunkRow, col = (idx % S::kChunkRow) * S::kVec;
    r[j] = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + row >= L || col >= hd) continue;
    const T* p = base + (size_t)(row0 + row) * row_stride + col;
    if (vec) {
      r[j] = __ldg(reinterpret_cast<const uint4*>(p));
    } else {
      alignas(16) Raw e[S::kVec];
#pragma unroll
      for (int i = 0; i < S::kVec; ++i)
        e[i] = col + i < hd ? reinterpret_cast<const Raw*>(p)[i] : Raw(0);
      r[j] = *reinterpret_cast<const uint4*>(e);
    }
  }
}

template <typename T, int HDP>
__device__ __forceinline__ void store_tile(
    float* __restrict__ dst, const uint4 (&r)[TileShape<T, HDP>::kChunks]) {
  using S = TileShape<T, HDP>;
#pragma unroll
  for (int j = 0; j < S::kChunks; ++j) {
    const int idx = threadIdx.x + kThreads * j;
    const int row = idx / S::kChunkRow, col = (idx % S::kChunkRow) * S::kVec;
    float* d = dst + row * S::kStride + col;
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<uint4*>(d) = r[j];
    } else {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r[j]);
      const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
      const float2 c = __bfloat1622float2(h[2]), e = __bfloat1622float2(h[3]);
      *reinterpret_cast<float4*>(d) = make_float4(a.x, a.y, b.x, b.y);
      *reinterpret_cast<float4*>(d + 4) = make_float4(c.x, c.y, e.x, e.y);
    }
  }
}

template <int HDP>
constexpr size_t core_smem_bytes() {
  return (size_t)(kBQ * (HDP + 4) + 2 * kBK * (HDP + 4) + kBQ * kPS) *
         sizeof(float);
}

template <typename T, int HDP>
__global__ void __launch_bounds__(kThreads) flash_attention_core_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, int Lq, int Lk, int H,
    int hd, float scale, int causal, int vec) {
  using S = TileShape<T, HDP>;
  constexpr int kS = S::kStride;
  constexpr int kG = HDP / 64;  // 4-column groups per thread

  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // kBQ x kS
  float* ks = qs + kBQ * kS;                    // kBK x kS
  float* vs = ks + kBK * kS;                    // kBK x kS
  float* ps = vs + kBK * kS;                    // kBQ x kPS

  const int tid = threadIdx.x, rg = tid / 16, cg = tid % 16;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (int)(gridDim.z - 1 - blockIdx.z) * kBQ;
  const size_t rs = (size_t)H * hd;  // elements from one row to the next
  const T* qb = q + ((size_t)b * Lq * H + h) * hd;
  const T* kb = k + ((size_t)b * Lk * H + h) * hd;
  const T* vb = v + ((size_t)b * Lk * H + h) * hd;

  int n_kt = (Lk + kBK - 1) / kBK;
  if (causal) n_kt = min(n_kt, (min(q0 + kBQ, Lq) - 1) / kBK + 1);

  uint4 rk[S::kChunks], rv[S::kChunks];
  {
    uint4 rq[S::kChunks];
    load_tile<T, HDP>(rq, qb, q0, Lq, rs, hd, vec);
    store_tile<T, HDP>(qs, rq);
  }
  if constexpr (S::kPrefetch) {
    load_tile<T, HDP>(rk, kb, 0, Lk, rs, hd, vec);
    load_tile<T, HDP>(rv, vb, 0, Lk, rs, hd, vec);
  }

  float m[4], l[4], acc[4][4 * kG];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * kG; ++c) acc[i][c] = 0.f;
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    if constexpr (!S::kPrefetch) {
      load_tile<T, HDP>(rk, kb, k0, Lk, rs, hd, vec);
      load_tile<T, HDP>(rv, vb, k0, Lk, rs, hd, vec);
    }
    store_tile<T, HDP>(ks, rk);
    store_tile<T, HDP>(vs, rv);
    __syncthreads();  // K, V (and before the first tile, Q) are staged
    if constexpr (S::kPrefetch) {
      if (kt + 1 < n_kt) {
        load_tile<T, HDP>(rk, kb, k0 + kBK, Lk, rs, hd, vec);
        load_tile<T, HDP>(rv, vb, k0 + kBK, Lk, rs, hd, vec);
      }
    }

    // Scores of rows 4 rg + i against keys cg + 16 j.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HDP; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (rg * 4 + i) * kS + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + (cg + 16 * j) * kS + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float t = s[i][j];
          t = fmaf(qv[i].x, kv[j].x, t);
          t = fmaf(qv[i].y, kv[j].y, t);
          t = fmaf(qv[i].z, kv[j].z, t);
          t = fmaf(qv[i].w, kv[j].w, t);
          s[i][j] = t;
        }
    }

    // Online softmax over this tile; P goes to shared memory.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + rg * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + cg + 16 * j;
        const bool keep = kj < Lk && (!causal || kj <= qi);
        s[i][j] = keep ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(rg * 4 + i) * kPS + cg + 16 * j] = p;
        sum += p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + group_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * kG; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // P is complete

    // acc += P V for rows 4 rg + i, columns 64 g + 4 cg + c.
#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float p[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 t =
            *reinterpret_cast<const float4*>(ps + (rg * 4 + i) * kPS + j);
        p[i][0] = t.x;
        p[i][1] = t.y;
        p[i][2] = t.z;
        p[i][3] = t.w;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          const float4 vv = *reinterpret_cast<const float4*>(
              vs + (j + jj) * kS + g * 64 + cg * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][4 * g + 0] = fmaf(p[i][jj], vv.x, acc[i][4 * g + 0]);
            acc[i][4 * g + 1] = fmaf(p[i][jj], vv.y, acc[i][4 * g + 1]);
            acc[i][4 * g + 2] = fmaf(p[i][jj], vv.z, acc[i][4 * g + 2]);
            acc[i][4 * g + 3] = fmaf(p[i][jj], vv.w, acc[i][4 * g + 3]);
          }
        }
    }
    __syncthreads();  // K, V and P may be overwritten
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + rg * 4 + i;
    if (qi >= Lq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = out + ((size_t)b * Lq + qi) * rs + (size_t)h * hd;
#pragma unroll
    for (int g = 0; g < kG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = g * 64 + cg * 4 + c;
        if (col < hd) orow[col] = from_f<T>(acc[i][4 * g + c] / denom);
      }
  }
}

// ---------------------------------------------------------------------------
// bf16: warp-specialised TMA + wgmma
// ---------------------------------------------------------------------------

constexpr int kWgBQ = 128;     // query rows per block: 2 consumers x 64
constexpr int kConsumers = 2;  // consumer warpgroups
constexpr int kWgThreads = (kConsumers + 1) * 128;

template <int HDP, int BK, int KST>
struct WgLayout {
  static constexpr int kQ = kWgBQ * HDP * 2;  // bytes of the Q tile
  static constexpr int kKV = BK * HDP * 2;    // bytes of one K or V tile
  static constexpr int kBars = 1 + 4 * KST;
  // 1024 bytes of slack to align the tiles to the swizzle period.
  static constexpr size_t kBytes =
      1024 + kQ + 2 * KST * kKV + kBars * sizeof(uint64_t);
};

// O (64 x HDP) += P (64 x 16, registers) V (16 x HDP, N-major, column
// boxes BK * 128 bytes apart): n128 pieces, then an n64 piece where HDP is
// an odd multiple of 64.  O's fragments of columns [128 i, 128 i + 128)
// are o[64 i .. 64 i + 63], so the pieces are slices of o.
template <int HDP, int BK>
__device__ __forceinline__ void pv_chunk(float (&o)[HDP / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t dv) {
  using namespace hopper;
#pragma unroll
  for (int i = 0; i < HDP / 128; ++i)
    wgmma_rs_n128<1>(*reinterpret_cast<float(*)[64]>(o + 64 * i), a,
                     desc_add(dv, 2 * i * BK * 128), 1);
  if constexpr (HDP % 128)
    wgmma_rs_n64<1>(*reinterpret_cast<float(*)[32]>(o + HDP / 2 - 32), a,
                    desc_add(dv, (HDP / 64 - 1) * BK * 128), 1);
}

template <int HDP, int BK, int KST>
__global__ void __launch_bounds__(kWgThreads, 1) flash_attention_wgmma_kernel(
    const __grid_constant__ CUtensorMap mq,
    const __grid_constant__ CUtensorMap mk,
    const __grid_constant__ CUtensorMap mv, __nv_bfloat16* __restrict__ out,
    int Lq, int Lk, int H, int hd, float scale, int causal) {
  using namespace hopper;
  using S = WgLayout<HDP, BK, KST>;
  constexpr int kBoxes = HDP / 64;   // 128-byte column boxes per row
  constexpr int kChunks = BK / 16;   // 16-key steps of P V

  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = align1024(smem_raw);  // box c at c * kWgBQ * 128
  uint8_t* ks = qs + S::kQ;           // stage s at s * S::kKV, box c
  uint8_t* vs = ks + KST * S::kKV;    // at c * BK * 128 within it
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + KST * S::kKV);
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = k_full + KST;
  uint64_t* v_full = k_empty + KST;
  uint64_t* v_empty = v_full + KST;

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int h = blockIdx.x, b = blockIdx.y;
  // Query tiles end at Lq, Lq - 128, ...: the ragged one comes first
  // (q0 < 0; its rows below 0 read zeros and are never written), where
  // the causal mask leaves least work.  blockIdx.z == 0 is the heaviest.
  const int q0 = Lq - (int)(blockIdx.z + 1) * kWgBQ;
  int n_kt = (Lk + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (q0 + kWgBQ - 1) / BK + 1);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < KST; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(k_empty + s, kConsumers * 4);  // one arrival per warp
      mbar_init(v_empty + s, kConsumers * 4);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer ----------------------------------------------------------
    setmaxnreg_dec<24>();
    if (tid == 0) {
      mbar_arrive_expect_tx(q_full, S::kQ);
      for (int c = 0; c < kBoxes; ++c)
        tma_load_4d(qs + c * kWgBQ * 128, &mq, q_full, c * 64, h, q0, b);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % KST;
        const uint32_t ph = (kt / KST) & 1;
        mbar_wait(k_empty + s, ph ^ 1);
        mbar_arrive_expect_tx(k_full + s, S::kKV);
        for (int c = 0; c < kBoxes; ++c)
          tma_load_4d(ks + s * S::kKV + c * BK * 128, &mk, k_full + s,
                      c * 64, h, kt * BK, b);
        mbar_wait(v_empty + s, ph ^ 1);
        mbar_arrive_expect_tx(v_full + s, S::kKV);
        for (int c = 0; c < kBoxes; ++c)
          tma_load_4d(vs + s * S::kKV + c * BK * 128, &mv, v_full + s,
                      c * 64, h, kt * BK, b);
      }
    }
  } else {
    // ---- consumers: 64 query rows each -------------------------------------
    // Tile kt's S = Q K^T is issued together with tile kt-1's O += P V, so
    // the softmax of tile kt runs while P V is still on the tensor cores;
    // and the two consumers take turns issuing (named barriers 1 and 2),
    // so one's softmax overlaps the other's products.
    setmaxnreg_inc<240>();
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    const int wg_row0 = q0 + wg * 64;
    const int r0 = wg_row0 + warp * 16 + g;  // this thread's rows: r0, r0 + 8
    const float sl2 = scale * 1.4426950408889634f;  // scores in log2 units
    const uint8_t* qw = qs + wg * 64 * 128;
    const int my_turn = 1 + wg, other_turn = 2 - wg;
    float o[HDP / 2], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) o[i] = 0.f;
    float sc[BK / 2];  // S of the current tile: n8-tile j holds keys
                       // 8 j + 2 t, +1 of rows r0 (0, 1), r0 + 8 (2, 3)
    uint32_t pf[kChunks][4];  // P of the previous tile, bf16, A fragments

    // S = Q K^T over the stage's BK keys (one wgmma chain, not waited).
    auto issue_qk = [&](int s) {
      const uint64_t qd = opaque(smem_desc(qw, 0, 1024));
      const uint64_t kd = opaque(smem_desc(ks + s * S::kKV, 0, 1024));
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk) {
        const int col = (kk % 4) * 32;  // bytes into the 128-byte row
        const uint64_t a = desc_add(qd, (kk / 4) * kWgBQ * 128 + col);
        const uint64_t bd = desc_add(kd, (kk / 4) * BK * 128 + col);
        if constexpr (BK == 96)
          wgmma_ss_n96(sc, a, bd, kk);
        else
          wgmma_ss_n48(sc, a, bd, kk);
      }
      wgmma_commit();
    };
    // O += P V: key chunk c (16 keys) is score tiles 2c and 2c + 1, which
    // lie in registers as the A fragment of rows r0 and r0 + 8.  V is
    // N-major: 128-byte rows of one key, column boxes BK rows apart.
    auto issue_pv = [&](int s) {
      const uint64_t vd = opaque(smem_desc(vs + s * S::kKV, BK * 128, 1024));
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
        pv_chunk<HDP, BK>(o, pf[c], desc_add(vd, c * 16 * 128));
      wgmma_commit();
    };
    // Online softmax over tile kt's S (masked where it reaches past Lk or
    // the diagonal); leaves P = exp(S - m) in sc, returns alpha per row.
    auto softmax = [&](int kt, float (&alpha)[2]) {
      const int k0 = kt * BK;
      const bool edge = k0 + BK > Lk || (causal && k0 + BK - 1 > wg_row0);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * j + e] * sl2;
          if (edge) {
            const int key = k0 + 8 * j + 2 * t + (e & 1);
            if (key >= Lk || (causal && key > r0 + 8 * (e >> 1)))
              x = kNegInf;
          }
          sc[4 * j + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(~0u, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(~0u, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        alpha[i] = exp2_approx(m[i] - m_new);
        m[i] = m_new;
      }
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        sc[j] = exp2_approx(sc[j] - m[(j >> 1) & 1]);
        sum[(j >> 1) & 1] += sc[j];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        sum[i] += __shfl_xor_sync(~0u, sum[i], 1);
        sum[i] += __shfl_xor_sync(~0u, sum[i], 2);
        l[i] = l[i] * alpha[i] + sum[i];
      }
    };
    auto pack_p = [&]() {
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pf[c][i] = pack_bf16(sc[8 * c + 2 * i], sc[8 * c + 2 * i + 1]);
    };
    auto retire_pv = [&]() {  // after the wait that retires a P V chain
      fence_regs(o);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) fence_regs(pf[c]);
    };

    if (wg == 1) named_bar_arrive(1, 256);  // consumer 0 issues first
    mbar_wait(q_full, 0);
    float alpha[2];
    mbar_wait(k_full, 0);
    named_bar_sync(my_turn, 256);
    wgmma_fence();
    issue_qk(0);
    named_bar_arrive(other_turn, 256);
    wgmma_wait<0>();
    fence_regs(sc);
    if (lane == 0) mbar_arrive(k_empty);
    softmax(0, alpha);  // o is 0: alpha unused
    pack_p();
    for (int kt = 1; kt < n_kt; ++kt) {
      const int s = kt % KST, sp = (kt - 1) % KST;
      mbar_wait(k_full + s, (kt / KST) & 1);
      mbar_wait(v_full + sp, ((kt - 1) / KST) & 1);
      named_bar_sync(my_turn, 256);
      wgmma_fence();
      issue_qk(s);
      issue_pv(sp);  // tile kt-1's P V
      named_bar_arrive(other_turn, 256);
      wgmma_wait<1>();  // S of tile kt is ready
      fence_regs(sc);
      if (lane == 0) mbar_arrive(k_empty + s);
      softmax(kt, alpha);
      wgmma_wait<0>();  // P V of tile kt-1 has retired
      retire_pv();
      if (lane == 0) mbar_arrive(v_empty + sp);
#pragma unroll
      for (int i = 0; i < HDP / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      pack_p();
    }
    const int sl = (n_kt - 1) % KST;
    mbar_wait(v_full + sl, ((n_kt - 1) / KST) & 1);
    named_bar_sync(my_turn, 256);
    wgmma_fence();
    issue_pv(sl);
    named_bar_arrive(other_turn, 256);
    wgmma_wait<0>();
    retire_pv();
    if (lane == 0) mbar_arrive(v_empty + sl);

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      if (r < 0) continue;
      const float inv = 1.f / fmaxf(l[i], 1e-30f);
      __nv_bfloat16* orow =
          out + ((size_t)b * Lq + r) * H * hd + (size_t)h * hd;
#pragma unroll
      for (int n = 0; n < HDP / 8; ++n)
        if (n * 8 + 2 * t < hd)  // hd is a multiple of 8: whole pairs
          *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t) =
              pack_bf16(o[4 * n + 2 * i] * inv, o[4 * n + 2 * i + 1] * inv);
    }
  }
}

template <typename T, int HDP>
int launch_core(const void* q, const void* k, const void* v, void* out,
                int B, int Lq, int Lk, int H, int hd, float scale, int causal,
                cudaStream_t stream) {
  auto kernel = flash_attention_core_kernel<T, HDP>;
  const size_t smem = core_smem_bytes<HDP>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const bool vec = hd * (int)sizeof(T) % 16 == 0 &&
                   (reinterpret_cast<uintptr_t>(q) |
                    reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  const dim3 grid(H, B, (Lq + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Lq, Lk, H, hd, scale,
      causal, (int)vec);
  return (int)cudaGetLastError();
}

// Tensor map over a (B, L, H, hd) bf16 tensor: one head's rows, `rows` at
// a time, in 64-column boxes (columns past hd arrive as zeros).
int head_map(CUtensorMap* map, const void* base, int B, int L, int H, int hd,
             int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)H, (cuuint64_t)L,
                              (cuuint64_t)B};
  const cuuint64_t row = (cuuint64_t)H * hd * 2;
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, row, row * L};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  return hopper::make_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                                 base, dims, strides, box);
}

template <int HDP, int BK, int KST>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 int B, int Lq, int Lk, int H, int hd, float scale,
                 int causal, cudaStream_t stream) {
  if (hd % 8 || (reinterpret_cast<uintptr_t>(q) |
                 reinterpret_cast<uintptr_t>(k) |
                 reinterpret_cast<uintptr_t>(v) |
                 reinterpret_cast<uintptr_t>(out)) % 16)
    return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  int err = head_map(&mq, q, B, Lq, H, hd, kWgBQ);
  if (!err) err = head_map(&mk, k, B, Lk, H, hd, BK);
  if (!err) err = head_map(&mv, v, B, Lk, H, hd, BK);
  if (err) return err;
  auto kernel = flash_attention_wgmma_kernel<HDP, BK, KST>;
  const size_t smem = WgLayout<HDP, BK, KST>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(H, B, (Lq + kWgBQ - 1) / kWgBQ);
  kernel<<<grid, kWgThreads, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), Lq, Lk, H, hd, scale,
      causal);
  return (int)cudaGetLastError();
}

// Whether the plan computed in Python is the one this body was built for.
bool plan_matches(int q_tile, int k_tile, int stages, int threads,
                  long long smem, int want_q, int want_k, int want_stages,
                  int want_threads, size_t want_smem) {
  return q_tile == want_q && k_tile == want_k && stages == want_stages &&
         threads == want_threads && smem == (long long)want_smem;
}

template <typename T>
int launch_core_any(const void* q, const void* k, const void* v, void* out,
                    int B, int Lq, int Lk, int H, int hd, float scale,
                    int causal, int q_tile, int k_tile, int stages,
                    int threads, long long smem, cudaStream_t s) {
  const int hdp = (hd + 63) / 64 * 64;
#define FLASH_CORE(HDP)                                                     \
  if (hdp == HDP)                                                           \
    return plan_matches(q_tile, k_tile, stages, threads, smem, kBQ, kBK, 1, \
                        kThreads, core_smem_bytes<HDP>())                   \
               ? launch_core<T, HDP>(q, k, v, out, B, Lq, Lk, H, hd, scale, \
                                     causal, s)                             \
               : (int)cudaErrorInvalidValue;
  FLASH_CORE(64)
  FLASH_CORE(128)
  FLASH_CORE(192)
  FLASH_CORE(256)
#undef FLASH_CORE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; hd: 1..256.  body: 0 = CUDA cores
// (float32, or bfloat16 that TMA cannot read), 1 = TMA + wgmma (bfloat16,
// hd a multiple of 8, 16-byte-aligned tensors); q_tile, k_tile, stages,
// threads and smem are the plan's, refused unless they are the body's for
// hd padded to a multiple of 64.  Returns the cudaError_t of the launch.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int dtype,
                                      int B, int Lq, int Lk, int H, int hd,
                                      float scale, int causal, int body,
                                      int q_tile, int k_tile, int stages,
                                      int threads, long long smem,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || Lq < 1 || Lk < 1 || H < 1 || hd < 1 || hd > 256)
    return (int)cudaErrorInvalidValue;
  const int hdp = (hd + 63) / 64 * 64;
  if (body == 0 && dtype == 0)
    return launch_core_any<float>(q, k, v, out, B, Lq, Lk, H, hd, scale,
                                  causal, q_tile, k_tile, stages, threads,
                                  smem, s);
  if (body == 0 && dtype == 1)
    return launch_core_any<__nv_bfloat16>(q, k, v, out, B, Lq, Lk, H, hd,
                                          scale, causal, q_tile, k_tile,
                                          stages, threads, smem, s);
  if (body == 1 && dtype == 1) {
#define FLASH_WGMMA(HDP, BK, KST)                                           \
  if (hdp == HDP && plan_matches(q_tile, k_tile, stages, threads, smem,     \
                                 kWgBQ, BK, KST, kWgThreads,                \
                                 WgLayout<HDP, BK, KST>::kBytes))           \
    return launch_wgmma<HDP, BK, KST>(q, k, v, out, B, Lq, Lk, H, hd, scale, \
                                      causal, s);
    FLASH_WGMMA(64, 96, 3)
    FLASH_WGMMA(128, 96, 3)
    FLASH_WGMMA(192, 48, 3)
    FLASH_WGMMA(256, 48, 3)
#undef FLASH_WGMMA
  }
  return (int)cudaErrorInvalidValue;
}
