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
// never written.  One departure, in bf16 only: the probabilities P are
// rounded to bf16 for the P.V product on the tensor cores (the TPU kernel
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
// query rows) so that the long causal rows do not start last.  The launch plan (tile sizes, ring
// stages, threads, shared memory) is computed in Python
// (repro_torch/kernels/attention/kernel.py: `plan`) and checked here
// against what each body was compiled for.
//
// bf16 (the evaluation path), warp-specialised in the manner of
// FlashAttention-3: a block of 384 threads covers a 128-row query tile.
//   - Warpgroup 2 is the producer: one thread issues TMA loads (4-D tensor
//     maps over (B, L, H, hd), 64-column boxes with the 128-byte swizzle)
//     of Q once and of 96-key K and V tiles into a 3-stage ring, each
//     stage with full and empty mbarriers; `setmaxnreg` drops it to 24
//     registers.
//   - Warpgroups 0 and 1 each own 64 query rows and rise to 240
//     registers.  S = Q K^T is one `wgmma` chain (m64n96k16, both operands
//     K-major in shared memory); the online softmax runs in float32 on the
//     accumulators (log2 units, ex2.approx); P is packed to bf16 in
//     registers in the A-fragment layout and O += P V is a second `wgmma`
//     chain with A from registers and V N-major in shared memory (the
//     transposed-B mode of 16-bit types).  Tile kt's S is issued together
//     with tile kt-1's P V, so a warpgroup's softmax overlaps its own
//     P V, and the two warpgroups take turns issuing (named barriers), so
//     one's softmax overlaps the other's products.  A K stage is freed as
//     soon as its S is computed, a V stage after its P V.
//   - 96-key tiles: with 128, S (64 registers), P (32) and O (64) live at
//     once made ptxas spill P and serialise every wgmma (warning C7512),
//     whatever the setmaxnreg count; 64 and 96 do not spill, and on an
//     H100 96 ran faster than 64 and 128 at the evaluation shape and at
//     L 8192.
//   - Query tiles are laid from the end of the sequence, so the ragged
//     one is the first (rows below 0 read TMA's zeros, are masked as
//     keys-after-query and never written): under `causal` it does the
//     least work, where a ragged last tile would do the most.
//   - TMA fills keys past Lk with zeros, which would score 0 and count:
//     they are masked explicitly, like the causal upper triangle, on the
//     tiles that reach past Lk or the diagonal.
// Shared memory: Q 32 KB + 3 stages x (K + V) 24 KB each at hd 128 (177 KB),
// one block per SM.
//
// float32: no tensor-core path keeps float32 products, so 256 threads work
// on CUDA cores, 64-row query tiles against 64-key tiles: tiles converted
// to float32 in shared memory, thread (rg, cg) = (tid / 16, tid % 16)
// scoring rows 4 rg .. 4 rg + 3 against keys cg + 16 j (keys interleaved so
// that a quarter-warp's 16-byte reads of K fall in distinct banks) and
// holding a 4-row register tile of O; the next tile is loaded into
// registers while the current one is consumed.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;  // 16 row groups x 16 threads
constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per staged tile
constexpr int kPS = kBK + 4;   // float stride of a row of P in shared memory

// ---------------------------------------------------------------------------
// float32 on CUDA cores
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

// A 64-row tile of q, k or v moves as float4 vectors: each thread holds
// kVecs of them between the global load and the shared-memory store.
template <int HD>
struct TileShape {
  static constexpr int kVecRow = HD / 4;  // vectors per row
  static constexpr int kVecs = 64 * kVecRow / kThreads;
  static constexpr int kStride = HD + 4;  // float stride of a staged row
};

template <int HD>
__device__ __forceinline__ void load_tile(float4 (&r)[TileShape<HD>::kVecs],
                                          const float* __restrict__ base,
                                          int row0, int L, size_t row_stride) {
  using S = TileShape<HD>;
#pragma unroll
  for (int j = 0; j < S::kVecs; ++j) {
    const int idx = threadIdx.x + kThreads * j;
    const int row = idx / S::kVecRow, col = idx % S::kVecRow;
    r[j] = make_float4(0.f, 0.f, 0.f, 0.f);  // rows past L stage as zeros
    if (row0 + row < L)
      r[j] = __ldg(reinterpret_cast<const float4*>(
                       base + (size_t)(row0 + row) * row_stride) + col);
  }
}

template <int HD>
__device__ __forceinline__ void store_tile(
    float* __restrict__ dst, const float4 (&r)[TileShape<HD>::kVecs]) {
  using S = TileShape<HD>;
#pragma unroll
  for (int j = 0; j < S::kVecs; ++j) {
    const int idx = threadIdx.x + kThreads * j;
    const int row = idx / S::kVecRow, col = idx % S::kVecRow;
    *reinterpret_cast<float4*>(dst + row * S::kStride + col * 4) = r[j];
  }
}

template <int HD>
constexpr size_t smem_bytes() {
  return (size_t)(kBQ * (HD + 4) + 2 * kBK * (HD + 4) + kBQ * kPS) *
         sizeof(float);
}

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_attention_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out, int Lq, int Lk,
    int H, float scale, int causal) {
  using S = TileShape<HD>;
  constexpr int kS = S::kStride;
  constexpr int kG = HD / 64;  // 4-column groups per thread: 1 or 2

  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // kBQ x kS
  float* ks = qs + kBQ * kS;                    // kBK x kS
  float* vs = ks + kBK * kS;                    // kBK x kS
  float* ps = vs + kBK * kS;                    // kBQ x kPS

  const int tid = threadIdx.x, rg = tid / 16, cg = tid % 16;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (int)(gridDim.z - 1 - blockIdx.z) * kBQ;
  const size_t rs = (size_t)H * HD;  // elements from one row to the next
  const float* qb = q + ((size_t)b * Lq * H + h) * HD;
  const float* kb = k + ((size_t)b * Lk * H + h) * HD;
  const float* vb = v + ((size_t)b * Lk * H + h) * HD;

  int n_kt = (Lk + kBK - 1) / kBK;
  if (causal) n_kt = min(n_kt, (min(q0 + kBQ, Lq) - 1) / kBK + 1);

  float4 rk[S::kVecs], rv[S::kVecs];
  {
    float4 rq[S::kVecs];
    load_tile<HD>(rq, qb, q0, Lq, rs);
    store_tile<HD>(qs, rq);
  }
  load_tile<HD>(rk, kb, 0, Lk, rs);
  load_tile<HD>(rv, vb, 0, Lk, rs);

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
    store_tile<HD>(ks, rk);
    store_tile<HD>(vs, rv);
    __syncthreads();  // K, V (and before the first tile, Q) are staged
    if (kt + 1 < n_kt) {
      load_tile<HD>(rk, kb, k0 + kBK, Lk, rs);
      load_tile<HD>(rv, vb, k0 + kBK, Lk, rs);
    }

    // Scores of rows 4 rg + i against keys cg + 16 j.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
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
    float* orow = out + ((size_t)b * Lq + qi) * rs + (size_t)h * HD;
#pragma unroll
    for (int g = 0; g < kG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        orow[g * 64 + cg * 4 + c] = acc[i][4 * g + c] / denom;
  }
}

// ---------------------------------------------------------------------------
// bf16: warp-specialised TMA + wgmma
// ---------------------------------------------------------------------------

constexpr int kWgBQ = 128;     // query rows per block: 2 consumers x 64
constexpr int kWgBK = 96;      // keys per K/V tile
constexpr int kStages = 3;     // depth of the K/V ring
constexpr int kConsumers = 2;  // consumer warpgroups
constexpr int kWgThreads = (kConsumers + 1) * 128;

template <int HD>
struct WgLayout {
  static constexpr int kQ = kWgBQ * HD * 2;   // bytes of the Q tile
  static constexpr int kKV = kWgBK * HD * 2;  // bytes of one K or V tile
  static constexpr int kBars = 1 + 4 * kStages;
  // 1024 bytes of slack to align the tiles to the swizzle period.
  static constexpr size_t kBytes =
      1024 + kQ + 2 * kStages * kKV + kBars * sizeof(uint64_t);
};

template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1) flash_attention_wgmma_kernel(
    const __grid_constant__ CUtensorMap mq,
    const __grid_constant__ CUtensorMap mk,
    const __grid_constant__ CUtensorMap mv, __nv_bfloat16* __restrict__ out,
    int Lq, int Lk, int H, float scale, int causal) {
  using namespace hopper;
  using S = WgLayout<HD>;
  constexpr int kBoxes = HD / 64;  // 128-byte column boxes per row
  constexpr int kChunks = kWgBK / 16;  // 16-key steps of P V

  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = align1024(smem_raw);    // box c at c * kWgBQ * 128
  uint8_t* ks = qs + S::kQ;             // stage s at s * S::kKV, box c
  uint8_t* vs = ks + kStages * S::kKV;  // at c * kWgBK * 128 within it
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + kStages * S::kKV);
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = k_full + kStages;
  uint64_t* v_full = k_empty + kStages;
  uint64_t* v_empty = v_full + kStages;

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int h = blockIdx.x, b = blockIdx.y;
  // Query tiles end at Lq, Lq - 128, ...: the ragged one comes first
  // (q0 < 0; its rows below 0 read zeros and are never written), where
  // the causal mask leaves least work.  blockIdx.z == 0 is the heaviest.
  const int q0 = Lq - (int)(blockIdx.z + 1) * kWgBQ;
  int n_kt = (Lk + kWgBK - 1) / kWgBK;
  if (causal) n_kt = min(n_kt, (q0 + kWgBQ - 1) / kWgBK + 1);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
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
        const int s = kt % kStages;
        const uint32_t ph = (kt / kStages) & 1;
        mbar_wait(k_empty + s, ph ^ 1);
        mbar_arrive_expect_tx(k_full + s, S::kKV);
        for (int c = 0; c < kBoxes; ++c)
          tma_load_4d(ks + s * S::kKV + c * kWgBK * 128, &mk, k_full + s,
                      c * 64, h, kt * kWgBK, b);
        mbar_wait(v_empty + s, ph ^ 1);
        mbar_arrive_expect_tx(v_full + s, S::kKV);
        for (int c = 0; c < kBoxes; ++c)
          tma_load_4d(vs + s * S::kKV + c * kWgBK * 128, &mv, v_full + s,
                      c * 64, h, kt * kWgBK, b);
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
    float o[HD / 2], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float sc[kWgBK / 2];  // S of the current tile: n8-tile j holds keys
                          // 8 j + 2 t, +1 of rows r0 (0, 1), r0 + 8 (2, 3)
    uint32_t pf[kChunks][4];  // P of the previous tile, bf16, A fragments

    // S = Q K^T over the stage's kWgBK keys (one wgmma chain, not waited).
    auto issue_qk = [&](int s) {
      const uint64_t qd = opaque(smem_desc(qw, 0, 1024));
      const uint64_t kd = opaque(smem_desc(ks + s * S::kKV, 0, 1024));
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int col = (kk % 4) * 32;  // bytes into the 128-byte row
        const uint64_t a = desc_add(qd, (kk / 4) * kWgBQ * 128 + col);
        wgmma_ss_n96(sc, a, desc_add(kd, (kk / 4) * kWgBK * 128 + col), kk);
      }
      wgmma_commit();
    };
    // O += P V: key chunk c (16 keys) is score tiles 2c and 2c + 1, which
    // lie in registers as the A fragment of rows r0 and r0 + 8.  V is
    // N-major: 128-byte rows of one key, column boxes kWgBK rows apart.
    auto issue_pv = [&](int s) {
      const uint64_t vd =
          opaque(smem_desc(vs + s * S::kKV, kWgBK * 128, 1024));
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const uint64_t dv = desc_add(vd, c * 16 * 128);
        if constexpr (HD == 64)
          wgmma_rs_n64<1>(o, pf[c], dv, 1);
        else
          wgmma_rs_n128<1>(o, pf[c], dv, 1);
      }
      wgmma_commit();
    };
    // Online softmax over tile kt's S (masked where it reaches past Lk or
    // the diagonal); leaves P = exp(S - m) in sc, returns alpha per row.
    auto softmax = [&](int kt, float (&alpha)[2]) {
      const int k0 = kt * kWgBK;
      const bool edge = k0 + kWgBK > Lk || (causal && k0 + kWgBK - 1 > wg_row0);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < kWgBK / 8; ++j)
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
      for (int j = 0; j < kWgBK / 2; ++j) {
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
      const int s = kt % kStages, sp = (kt - 1) % kStages;
      mbar_wait(k_full + s, (kt / kStages) & 1);
      mbar_wait(v_full + sp, ((kt - 1) / kStages) & 1);
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
      for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      pack_p();
    }
    const int sl = (n_kt - 1) % kStages;
    mbar_wait(v_full + sl, ((n_kt - 1) / kStages) & 1);
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
          out + ((size_t)b * Lq + r) * H * HD + (size_t)h * HD;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t) =
            pack_bf16(o[4 * n + 2 * i] * inv, o[4 * n + 2 * i + 1] * inv);
    }
  }
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* out, int B,
               int Lq, int Lk, int H, float scale, int causal,
               cudaStream_t stream) {
  auto kernel = flash_attention_f32_kernel<HD>;
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, B, (Lq + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Lq, Lk, H,
      scale, causal);
  return (int)cudaGetLastError();
}

// Tensor map over a (B, L, H, hd) bf16 tensor: one head's rows, `rows` at
// a time, in 64-column boxes.
template <int HD>
int head_map(CUtensorMap* map, const void* base, int B, int L, int H,
             int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)H, (cuuint64_t)L,
                              (cuuint64_t)B};
  const cuuint64_t row = (cuuint64_t)H * HD * 2;
  const cuuint64_t strides[3] = {HD * 2, row, row * L};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  return hopper::make_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                                 base, dims, strides, box);
}

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 int B, int Lq, int Lk, int H, float scale, int causal,
                 cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  int err = head_map<HD>(&mq, q, B, Lq, H, kWgBQ);
  if (!err) err = head_map<HD>(&mk, k, B, Lk, H, kWgBK);
  if (!err) err = head_map<HD>(&mv, v, B, Lk, H, kWgBK);
  if (err) return err;
  auto kernel = flash_attention_wgmma_kernel<HD>;
  const size_t smem = WgLayout<HD>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(H, B, (Lq + kWgBQ - 1) / kWgBQ);
  kernel<<<grid, kWgThreads, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), Lq, Lk, H, scale,
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; hd: 64 or 128.  body: 0 = CUDA cores
// (float32), 1 = TMA + wgmma (bf16); q_tile, k_tile, stages, threads and
// smem are the plan's, refused unless they are the body's.  Returns the
// cudaError_t of the launch.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int dtype,
                                      int B, int Lq, int Lk, int H, int hd,
                                      float scale, int causal, int body,
                                      int q_tile, int k_tile, int stages,
                                      int threads, long long smem,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || Lq < 1 || Lk < 1 || H < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && body == 0) {
    if (hd == 64 && plan_matches(q_tile, k_tile, stages, threads, smem, kBQ,
                                 kBK, 1, kThreads, smem_bytes<64>()))
      return launch_f32<64>(q, k, v, out, B, Lq, Lk, H, scale, causal, s);
    if (hd == 128 && plan_matches(q_tile, k_tile, stages, threads, smem, kBQ,
                                  kBK, 1, kThreads, smem_bytes<128>()))
      return launch_f32<128>(q, k, v, out, B, Lq, Lk, H, scale, causal, s);
  }
  if (dtype == 1 && body == 1) {
    if (hd == 64 &&
        plan_matches(q_tile, k_tile, stages, threads, smem, kWgBQ, kWgBK,
                     kStages, kWgThreads, WgLayout<64>::kBytes))
      return launch_wgmma<64>(q, k, v, out, B, Lq, Lk, H, scale, causal, s);
    if (hd == 128 &&
        plan_matches(q_tile, k_tile, stages, threads, smem, kWgBQ, kWgBK,
                     kStages, kWgThreads, WgLayout<128>::kBytes))
      return launch_wgmma<128>(q, k, v, out, B, Lq, Lk, H, scale, causal, s);
  }
  return (int)cudaErrorInvalidValue;
}
