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
// at longer sequences the flops bound alone.
//
// Shared design: one block per (head, batch row, 64-row query tile),
// reading q, k and v through their strides straight from (B, L, H, hd), so
// none of the TPU wrapper's fold / transpose / pad copies exist.  The block
// walks the key axis in 64-key tiles from tile 0 upwards -- the loop inside
// the block takes the place of the TPU's sequential K grid axis -- with the
// running max and sum of each query row in registers, reduced across the
// threads that share the row by warp shuffles.  Under `causal` the loop
// stops at the tile holding the block's last diagonal key; the TPU kernel
// streams the masked tiles as zeros, so the function is the same.  Tile 0
// always holds a valid key for every real row, so an all-masked tile never
// comes first (its p = exp(0) = 1 would otherwise count).  Query tiles are
// dispatched heaviest first (blockIdx.z counts down the tiles) so that the
// long causal rows do not start last.
//
// bf16 (the evaluation path): 4 warps, 16 query rows each, on the tensor
// cores with `mma.sync.m16n8k16` (bf16 in, float32 accumulators).  Q, K and
// V tiles stay bf16 in shared memory (rows padded by 16 bytes, so the
// 8 rows an `ldmatrix` reads fall in distinct banks); K and V are double-
// buffered with `cp.async`, the next tile's copy in flight while the
// current one is consumed.  Each warp keeps its Q fragments, its 16 x 64
// score tile and its 16 x hd float32 O accumulator in registers; the score
// accumulators are laid out as the A operand of the P.V product, so P
// never goes through shared memory.
//
// float32: no tensor-core path keeps float32 products, so 256 threads work
// on CUDA cores: tiles converted to float32 in shared memory, thread
// (rg, cg) = (tid / 16, tid % 16) scoring rows 4 rg .. 4 rg + 3 against
// keys cg + 16 j (keys interleaved so that a quarter-warp's 16-byte reads
// of K fall in distinct banks) and holding a 4-row register tile of O.
//
// Known weakness, not fixed here: `mma.sync` reaches only part of the
// tensor cores' rate; `wgmma` with a TMA ring of K/V tiles and a producer
// warp is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;  // 4 warps x 16 query rows

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a (16 x 16, row-major) * b (16 x 8, column-major), float32 d.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as a bf16 pair, `lo` in the low half (the lower index).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Rows [row0, row0 + 64) of a (., L, H, hd) tensor into a 64 x (hd + 8)
// shared tile; rows past L become zeros.
template <int HD>
__device__ __forceinline__ void load_tile_async(
    __nv_bfloat16* dst, const __nv_bfloat16* __restrict__ base, int row0,
    int L, size_t row_stride) {
  constexpr int kChunks = HD / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < 64 * kChunks; i += kMmaThreads) {
    const int row = i / kChunks, c = i % kChunks;
    const bool ok = row0 + row < L;
    cp_async16(dst + row * (HD + 8) + c * 8,
               base + (size_t)(ok ? row0 + row : 0) * row_stride + c * 8, ok);
  }
}

template <int HD>
constexpr size_t mma_smem_bytes() {  // Q, two stages of K and of V
  return 5 * 64 * (HD + 8) * sizeof(__nv_bfloat16);
}

// Thread layout of an m16n8 fragment: lane = 4 g + t holds rows g and g + 8,
// columns 2 t and 2 t + 1 of each 8-wide tile.
template <int HD>
__global__ void __launch_bounds__(kMmaThreads) flash_attention_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    int Lq, int Lk, int H, float scale, int causal) {
  constexpr int kS = HD + 8;   // element stride of a staged row
  constexpr int kT = 64 * kS;  // elements of one staged tile
  constexpr int kKS = HD / 16; // k-steps of Q K^T
  constexpr int kON = HD / 8;  // 8-column tiles of O

  extern __shared__ float4 smem4[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* ks = qs + kT;      // stages 0, 1
  __nv_bfloat16* vs = ks + 2 * kT;  // stages 0, 1

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (int)(gridDim.z - 1 - blockIdx.z) * 64;
  const size_t rs = (size_t)H * HD;
  const __nv_bfloat16* qb = q + ((size_t)b * Lq * H + h) * HD;
  const __nv_bfloat16* kb = k + ((size_t)b * Lk * H + h) * HD;
  const __nv_bfloat16* vb = v + ((size_t)b * Lk * H + h) * HD;

  int n_kt = (Lk + 63) / 64;
  if (causal) n_kt = min(n_kt, (min(q0 + 64, Lq) - 1) / 64 + 1);

  load_tile_async<HD>(qs, qb, q0, Lq, rs);
  load_tile_async<HD>(ks, kb, 0, Lk, rs);
  load_tile_async<HD>(vs, vb, 0, Lk, rs);
  cp_async_commit();

  const int row = q0 + warp * 16 + g;  // this thread's rows: row, row + 8
  uint32_t qf[kKS][4];
  float o[kON][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < kON; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < n_kt) {
      load_tile_async<HD>(ks + (st ^ 1) * kT, kb, (kt + 1) * 64, Lk, rs);
      load_tile_async<HD>(vs + (st ^ 1) * kT, vb, (kt + 1) * 64, Lk, rs);
      cp_async_commit();
      cp_async_wait<1>();  // all but the tile just issued have landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk)
        ldmatrix_x4(qf[kk], qs + (warp * 16 + lane % 16) * kS + kk * 16 +
                                (lane / 16) * 8);
    }
    const __nv_bfloat16* kst = ks + st * kT;
    const __nv_bfloat16* vst = vs + st * kT;

    // S = Q K^T: 16 rows x 64 keys per warp, eight 8-key tiles.
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk)
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        uint32_t kf[4];  // B fragments of key tiles j and j + 1
        const int mi = lane / 8;
        ldmatrix_x4(kf, kst + (j * 8 + (mi / 2) * 8 + lane % 8) * kS +
                            kk * 16 + (mi % 2) * 8);
        mma_bf16(s[j], qf[kk], kf[0], kf[1]);
        mma_bf16(s[j + 1], qf[kk], kf[2], kf[3]);
      }

    // Online softmax over this tile, rows `row` (e < 2) and `row + 8`.
    const int k0 = kt * 64;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * t + (e & 1);
        const bool keep = key < Lk && (!causal || key <= row + (e / 2) * 8);
        s[j][e] = keep ? s[j][e] * scale : kNegInf;
        mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(~0u, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(~0u, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m[e / 2]);
        sum[e / 2] += s[j][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(~0u, sum[i], 1);
      sum[i] += __shfl_xor_sync(~0u, sum[i], 2);
      l[i] = l[i] * alpha[i] + sum[i];
    }
#pragma unroll
    for (int n = 0; n < kON; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V, 16 keys per k-step: score tiles 2 j2 and 2 j2 + 1 are the
    // A fragment as they lie in registers.
#pragma unroll
    for (int j2 = 0; j2 < 4; ++j2) {
      const uint32_t pf[4] = {
          pack_bf16(s[2 * j2][0], s[2 * j2][1]),
          pack_bf16(s[2 * j2][2], s[2 * j2][3]),
          pack_bf16(s[2 * j2 + 1][0], s[2 * j2 + 1][1]),
          pack_bf16(s[2 * j2 + 1][2], s[2 * j2 + 1][3])};
#pragma unroll
      for (int n = 0; n < kON; n += 2) {
        uint32_t vf[4];  // B fragments of O column tiles n and n + 1
        const int mi = lane / 8;
        ldmatrix_x4_trans(vf, vst + (j2 * 16 + (mi % 2) * 8 + lane % 8) * kS +
                                  n * 8 + (mi / 2) * 8);
        mma_bf16(o[n], pf, vf[0], vf[1]);
        mma_bf16(o[n + 1], pf, vf[2], vf[3]);
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration's copy
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row + 8 * i;
    if (r >= Lq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    __nv_bfloat16* orow = out + ((size_t)b * Lq + r) * rs + (size_t)h * HD;
#pragma unroll
    for (int n = 0; n < kON; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t) =
          pack_bf16(o[n][2 * i] / denom, o[n][2 * i + 1] / denom);
  }
}

template <typename T, typename Kernel>
int launch(Kernel kernel, int threads, size_t smem, const void* q,
           const void* k, const void* v, void* out, int B, int Lq, int Lk,
           int H, float scale, int causal, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, B, (Lq + kBQ - 1) / kBQ);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Lq, Lk, H, scale,
      causal);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; hd: 64 or 128.  Returns the
// cudaError_t of the launch.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int dtype,
                                      int B, int Lq, int Lk, int H, int hd,
                                      float scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || Lq < 1 || Lk < 1 || H < 1) return (int)cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  if (dtype == 0 && hd == 64)
    return launch<float>(flash_attention_f32_kernel<64>, kThreads,
                         smem_bytes<64>(), q, k, v, out, B, Lq, Lk, H, scale,
                         causal, s);
  if (dtype == 0 && hd == 128)
    return launch<float>(flash_attention_f32_kernel<128>, kThreads,
                         smem_bytes<128>(), q, k, v, out, B, Lq, Lk, H,
                         scale, causal, s);
  if (dtype == 1 && hd == 64)
    return launch<bf16>(flash_attention_mma_kernel<64>, kMmaThreads,
                        mma_smem_bytes<64>(), q, k, v, out, B, Lq, Lk, H,
                        scale, causal, s);
  if (dtype == 1 && hd == 128)
    return launch<bf16>(flash_attention_mma_kernel<128>, kMmaThreads,
                        mma_smem_bytes<128>(), q, k, v, out, B, Lq, Lk, H,
                        scale, causal, s);
  return (int)cudaErrorInvalidValue;
}
