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
// Bound on the H100: memory.  Each (slot, KV head) reads its mapped pages'
// K and V once (2 * hd elements per position) and does ~4 * n_rep * C
// flops per element read, far below the ~295 flops per byte balance point.
// The least time is the mapped pages' K/V/pos bytes plus q and out, over
// 3.35 TB/s.
//
// Design (a simple first version): one block of 128 threads per (slot, KV
// head), which reads its own block-table row (no scalar prefetch).  The
// C * n_rep query rows, their running max and sum and the f32 accumulator
// live in shared memory.  The block walks the slot's entries `kblock` pages
// at a time: it stages the K and V tiles (kblock * ps rows of hd) into
// shared memory with 16-byte loads (rows padded by 16 bytes so that
// neighbouring threads' 16-byte row reads fall in distinct banks), one
// thread per (query row, key) computes a score, one warp per query row
// updates the running max and sum, and one thread per (query row, column)
// folds the probabilities into the accumulator.  Unmapped entries are
// staged as zeros, so a masked key never multiplies garbage.
//
// Known weakness, not fixed here: at the tmux-12l-768h shape (B = 8, 12 KV
// heads) this is 96 blocks on 132 SMs, each streaming ~9 pages one K-block
// after another with no overlap of loads and math.  Splitting the K axis
// across blocks (split-K, "flash-decoding") and a cp.async/TMA ring of
// stages are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;

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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(~0u, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(~0u, x, o);
  return x;
}

// Bytes of a staged K or V row: hd elements plus 16 bytes of padding.
template <typename T>
__host__ __device__ __forceinline__ int row_bytes(int hd) {
  return hd * (int)sizeof(T) + 16;
}

// Dynamic shared memory, in this order: K tile, V tile (kb_rows staged
// rows each), q and acc (R x hd f32), scores (R x kb_rows f32), m, l,
// alpha (R f32 each), key positions (kb_rows int32).
template <typename T>
size_t smem_bytes(int rows, int hd, int kb_rows) {
  return 2 * (size_t)kb_rows * row_bytes<T>(hd) +
         4 * (2 * (size_t)rows * hd + (size_t)rows * kb_rows + 3 * rows +
              kb_rows);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) paged_decode_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ pos_pages,
    const int* __restrict__ block_table, const int* __restrict__ q_pos,
    T* __restrict__ out, int C, int H, int KVH, int hd, int ps,
    int max_pages, int kblock, float scale, int causal, int window) {
  constexpr int kPer = 16 / sizeof(T);  // elements per 16-byte vector
  const int b = blockIdx.x, kvh = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int n_rep = H / KVH;
  const int R = C * n_rep;         // query rows: r = c * n_rep + rep
  const int KB = kblock * ps;      // staged key rows per K-block
  const int rb = row_bytes<T>(hd);
  const int vec_per_row = hd / kPer;

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ks = smem;
  unsigned char* vs = ks + (size_t)KB * rb;
  float* qs = reinterpret_cast<float*>(vs + (size_t)KB * rb);
  float* acc = qs + (size_t)R * hd;
  float* s = acc + (size_t)R * hd;
  float* m = s + (size_t)R * KB;
  float* l = m + R;
  float* alpha = l + R;
  int* kpos = reinterpret_cast<int*>(alpha + R);

  const int* bt = block_table + (size_t)b * max_pages;
  const int* qp = q_pos + (size_t)b * C;
  for (int i = tid; i < R * hd; i += kThreads) {
    const int r = i / hd, d = i % hd;
    const int c = r / n_rep, head = kvh * n_rep + r % n_rep;
    qs[i] = to_f(q[(((size_t)b * C + c) * H + head) * hd + d]);
    acc[i] = 0.f;
  }
  for (int r = tid; r < R; r += kThreads) {
    m[r] = kNegInf;
    l[r] = 0.f;
  }

  const size_t row_stride = (size_t)KVH * hd;        // elements
  const size_t page_stride = (size_t)ps * row_stride;
  const int n_blocks = (max_pages + kblock - 1) / kblock;
  for (int blk = 0; blk < n_blocks; ++blk) {
    // Every thread reads the same entries, so the skip is uniform.
    bool mapped = false;
    for (int j = 0; j < kblock; ++j) {
      const int e = blk * kblock + j;
      mapped |= e < max_pages && bt[e] >= 0;
    }
    if (!mapped) continue;
    __syncthreads();  // the last K-block's readers (and the init) are done

    for (int i = tid; i < KB * vec_per_row; i += kThreads) {
      const int row = i / vec_per_row, col = i % vec_per_row;
      const int e = blk * kblock + row / ps;
      const int page = e < max_pages ? bt[e] : -1;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (page >= 0) {
        const size_t off = (size_t)page * page_stride +
                           (size_t)(row % ps) * row_stride + (size_t)kvh * hd;
        kv = __ldg(reinterpret_cast<const uint4*>(k_pages + off) + col);
        vv = __ldg(reinterpret_cast<const uint4*>(v_pages + off) + col);
      }
      *reinterpret_cast<uint4*>(ks + (size_t)row * rb + col * 16) = kv;
      *reinterpret_cast<uint4*>(vs + (size_t)row * rb + col * 16) = vv;
    }
    for (int row = tid; row < KB; row += kThreads) {
      const int e = blk * kblock + row / ps;
      const int page = e < max_pages ? bt[e] : -1;
      kpos[row] = page >= 0 ? pos_pages[(size_t)page * ps + row % ps] : -1;
    }
    __syncthreads();

    // Scores: one thread per (query row, key); neighbouring threads take
    // neighbouring keys.
    for (int i = tid; i < R * KB; i += kThreads) {
      const int r = i / KB, row = i % KB;
      const uint4* kr = reinterpret_cast<const uint4*>(ks + (size_t)row * rb);
      const float* qr = qs + (size_t)r * hd;
      float dot = 0.f;
      for (int v = 0; v < vec_per_row; ++v) {
        const uint4 u = kr[v];
        const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
        for (int t = 0; t < kPer; ++t) dot += qr[v * kPer + t] * to_f(e[t]);
      }
      const int kp = kpos[row];
      const int diff = qp[r / n_rep] - kp;
      const bool keep = kp >= 0 && (!causal || diff >= 0) &&
                        (window < 0 || diff < window);
      s[i] = keep ? dot * scale : kNegInf;
    }
    __syncthreads();

    // Online softmax: one warp per query row.
    for (int r = warp; r < R; r += kThreads / 32) {
      float* sr = s + (size_t)r * KB;
      float mx = kNegInf;
      for (int j = lane; j < KB; j += 32) mx = fmaxf(mx, sr[j]);
      const float m_prev = m[r];
      const float m_new = fmaxf(m_prev, warp_max(mx));
      float sum = 0.f;
      for (int j = lane; j < KB; j += 32) {
        const float p = expf(sr[j] - m_new);
        sr[j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float a = expf(m_prev - m_new);
        alpha[r] = a;
        l[r] = l[r] * a + sum;
        m[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V: one thread per (query row, column).
    for (int i = tid; i < R * hd; i += kThreads) {
      const int r = i / hd, d = i % hd;
      const float* pr = s + (size_t)r * KB;
      const unsigned char* vcol = vs + d * sizeof(T);
      float pv = 0.f;
      for (int row = 0; row < KB; ++row)
        pv += pr[row] * to_f(*reinterpret_cast<const T*>(vcol + (size_t)row * rb));
      acc[i] = acc[i] * alpha[r] + pv;
    }
  }
  __syncthreads();

  for (int i = tid; i < R * hd; i += kThreads) {
    const int r = i / hd, d = i % hd;
    const int c = r / n_rep, head = kvh * n_rep + r % n_rep;
    out[(((size_t)b * C + c) * H + head) * hd + d] =
        from_f<T>(acc[i] / fmaxf(l[r], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* pos_pages, const void* block_table, const void* q_pos,
           void* out, int B, int C, int H, int KVH, int hd, int ps,
           int max_pages, int kblock, float scale, int causal, int window,
           cudaStream_t stream) {
  if (KVH < 1 || H % KVH || hd % (16 / sizeof(T)) || kblock < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<T>(C * (H / KVH), hd, kblock * ps);
  auto kernel = paged_decode_attention_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3(B, KVH), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(pos_pages),
      static_cast<const int*>(block_table), static_cast<const int*>(q_pos),
      static_cast<T*>(out), C, H, KVH, hd, ps, max_pages, kblock, scale,
      causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; window < 0 means no window.  Returns
// the cudaError_t of the launch.
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* pos_pages, const void* block_table, const void* q_pos,
    void* out, int dtype, int B, int C, int H, int KVH, int hd, int ps,
    int max_pages, int kblock, float scale, int causal, int window,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_pages, v_pages, pos_pages, block_table, q_pos,
                         out, B, C, H, KVH, hd, ps, max_pages, kblock, scale,
                         causal, window, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, pos_pages, block_table,
                                 q_pos, out, B, C, H, KVH, hd, ps, max_pages,
                                 kblock, scale, causal, window, s);
  return (int)cudaErrorInvalidValue;
}
