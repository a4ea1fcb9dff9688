// Shared body of the two index-embed demux kernels (index_embed_demux.cu,
// decode_demux.cu).  Both compute, for output row (n, l) of slot b,
//
//   out[b, n, l, :] = gelu_tanh(h[b, l]·W1h + p[b, n]·W1p + b1)·W2 + b2
//
// with W1 = [W1h | W1p] split by input columns so the (2d)-wide concat of h
// and p is never built.  Weights come in PyTorch's (out, in) layout: w1 is
// (H, 2d) -- columns [0, d) multiply h, [d, 2d) multiply p -- and w2 is
// (d, H).  Every product is computed here, on CUDA cores in float32 from
// inputs of type T; nothing goes to a library.
//
// Work unit: a thread-block *cluster* of kCS blocks owns Rh rows of h
// (l0 .. l0+Rh), Rp rows of p (n0 .. n0+Rp) and produces the R = Rp*Rh
// output rows they pair into, over all d columns.  Block r of the cluster
//
//   phase 1: for its slice of the hidden axis (H/kCS units) computes
//              zh = h_rows · W1h[slice]ᵀ   (Rh x slice)  once per h row
//              zp = p_rows · W1p[slice]ᵀ   (Rp x slice)  once per p row
//              a  = gelu(zh[rh] + zp[rp] + b1)           (R x slice)
//            into its shared memory;
//   phase 2: after a cluster barrier, computes its slice of the output
//            columns (d/kCS) over the whole hidden axis, reading every
//            block's slice of `a` through distributed shared memory:
//              out[:, cols] = a · W2[cols]ᵀ + b2[cols].
//
// So each hidden unit's z is computed once per cluster, `a` never leaves
// the chip, and W1 and W2 are each read once per cluster.  Inner products
// run on 4 x 4 (phase 1) and 4 x 8 (phase 2) register tiles per thread fed
// by float4 loads from k-major shared-memory tiles, with the next tile's
// global (or remote) loads issued before the current tile is consumed.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kCS = 8;          // blocks per cluster (portable maximum)
constexpr int kThreads = 256;   // 16 x 16 threads, 4-row register tiles
constexpr int kRows = 64;       // rows a block's register tiles cover
constexpr int kHC = 64;         // hidden units per phase-1 chunk
constexpr int kKT = 16;         // depth of one staged k-tile
constexpr int kCP = 128;        // output columns per phase-2 pass
constexpr int kAS = kRows + 4;  // k-major tile strides (16-byte aligned,
constexpr int kWS = kCP + 4;    // and off the 32-bank period)
constexpr int kZS = kHC + 1;

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

__device__ __forceinline__ float gelu_tanh(float z) {
  const float k = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * z * (1.f + tanhf(k * (z + 0.044715f * z * z * z)));
}

struct Tiling {
  int rh, rp;  // rows of h and of p per cluster: rh rounded up to a
               // multiple of 4, plus rp, <= 64; and rh * rp <= 64
  int hs;      // hidden units per block: ceil(H / kCS), a multiple of kKT
};

// Floats of dynamic shared memory per block.
inline long long smem_floats(const Tiling& t) {
  return 3LL * kKT * kAS        // phase 1: A, W1h and W1p k-tiles
         + (long long)kRows * kZS  // z of one chunk
         + (long long)t.rh * t.rp * t.hs  // this block's slice of a
         + (long long)kKT * kAS   // phase 2: a k-tile
         + (long long)kKT * kWS;  // phase 2: W2 k-tile
}

// Grid: x = l-tile * kCS + rank (clusters along x), y = p-row tile, z = b.
// h: (B, L, d); p: (B, N, d); w1: (H, 2d); b1: (H); w2: (d, H); b2: (d);
// out: (B, N, L, d).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    demux_cluster_kernel(const T* __restrict__ h, const T* __restrict__ p,
                         const T* __restrict__ w1, const T* __restrict__ b1,
                         const T* __restrict__ w2, const T* __restrict__ b2,
                         T* __restrict__ out, int L, int N, int d, int H,
                         Tiling t) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int rh = t.rh, rp = t.rp, hs = t.hs;
  const int r_out = rh * rp;
  float* at = smem;                       // kKT x kAS   (k-major A tile)
  float* wht = at + kKT * kAS;            // kKT x kAS   (W1h tile)
  float* wpt = wht + kKT * kAS;           // kKT x kAS   (W1p tile)
  float* zs = wpt + kKT * kAS;            // kRows x kZS
  float* as = zs + kRows * kZS;           // r_out x hs  (this slice of a)
  float* a2 = as + r_out * hs;            // kKT x kAS   (phase-2 a tile)
  float* w2t = a2 + kKT * kAS;            // kKT x kWS   (phase-2 W2 tile)

  const int tid = threadIdx.x;
  const int rg = tid / 16, cgp = tid % 16;  // register-tile coordinates
  const int l0 = (blockIdx.x / kCS) * rh;
  const int n0 = blockIdx.y * rp;
  const long long b = blockIdx.z;
  const long long d2 = 2LL * d;
  const int hs0 = rank * hs, hs1 = min(H, hs0 + hs);

  // ---- phase 1: a[:, slice] = gelu(zh + zp + b1) ----------------------------
  // Rows of the A tile: h rows at [0, rh), zero rows up to rhp (a multiple
  // of 4, so every 4-row register tile is all-h or all-p), p rows at
  // [rhp, rhp + rp).  One k-loop over [0, d) multiplies h rows by W1h and p
  // rows by W1p.
  const int rhp = (rh + 3) / 4 * 4, rz = rhp + rp;
  const bool tile_is_h = rg * 4 < rhp, tile_live = rg * 4 < rz;
  for (int j0 = hs0; j0 < hs1; j0 += kHC) {
    float ra[4], rwh[4], rwp[4];
    // Element i of this thread's share of a k-tile: k-offset kk, row/unit x.
    auto load1 = [&](int k0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int idx = tid + kThreads * i, kk = idx % kKT, x = idx / kKT;
        const int k = k0 + kk;
        float va = 0.f;
        if (k < d) {
          if (x < rh && l0 + x < L)
            va = to_f(h[(b * L + l0 + x) * d + k]);
          else if (x >= rhp && x < rz && n0 + x - rhp < N)
            va = to_f(p[(b * N + n0 + x - rhp) * d + k]);
        }
        ra[i] = va;
        const int hj = j0 + x;
        const bool ok = hj < hs1 && k < d;
        rwh[i] = ok ? to_f(w1[hj * d2 + k]) : 0.f;
        rwp[i] = ok ? to_f(w1[hj * d2 + d + k]) : 0.f;
      }
    };
    float z[4][4] = {};
    load1(0);
    for (int k0 = 0; k0 < d; k0 += kKT) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int idx = tid + kThreads * i, kk = idx % kKT, x = idx / kKT;
        at[kk * kAS + x] = ra[i];
        wht[kk * kAS + x] = rwh[i];
        wpt[kk * kAS + x] = rwp[i];
      }
      __syncthreads();
      if (k0 + kKT < d) load1(k0 + kKT);
      if (tile_live) {
        const float* wsrc = tile_is_h ? wht : wpt;
#pragma unroll
        for (int kk = 0; kk < kKT; ++kk) {
          const float4 a4 =
              *reinterpret_cast<const float4*>(&at[kk * kAS + rg * 4]);
          const float4 w4 =
              *reinterpret_cast<const float4*>(&wsrc[kk * kAS + cgp * 4]);
          const float av[4] = {a4.x, a4.y, a4.z, a4.w};
          const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) z[i][j] += av[i] * wv[j];
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) zs[(rg * 4 + i) * kZS + cgp * 4 + j] = z[i][j];
    __syncthreads();
    for (int i = tid; i < r_out * kHC; i += kThreads) {
      const int r = i / kHC, j = i % kHC, hj = j0 + j;
      if (hj < hs1)
        as[r * hs + hj - hs0] = gelu_tanh(zs[(r % rh) * kZS + j] +
                                          zs[(rhp + r / rh) * kZS + j] +
                                          to_f(b1[hj]));
    }
    __syncthreads();
  }

  cluster.sync();  // every block's slice of `a` is complete

  // ---- phase 2: out[:, this block's columns] = a · W2ᵀ + b2 ------------------
  const int ds = (d + kCS - 1) / kCS;
  const int cs0 = rank * ds, cs1 = min(d, cs0 + ds);
  for (int c0 = cs0; c0 < cs1; c0 += kCP) {
    const int width = min(kCP, cs1 - c0);
    float ra[4], rw[8];
    auto load2 = [&](int h0) {
      const int q = h0 / hs;  // the block whose slice holds [h0, h0 + kKT)
      const float* src = cluster.map_shared_rank(as, q);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int idx = tid + kThreads * i, kk = idx % kKT, x = idx / kKT;
        ra[i] = (x < r_out && h0 + kk < H) ? src[x * hs + h0 - q * hs + kk]
                                           : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int idx = tid + kThreads * i, kk = idx % kKT, c = idx / kKT;
        rw[i] = (c < width && h0 + kk < H)
                    ? to_f(w2[(long long)(c0 + c) * H + h0 + kk])
                    : 0.f;
      }
    };
    float acc[4][8] = {};
    const bool rows_live = rg * 4 < r_out;
    load2(0);
    for (int h0 = 0; h0 < H; h0 += kKT) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int idx = tid + kThreads * i, kk = idx % kKT, x = idx / kKT;
        a2[kk * kAS + x] = ra[i];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int idx = tid + kThreads * i, kk = idx % kKT, c = idx / kKT;
        w2t[kk * kWS + c] = rw[i];
      }
      __syncthreads();
      if (h0 + kKT < H) load2(h0 + kKT);
      if (rows_live) {
#pragma unroll
        for (int kk = 0; kk < kKT; ++kk) {
          const float4 a4 =
              *reinterpret_cast<const float4*>(&a2[kk * kAS + rg * 4]);
          const float4 wa =
              *reinterpret_cast<const float4*>(&w2t[kk * kWS + cgp * 4]);
          const float4 wb =
              *reinterpret_cast<const float4*>(&w2t[kk * kWS + 64 + cgp * 4]);
          const float av[4] = {a4.x, a4.y, a4.z, a4.w};
          const float wv[8] = {wa.x, wa.y, wa.z, wa.w,
                               wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] += av[i] * wv[j];
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg * 4 + i;
      const int n = n0 + r / rh, l = l0 + r % rh;
      if (r >= r_out || n >= N || l >= L) continue;
      T* row = out + ((b * N + n) * L + l) * d;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = (j < 4 ? cgp * 4 + j : 64 + cgp * 4 + j - 4);
        if (c < width) row[c0 + c] = from_f<T>(acc[i][j] + to_f(b2[c0 + c]));
      }
    }
  }

  cluster.sync();  // no block leaves while another may still read its `a`
}

// Rows of p per cluster: as many as fit the register tiles and shared
// memory, at most `rp`.
inline bool pick_tiling(int rh, int rp, int H, long long limit, Tiling* out) {
  const int hs = ((H + kCS - 1) / kCS + kKT - 1) / kKT * kKT;
  const int rhp = (rh + 3) / 4 * 4;
  if (rp > kRows - rhp) rp = kRows - rhp;
  if (rp > kRows / rh) rp = kRows / rh;
  for (; rp >= 1; --rp) {
    Tiling t{rh, rp, hs};
    if (smem_floats(t) * 4 <= limit) {
      *out = t;
      return true;
    }
  }
  return false;
}

template <typename T>
int launch_tiles(const void* h, const void* p, const void* w1, const void* b1,
                 const void* w2, const void* b2, void* out, int B, int L,
                 int N, int d, int H, int rh, int rp, cudaStream_t stream) {
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  Tiling t;
  if (rh < 1 || rh > kRows - 4 || !pick_tiling(rh, rp, H, limit, &t))
    return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)smem_floats(t) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      demux_cluster_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((L + t.rh - 1) / t.rh) * kCS, (N + t.rp - 1) / t.rp, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, demux_cluster_kernel<T>, static_cast<const T*>(h),
      static_cast<const T*>(p), static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<const T*>(w2),
      static_cast<const T*>(b2), static_cast<T*>(out), L, N, d, H, t);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16.
inline int launch_dtype(int dtype, const void* h, const void* p,
                        const void* w1, const void* b1, const void* w2,
                        const void* b2, void* out, int B, int L, int N, int d,
                        int H, int rh, int rp, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_tiles<float>(h, p, w1, b1, w2, b2, out, B, L, N, d, H, rh,
                               rp, s);
  if (dtype == 1)
    return launch_tiles<__nv_bfloat16>(h, p, w1, b1, w2, b2, out, B, L, N, d,
                                       H, rh, rp, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
