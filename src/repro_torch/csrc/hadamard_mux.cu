// Hadamard multiplexer: out[b, l, :] = (1/N) * sum_n x[b, n, l, :] * v[n, :]
//
// Replaces the Pallas TPU kernel `hadamard_mux` (`_mux_kernel`) in
// src/repro/kernels/multiplex/kernel.py.
//
// Bound on the H100: memory.  The kernel reads B*N*L*d elements of x once
// and writes B*L*d; it does 2 flops per element read, far below the card's
// ~295 flops per byte balance point.  At the decode shape (B 8, N 40, L 1,
// d 768, bf16) the 0.5 MB read is 0.15 us of bandwidth, so the time is
// latency: how many round trips to memory a thread waits for, and on how
// many SMs.  The first version (one thread per output vector, a serial
// loop over N) had 3 blocks of 256 threads there, each thread waiting on
// 40 loads in turn.
//
// Design.  A thread owns one output vector of VEC contiguous elements (16
// bytes: 8 bf16 or 4 f32 values when d and the pointers allow it, else one
// element) and one of `slots` instance slots: thread (s, c) of a block
// sums the instances n = s, s + slots, ... of vector c, kUnroll loads in
// flight at a time.  Neighbouring threads read neighbouring vectors, so
// every load is coalesced, and the (B, N, L, d) product is never written.
// With one slot (the streaming form, for large B*L) the thread stores its
// vector; with more, the slots' f32 partials are summed by shuffles within
// a warp, then through shared memory across warps, and divided by N once,
// as the TPU kernel does.  The Python plan (repro_torch/
// kernels/multiplex/kernel.py: `plan`) picks slots and block width so that
// a small B*L still fills the card: at the decode shape 32 slots of 4
// vectors, 192 blocks of 128 threads, each thread one or two loads deep.
// v is N*d elements and stays in L1/L2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kUnroll = 4;       // loads of x in flight per thread
constexpr int kMaxThreads = 256;
constexpr int kMaxSlots = 32;

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

// What a thread loads for one instance: a 16-byte chunk (VEC = 16 / size
// elements) held as uint4, or one element.
template <typename T, int VEC>
using Raw = std::conditional_t<sizeof(T) * VEC == 16, uint4, T>;

template <typename T, int VEC>
__device__ __forceinline__ Raw<T, VEC> load_raw(const T* p) {
  if constexpr (sizeof(T) * VEC == 16)
    return __ldg(reinterpret_cast<const uint4*>(p));
  else
    return *p;
}

// The VEC values of a chunk as floats.
template <typename T, int VEC>
__device__ __forceinline__ void unpack(const Raw<T, VEC>& r,
                                       float (&f)[VEC]) {
  if constexpr (sizeof(T) * VEC != 16) {
    f[0] = to_f(r);
  } else if constexpr (sizeof(T) == 4) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  } else {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = __bfloat1622float2(h[i]);
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const float (&f)[VEC], float n) {
  if constexpr (sizeof(T) * VEC != 16) {
    *p = from_f<T>(f[0] / n);
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) =
        make_float4(f[0] / n, f[1] / n, f[2] / n, f[3] / n);
  } else {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(f[2 * i] / n, f[2 * i + 1] / n);
    *reinterpret_cast<uint4*>(p) = u;
  }
}

// x: (B, N, L, d); v: (N, d); out: (B, L, d).  Output vectors are numbered
// flat over (B*L rows) x (dv = d / VEC vectors per row), fewer than 2^31
// (the plan's rule); block `blockIdx.x` owns vectors [blockIdx.x * cv,
// blockIdx.x * cv + cv).  blockDim.x = cv * slots; dynamic shared memory
// slots * cv * VEC floats when slots > 1.
template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads) hadamard_mux_kernel(
    const T* __restrict__ x, const T* __restrict__ v, T* __restrict__ out,
    int n, int total, int dv, int l, int d, int cv, int slots) {
  extern __shared__ float part[];
  const int c = threadIdx.x % cv, s = threadIdx.x / cv;
  const int f = blockIdx.x * cv + c;
  const bool live = f < total;
  const int row = live ? f / dv : 0;
  const int col = (live ? f - row * dv : 0) * VEC;
  const int bi = row / l, li = row - bi * l;
  const T* xp = x + ((size_t)bi * n * l + li) * d + col;  // x[b, 0, l]
  const T* vp = v + col;
  const size_t nstride = (size_t)l * d;

  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
  if (live) {
    for (int n0 = s; n0 < n; n0 += kUnroll * slots) {
      Raw<T, VEC> xr[kUnroll] = {}, vr[kUnroll] = {};
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = n0 + u * slots;
        if (i < n) {
          xr[u] = load_raw<T, VEC>(xp + i * nstride);
          vr[u] = load_raw<T, VEC>(vp + (size_t)i * d);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (n0 + u * slots < n) {
          float xf[VEC], vf[VEC];
          unpack<T, VEC>(xr[u], xf);
          unpack<T, VEC>(vr[u], vf);
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[e] = fmaf(xf[e], vf[e], acc[e]);
        }
      }
    }
  }
  if (slots == 1) {
    if (live) store<T, VEC>(out + (size_t)row * d + col, acc, (float)n);
    return;
  }
  // Slots that share a warp (cv < 32: lanes c, c + cv, ...) first sum by
  // shuffles, leaving one partial per warp; with cv >= 32 a warp holds one
  // slot.  The K partials of each output element then meet in shared
  // memory, part[k * E + c * VEC + e].
  int K = slots, k = s;
  bool writer = true;
  if (cv < 32) {
    for (int o = cv; o < 32; o <<= 1) {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        acc[e] += __shfl_xor_sync(~0u, acc[e], o);
    }
    K = blockDim.x / 32;
    k = threadIdx.x / 32;
    writer = threadIdx.x % 32 < cv;
  }
  const int E = cv * VEC;
  if (writer) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) part[k * E + c * VEC + e] = acc[e];
  }
  __syncthreads();
  // P threads (adjacent lanes) per output element, each summing every P-th
  // partial; E * P is a multiple of the block, so the loop is
  // block-uniform and every lane takes part in the shuffles.
  const int P = max(1, (int)blockDim.x / E);
  for (int i = threadIdx.x; i < E * P; i += blockDim.x) {
    const int ei = i / P, p = i % P;
    float sum = 0.f;
    for (int k2 = p; k2 < K; k2 += P) sum += part[k2 * E + ei];
    for (int o = P / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(~0u, sum, o);
    const int fo = blockIdx.x * cv + ei / VEC;
    if (p == 0 && fo < total) {
      const int r = fo / dv;
      out[(size_t)r * d + (fo - r * dv) * VEC + ei % VEC] =
          from_f<T>(sum / n);
    }
  }
}

template <typename T, int VEC>
int launch_vec(const void* x, const void* v, void* out, long long b, int n,
               int l, int d, int cv, int slots, long long blocks,
               cudaStream_t stream) {
  const long long total = b * l * (d / VEC);
  const int threads = cv * slots;
  const size_t smem = slots > 1 ? (size_t)threads * VEC * sizeof(float) : 0;
  if (total >= (1LL << 31) || blocks != (total + cv - 1) / cv)
    return (int)cudaErrorInvalidValue;
  hadamard_mux_kernel<T, VEC><<<(unsigned)blocks, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(v), static_cast<T*>(out),
      n, (int)total, d / VEC, l, d, cv, slots);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* v, void* out, long long b, int n, int l,
           int d, int vec, int cv, int slots, long long blocks,
           cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned = (reinterpret_cast<uintptr_t>(x) |
                        reinterpret_cast<uintptr_t>(v) |
                        reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  // The plan's shape: cv and slots powers of two, a block of at most
  // kMaxThreads, at most kMaxSlots slots and one per instance at most.
  const int threads = cv * slots;
  if (b < 1 || n < 1 || l < 1 || d < 1 || cv < 1 || slots < 1 ||
      (cv & (cv - 1)) || (slots & (slots - 1)) || threads > kMaxThreads ||
      threads < 32 || slots > n || slots > kMaxSlots || blocks < 1)
    return (int)cudaErrorInvalidValue;
  if (vec == kVec && d % kVec == 0 && aligned)
    return launch_vec<T, kVec>(x, v, out, b, n, l, d, cv, slots, blocks,
                               stream);
  if (vec == 1)
    return launch_vec<T, 1>(x, v, out, b, n, l, d, cv, slots, blocks, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; vec, cv, slots and blocks are the
// Python plan's (elements per thread's vector, output vectors per block,
// instance slots per block, blocks), refused unless consistent.  Returns
// the cudaError_t of the launch.
extern "C" int hadamard_mux_launch(const void* x, const void* v, void* out,
                                   int dtype, long long b, int n, int l, int d,
                                   int vec, int cv, int slots,
                                   long long blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, v, out, b, n, l, d, vec, cv, slots, blocks, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, v, out, b, n, l, d, vec, cv, slots,
                                 blocks, s);
  return (int)cudaErrorInvalidValue;
}
