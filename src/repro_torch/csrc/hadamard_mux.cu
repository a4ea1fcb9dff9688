// Hadamard multiplexer: out[b, l, :] = (1/N) * sum_n x[b, n, l, :] * v[n, :]
//
// Replaces the Pallas TPU kernel `hadamard_mux` (`_mux_kernel`) in
// src/repro/kernels/multiplex/kernel.py.
//
// Bound on the H100: memory.  The kernel reads B*N*L*d elements of x once
// and writes B*L*d; it does 2 flops per element read, far below the card's
// ~295 flops per byte balance point.
//
// Design: one thread per output vector of VEC contiguous elements (16-byte
// loads: 8 bf16 or 4 f32 values when d allows it, else one element), a loop
// over N accumulating in float32, and one division by N at the end (as the
// TPU kernel does).  Neighbouring threads read neighbouring addresses, so
// every load of x is coalesced and the (B, N, L, d) product is never
// written.  v is N*d elements and stays in L1/L2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

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

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(T (&dst)[VEC], const T* src) {
  if constexpr (sizeof(T) * VEC == 16) {
    *reinterpret_cast<uint4*>(dst) = __ldg(reinterpret_cast<const uint4*>(src));
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) dst[e] = src[e];
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* dst, const T (&src)[VEC]) {
  if constexpr (sizeof(T) * VEC == 16) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) dst[e] = src[e];
  }
}

// x: (B, N, L, d); v: (N, d); out: (B, L, d).  Thread g owns elements
// [c, c + VEC) of output row `row` = b * L + l.
template <typename T, int VEC>
__global__ void hadamard_mux_kernel(const T* __restrict__ x,
                                    const T* __restrict__ v,
                                    T* __restrict__ out, int n, long long rows,
                                    int l, int d) {
  const int dv = d / VEC;
  const long long g = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (g >= rows * dv) return;
  const int c = (int)(g % dv) * VEC;
  const long long row = g / dv;
  const long long b = row / l, li = row % l;
  const long long nstride = (long long)l * d;
  const T* xp = x + (b * n * l + li) * d + c;  // x[b, 0, li, c]

  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
  for (int i = 0; i < n; ++i) {
    alignas(16) T xv[VEC];
    alignas(16) T vv[VEC];
    load_vec<T, VEC>(xv, xp + i * nstride);
    load_vec<T, VEC>(vv, v + (long long)i * d + c);
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] += to_f(xv[e]) * to_f(vv[e]);
  }
  alignas(16) T o[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) o[e] = from_f<T>(acc[e] / n);
  store_vec<T, VEC>(out + row * d + c, o);
}

template <typename T>
int launch(const void* x, const void* v, void* out, long long b, int n, int l,
           int d, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = d % kVec == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long rows = b * l;
  const int threads = 256;
  const long long work = rows * (vec ? d / kVec : d);
  const unsigned blocks = (unsigned)((work + threads - 1) / threads);
  const T* xp = static_cast<const T*>(x);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(out);
  if (vec) {
    hadamard_mux_kernel<T, kVec><<<blocks, threads, 0, stream>>>(
        xp, vp, op, n, rows, l, d);
  } else {
    hadamard_mux_kernel<T, 1><<<blocks, threads, 0, stream>>>(
        xp, vp, op, n, rows, l, d);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch.
extern "C" int hadamard_mux_launch(const void* x, const void* v, void* out,
                                   int dtype, long long b, int n, int l, int d,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, v, out, b, n, l, d, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, v, out, b, n, l, d, s);
  return (int)cudaErrorInvalidValue;
}
