// Index-embed demultiplexer over a hidden block of L rows:
//   out[b, n, l, :] = gelu_tanh(h[b, l]·W1h + p[b, n]·W1p + b1)·W2 + b2
// for h (B, L, d), p (B, N, d) -> out (B, N, L, d); w1 (H, 2d) holds W1h in
// its columns [0, d) and W1p in [d, 2d), w2 is (d, H).
//
// Replaces the Pallas TPU kernel `index_embed_demux` (`_demux_kernel`) in
// src/repro/kernels/demux/kernel.py.
//
// Bound on the H100: at the serving prefill (L = 1) the ~7 MB of bf16
// weights bound it; at full L the 2·d·H flops of each of the B·N·L output
// rows bound it (at the qwen1.5-4b evaluation shape, B 2 N 8 L 1024 d 2560
// H 5120: 429 GFLOP for the lane product, 54 GFLOP for h·W1h, 0.49 ms at
// the bf16 tensor-core rate).  So bf16 runs on the tensor cores, in two
// warp-specialised TMA + `wgmma` stages (hopper.cuh):
//
//   A. zh = h·W1hᵀ over the B·L rows, once, not once per lane, and
//      zp = p·W1pᵀ + b1 over the B·N rows: one GEMM kernel launched for
//      each product, f32 results in a scratch the wrapper allocates (42 MB
//      at the evaluation shape, largely L2-resident).  W1h and W1p are
//      read in place through tensor maps with w1's row stride (4d bytes).
//   B. The lane GEMM with a fused prologue: a block owns 128 output rows
//      (n, l) of one slot -- RL rows of L times NL lanes, so each zh tile
//      feeds NL lanes -- and 256 output columns.  A producer warp streams
//      zh, zp and W2 tiles (64 hidden units deep) into an mbarrier ring;
//      two consumer warpgroups form a = gelu_tanh(zh + zp) in f32 from the
//      staged tiles, round it to bf16 into a double-buffered 8 KB tile of
//      shared memory each, and issue m64n256k16 `wgmma` on it against the
//      W2 tile (w2 is already K-major for the B operand), forming the next
//      tile while those run.  f32 accumulators; b2 is added in the
//      epilogue.  The (B, N, L, H) activation never reaches device memory
//      -- the TPU kernel's defining property, kept.
//      Tried first: the activation as wgmma's A operand in registers.
//      Beside the 128 accumulator registers ptxas then serialised every
//      wgmma (warning C7512) and the lane GEMM took 1.36 ms at the
//      evaluation shape, against 1.29 ms through shared memory.
//
// Departures from the TPU kernel, bf16 only: `a` is rounded to bf16 before
// the W2 product (the TPU kernel keeps it in f32; the plain bf16 path the
// evaluation compares against materialises it in bf16, so this moves
// toward that), and tanh is `tanh.approx.f32`.  Both are far inside the
// 1e-2 x max(1, max|out|) bf16 tolerance.
//
// float32, and bf16 shapes whose strides break TMA's 16-byte rule (d or H
// not a multiple of 8), take the CUDA-core cluster body (demux_tile.cuh).
// The Python launch plan (repro_torch/kernels/demux/kernel.py: `plan`)
// chooses the body by dtype and shape before launch and gives its tiling.
#include "demux_tile.cuh"
#include "hopper.cuh"

namespace {

constexpr int kWgThreads = 384;  // consumer warpgroups 0, 1; producer 2
constexpr int kBM = 128;         // output rows per block, 64 per consumer
constexpr int kBN = 256;         // output columns per block
constexpr int kDepth = 64;       // K per stage: one 128-byte bf16 row

using bf16 = __nv_bfloat16;

// Stage A's ring: A tile 128 x 64 bf16 (16 KB), B tile 256 x 64 (32 KB).
constexpr int kGemmA = kBM * 128;
constexpr int kGemmStage = kGemmA + kBN * 128;

inline size_t gemm_smem(int stages) {
  return 1024 + (size_t)stages * kGemmStage + 2 * stages * sizeof(uint64_t);
}

// Stage B's ring: two 32-column f32 boxes each of zh (rl rows) and zp
// (nl rows), each box padded to the swizzle period, then the W2 tile.
struct LaneStage {
  int zh, zp, bytes;  // box strides and the stage's size, in bytes
  __host__ __device__ explicit LaneStage(int rl, int nl)
      : zh((rl * 128 + 1023) / 1024 * 1024),
        zp((nl * 128 + 1023) / 1024 * 1024),
        bytes(2 * zh + 2 * zp + kBN * 128) {}
};

// Activation tiles: 64 rows x 64 hidden units of bf16 per consumer,
// double-buffered.
constexpr int kActTile = 64 * 128;

inline size_t lane_smem(int rl, int nl, int stages) {
  return 1024 + (size_t)stages * LaneStage(rl, nl).bytes + 4 * kActTile +
         2 * stages * sizeof(uint64_t);
}

__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty,
                                          int stages) {
  for (int s = 0; s < stages; ++s) {
    hopper::mbar_init(full + s, 1);
    hopper::mbar_init(empty + s, 8);  // one arrival per consumer warp
  }
  hopper::fence_barrier_init();
}

// ---------------------------------------------------------------------------
// Stage A: c (M x Nc, f32) = a (M x K) · bᵀ (b: Nc x K) [+ bias], bf16 in
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kWgThreads, 1) demux_gemm_kernel(
    const __grid_constant__ CUtensorMap ma,
    const __grid_constant__ CUtensorMap mb, const bf16* __restrict__ bias,
    float* __restrict__ c, int M, int Nc, int K, int stages) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * kGemmStage);
  uint64_t* empty = full + stages;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int n_k = (K + kDepth - 1) / kDepth;

  if (threadIdx.x == 0) init_ring(full, empty, stages);
  __syncthreads();

  if (wg == 2) {
    setmaxnreg_dec<24>();
    if (tid == 0) {
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = kt % stages;
        mbar_wait(empty + s, ((kt / stages) & 1) ^ 1);
        mbar_arrive_expect_tx(full + s, kGemmStage);
        uint8_t* st = ring + s * kGemmStage;
        tma_load_2d(st, &ma, full + s, kt * kDepth, m0);
        tma_load_2d(st + kGemmA, &mb, full + s, kt * kDepth, n0);
      }
    }
  } else {
    setmaxnreg_inc<240>();
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    float acc[128];
    for (int kt = 0; kt < n_k; ++kt) {
      const int s = kt % stages;
      const uint8_t* st = ring + s * kGemmStage;
      mbar_wait(full + s, (kt / stages) & 1);
      wgmma_fence();
      const uint64_t ad = opaque(smem_desc(st + wg * 64 * 128, 0, 1024));
      const uint64_t bd = opaque(smem_desc(st + kGemmA, 0, 1024));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_n256(acc, desc_add(ad, kk * 32), desc_add(bd, kk * 32),
                      kt > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's wgmmas have retired
      if (kt > 0 && lane == 0) mbar_arrive(empty + (kt - 1) % stages);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(empty + (n_k - 1) % stages);
    // acc n8-tile j: columns n0 + 8 j + 2 t, +1 of rows `row` (0, 1) and
    // `row + 8` (2, 3).
    const int row = m0 + wg * 64 + warp * 16 + g;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      if (col >= Nc) continue;
      float2 bv = make_float2(0.f, 0.f);
      if (bias)
        bv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(bias + col));
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = row + 8 * i;
        if (r < M)
          *reinterpret_cast<float2*>(c + (size_t)r * Nc + col) =
              make_float2(acc[4 * j + 2 * i] + bv.x,
                          acc[4 * j + 2 * i + 1] + bv.y);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Stage B: out = gelu_tanh(zh + zp) · W2ᵀ + b2, the activation in registers
// ---------------------------------------------------------------------------

// grid: x = 256-column tile, y = group of nl lanes, z = b * n_lt + L-tile.
__global__ void __launch_bounds__(kWgThreads, 1) demux_lane_kernel(
    const __grid_constant__ CUtensorMap mzh,
    const __grid_constant__ CUtensorMap mzp,
    const __grid_constant__ CUtensorMap mw2, const bf16* __restrict__ b2,
    bf16* __restrict__ out, int L, int N, int d, int H, int rl, int nl,
    int n_lt, int stages) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  const LaneStage ls(rl, nl);
  uint8_t* ring = align1024(smem_raw);
  uint8_t* act = ring + stages * ls.bytes;  // 2 activation tiles each
  uint64_t* full = reinterpret_cast<uint64_t*>(act + 4 * kActTile);
  uint64_t* empty = full + stages;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int c0 = blockIdx.x * kBN, n0 = blockIdx.y * nl;
  const int b = blockIdx.z / n_lt, l0 = (blockIdx.z % n_lt) * rl;
  const int n_k = (H + kDepth - 1) / kDepth;
  const int w2_off = 2 * ls.zh + 2 * ls.zp;

  if (threadIdx.x == 0) init_ring(full, empty, stages);
  __syncthreads();

  if (wg == 2) {
    setmaxnreg_dec<24>();
    if (tid == 0) {
      const uint32_t tx = 2 * 128 * (rl + nl) + kBN * 128;
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = kt % stages, k = kt * kDepth;
        mbar_wait(empty + s, ((kt / stages) & 1) ^ 1);
        mbar_arrive_expect_tx(full + s, tx);
        uint8_t* st = ring + s * ls.bytes;
        tma_load_2d(st, &mzh, full + s, k, b * L + l0);
        tma_load_2d(st + ls.zh, &mzh, full + s, k + 32, b * L + l0);
        tma_load_2d(st + 2 * ls.zh, &mzp, full + s, k, b * N + n0);
        tma_load_2d(st + 2 * ls.zh + ls.zp, &mzp, full + s, k + 32,
                    b * N + n0);
        tma_load_2d(st + w2_off, &mw2, full + s, k, c0);
      }
    }
  } else {
    setmaxnreg_inc<240>();
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    // This thread's two output rows of the block: row x is lane x / rl,
    // L-row x % rl of the tile.  Rows past rl * nl are computed on a
    // clamped zp row and never stored.
    const int ra = wg * 64 + warp * 16 + g, rb = ra + 8;
    const int la = ra % rl, na = ra / rl, lb = rb % rl, nb = rb / rl;
    const int pa = min(na, nl - 1), pb = min(nb, nl - 1);
    float acc[128];
    // The stage's activation tile a = gelu(zh + zp), 64 rows x 64 hidden
    // units, goes to shared memory (K-major, the 128-byte swizzle: wgmma's
    // A operand) and the wgmmas read it there, so the next stage's tile is
    // formed while they run.  Thread (g, t) forms rows ra, rb at hidden
    // units 16 kk + 2 t (+1) and 16 kk + 8 + 2 t (+1), k-step kk.
    const int named = 3 + wg;      // this warpgroup's barrier
    const int wr = warp * 16 + g;  // row of ra in the warpgroup's tile
    for (int kt = 0; kt < n_k; ++kt) {
      const int s = kt % stages;
      const uint8_t* st = ring + s * ls.bytes;
      uint8_t* at = act + (wg * 2 + (kt & 1)) * kActTile;
      mbar_wait(full + s, (kt / stages) & 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint8_t* zh = st + (kk / 2) * ls.zh;  // 32-column boxes
        const uint8_t* zp = st + 2 * ls.zh + (kk / 2) * ls.zp;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool first = (i % 2) == 0;  // row ra, else rb
          const int col = (kk % 2) * 16 + 2 * t + (i / 2) * 8;
          const float2 x = ld_swizzled(zh, first ? la : lb, col);
          const float2 y = ld_swizzled(zp, first ? pa : pb, col);
          const int row = wr + (first ? 0 : 8);
          const int chunk = kk * 2 + i / 2;  // 16-byte chunk of the row
          *reinterpret_cast<uint32_t*>(
              at + row * 128 + ((chunk ^ (row & 7)) << 4) + 4 * t) =
              pack_bf16(gelu_tanh_approx(x.x + y.x),
                        gelu_tanh_approx(x.y + y.y));
        }
      }
      fence_async_shared();
      named_bar_sync(named, 128);  // the whole tile is written
      wgmma_fence();
      const uint64_t ad = opaque(smem_desc(at, 0, 1024));
      const uint64_t wd = opaque(smem_desc(st + w2_off, 0, 1024));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_n256(acc, desc_add(ad, kk * 32), desc_add(wd, kk * 32),
                      kt > 0 || kk > 0);
      wgmma_commit();
      // The previous stage's wgmmas have retired: its ring slot and its
      // activation buffer (the one the next stage writes) are free.
      wgmma_wait<1>();
      if (kt > 0 && lane == 0) mbar_arrive(empty + (kt - 1) % stages);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(empty + (n_k - 1) % stages);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int n = n0 + (i ? nb : na), l = l0 + (i ? lb : la);
      if (n >= N || l >= L || (i ? nb : na) >= nl) continue;
      bf16* row = out + (((size_t)b * N + n) * L + l) * d;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int col = c0 + 8 * j + 2 * t;
        if (col >= d) continue;
        const float2 bv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(b2 + col));
        *reinterpret_cast<uint32_t*>(row + col) = pack_bf16(
            acc[4 * j + 2 * i] + bv.x, acc[4 * j + 2 * i + 1] + bv.y);
      }
    }
  }
}

int launch_gemm(const void* a, const void* b, const void* bias, float* c,
                int M, int Nc, int K, int ldb, int stages,
                cudaStream_t stream) {
  constexpr auto kBf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap ma, mb;
  int err = hopper::map_2d(&ma, kBf16, 2, a, M, K, K, kBM, kDepth);
  if (!err)
    err = hopper::map_2d(&mb, kBf16, 2, b, Nc, K, ldb, kBN, kDepth);
  if (err) return err;
  const size_t smem = gemm_smem(stages);
  cudaError_t e = cudaFuncSetAttribute(
      demux_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Nc + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  demux_gemm_kernel<<<grid, kWgThreads, smem, stream>>>(
      ma, mb, static_cast<const bf16*>(bias), c, M, Nc, K, stages);
  return (int)cudaGetLastError();
}

int launch_wgmma(const void* h, const void* p, const void* w1, const void* b1,
                 const void* w2, const void* b2, void* out, float* zh,
                 float* zp, int B, int L, int N, int d, int H, int rl, int nl,
                 int stages_a, int stages_b, cudaStream_t stream) {
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (rl < 1 || nl < 1 || rl * nl > kBM || rl > 256 || nl > 256 ||
      stages_a < 1 || stages_b < 1 || gemm_smem(stages_a) > (size_t)limit ||
      lane_smem(rl, nl, stages_b) > (size_t)limit)
    return (int)cudaErrorInvalidValue;
  const bf16* w1h = static_cast<const bf16*>(w1);
  int err = launch_gemm(h, w1h, nullptr, zh, B * L, H, d, 2 * d, stages_a,
                        stream);
  if (!err)
    err = launch_gemm(p, w1h + d, b1, zp, B * N, H, d, 2 * d, stages_a,
                      stream);
  if (err) return err;

  constexpr auto kF32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap mzh, mzp, mw2;
  err = hopper::map_2d(&mzh, kF32, 4, zh, (long long)B * L, H, H, rl, 32);
  if (!err)
    err = hopper::map_2d(&mzp, kF32, 4, zp, (long long)B * N, H, H, nl, 32);
  if (!err)
    err = hopper::map_2d(&mw2, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w2, d,
                         H, H, kBN, kDepth);
  if (err) return err;
  const size_t smem = lane_smem(rl, nl, stages_b);
  cudaError_t e = cudaFuncSetAttribute(
      demux_lane_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int n_lt = (L + rl - 1) / rl;
  const dim3 grid((d + kBN - 1) / kBN, (N + nl - 1) / nl, B * n_lt);
  demux_lane_kernel<<<grid, kWgThreads, smem, stream>>>(
      mzh, mzp, mw2, static_cast<const bf16*>(b2), static_cast<bf16*>(out),
      L, N, d, H, rl, nl, n_lt, stages_b);
  return (int)cudaGetLastError();
}

}  // namespace

// body 0: the CUDA-core cluster body (demux_tile.cuh) with rh = rl L-rows
// and up to rp = nl lanes per cluster, float32 or bf16; body 1: the bf16
// TMA + wgmma stages, with rl L-rows x nl lanes per block and the two
// rings' depths, zh (B·L, H) and zp (B·N, H) float32 scratch.  The plan
// comes from Python; a plan this body cannot run is refused
// (cudaErrorInvalidValue), never replaced.  Returns a cudaError_t.
extern "C" int index_embed_demux_launch(
    const void* h, const void* p, const void* w1, const void* b1,
    const void* w2, const void* b2, void* out, void* zh, void* zp, int dtype,
    int B, int L, int N, int d, int H, int body, int rl, int nl, int stages_a,
    int stages_b, void* stream) {
  if (body == 0)
    return launch_dtype(dtype, h, p, w1, b1, w2, b2, out, B, L, N, d, H, rl,
                        nl, stream);
  if (body == 1 && dtype == 1 && d % 8 == 0 && H % 8 == 0)
    return launch_wgmma(h, p, w1, b1, w2, b2, out, static_cast<float*>(zh),
                        static_cast<float*>(zp), B, L, N, d, H, rl, nl,
                        stages_a, stages_b, static_cast<cudaStream_t>(stream));
  return (int)cudaErrorInvalidValue;
}
