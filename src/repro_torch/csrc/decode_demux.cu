// Fused decode-epilogue demultiplexer over a decode block of C rows:
//   out[b, n, c, :] = gelu_tanh(h[b, c]·W1h + p[b, n]·W1p + b1)·W2 + b2
// for h (B, C, d), p (B, N, d) -> out (B, N, C, d); w1 (H, 2d) holds W1h in
// its columns [0, d) and W1p in [d, 2d), w2 is (d, H).
//
// Replaces the Pallas TPU kernel `decode_demux` (`_decode_demux_kernel`) in
// src/repro/kernels/demux/kernel.py.
//
// Bound on the H100: at decode (B 8, N 40, C 1, d 768, H 1536, bf16) the
// function reads ~7 MB of weights for ~1.5 GFLOP, so the bytes bound it
// (2.4 us at 3.35 TB/s); the three products are GEMMs with few rows --
// zh = h·W1hᵀ over B·C = 8 rows, zp = p·W1pᵀ + b1 over B·N = 320 rows, and
// the lane product over M = B·N·C = 320 flat rows -- so what matters is
// spreading the weight stream over the SMs and keeping the tensor cores
// fed from it, not the flops.
//
// Design, bf16 (two launches, TMA + `wgmma`, helpers in hopper.cuh):
//
//   A. `decode_gemm_kernel`: zh and zp in one launch, f32 into scratch the
//      wrapper allocates.  A block owns 64 rows x 96 hidden columns (one
//      consumer warpgroup, m64n96k16, and a producer warp streaming 64-deep
//      A and W1 tiles through a 4-stage mbarrier ring); blockIdx.y below
//      ceil(B·C / 64) takes zh, the rest zp (+ b1).  Narrow column tiles
//      are what fill the card: at the slice 16 x (1 + 5) = 96 blocks, one
//      wave, where the index-embed demux's 256-column tiles would give
//      6 + 18.  (64-column tiles -- 144 blocks, 12 SMs running two --,
//      128-column tiles and 128-row tiles shared by two consumers all
//      measured slower at the slice.)  So zh is computed once per (slot,
//      row) and zp once per (slot, lane), never once per lane x row -- the
//      TPU kernel's defining property.
//   B. `decode_lane_kernel`: the lane GEMM over flat output rows
//      r = (b·N + n)·C + c, which is exactly out's row order.  A tile is 64
//      flat rows (tiles span slot boundaries: 320 rows are 5 tiles) by 256
//      output columns, and its hidden axis is split over a cluster of S
//      blocks (S = 8 at the slice: 5 x 3 x 8 = 120 blocks, 3 hidden steps
//      each; S = 2 at C = 4: 20 x 3 x 2).  A tile's rows need a contiguous
//      run of zh rows (the slots it spans, all C each) and of zp rows
//      (r / C); the plan sizes those boxes.  A producer warp streams the
//      zh, zp (f32) and W2 (bf16, 256 x 64) tiles of 64 hidden units per
//      stage; the two consumer warpgroups form the activation tile
//      a = gelu_tanh(zh + zp) together (32 hidden units each), in f32,
//      rounded to bf16 into one of three 8 KB shared tiles (K-major,
//      128-byte swizzle), and each issues m64n128k16 `wgmma` on it against
//      its half of the W2 tile.  The blocks' f32 partials meet in shared
//      memory: after a cluster barrier each block sums a share of the tile
//      over the S partials through distributed shared memory, in rank
//      order (deterministic), adds b2 once and writes bf16.  The (B, N, C,
//      H) activation never reaches device memory; W2 (2.4 MB) stays in L2
//      across row tiles.  Wide column tiles keep the gelu prologue, which
//      is recomputed for every column tile, at 3 evaluations per
//      activation; the split keeps >= 100 SMs busy.  The lane GEMM is a
//      programmatic dependent launch: its blocks start while the zh / zp
//      GEMM finishes and request their first W2 tiles, and only the
//      producer waits for the GEMM's writes before loading zh and zp.
//
// Departures from the TPU kernel, bf16 only: the activation is rounded to
// bf16 as wgmma's A operand (the TPU kernel keeps it in f32; the plain bf16
// path materialises it in bf16, so this moves toward that), and tanh is
// `tanh.approx.f32`.  Both stay far inside the 1e-2 x max(1, max|out|)
// bf16 tolerance.
//
// float32, and bf16 shapes whose strides break TMA's 16-byte rule (d or H
// not a multiple of 8), keep the CUDA-core cluster body (demux_tile.cuh)
// unchanged.  The Python launch plan (repro_torch/kernels/demux/kernel.py:
// `decode_plan`) chooses the body before launch and sizes the boxes and
// rings; a plan this file cannot run is refused, never replaced.
//
// Tried before: the cluster body for bf16 too, 0.4502 ms at the slice (8
// clusters of 8 blocks on 132 SMs, f32 FMAs from scalar bf16 loads, each
// cluster streaming all 7 MB of weights); the index-embed demux's wgmma
// body, whose lane tiles hold one slot's lanes x rows, puts 40 real rows in
// each 128-row tile at C = 1 (0.0812 ms for the same function at L = 1);
// 64 x 64 lane tiles without a split (60 blocks, 24 hidden steps each, the
// two consumers taking alternate steps) were slower than the plain version,
// most of the time in the gelu prologue recomputed for each of 12 column
// tiles.
#include "demux_tile.cuh"  // also brings cooperative_groups as cg
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;   // rows, columns and hidden depth of a tile
constexpr int kBox = kTile * 128;  // a 64-row tile of 128-byte rows: 8 KB

// ---------------------------------------------------------------------------
// Stage A: zh = h·W1hᵀ and zp = p·W1pᵀ + b1, f32, one launch
// ---------------------------------------------------------------------------

constexpr int kGemmThreads = 160;  // consumer warpgroup + producer warp
constexpr int kGemmCols = 96;      // hidden units per block
constexpr int kGemmStage = kBox + kGemmCols * 128;  // A tile, W1 tile

inline size_t gemm_smem(int stages) {
  return 1024 + (size_t)stages * kGemmStage + 2 * stages * sizeof(uint64_t);
}

__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty,
                                          int stages, int consumers) {
  for (int s = 0; s < stages; ++s) {
    hopper::mbar_init(full + s, 1);
    hopper::mbar_init(empty + s, consumers);  // one arrival per warp
  }
  hopper::fence_barrier_init();
}

// grid: x = 96-column tile of H; y < tiles_h: 64-row tile of zh (h rows),
// else of zp (p rows).
__global__ void __launch_bounds__(kGemmThreads) decode_gemm_kernel(
    const __grid_constant__ CUtensorMap mh,
    const __grid_constant__ CUtensorMap mw1h,
    const __grid_constant__ CUtensorMap mp,
    const __grid_constant__ CUtensorMap mw1p, const bf16* __restrict__ b1,
    float* __restrict__ zh, float* __restrict__ zp, int rows_h, int rows_p,
    int H, int d, int tiles_h, int stages) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * kGemmStage);
  uint64_t* empty = full + stages;
  const bool is_h = blockIdx.y < tiles_h;
  const int m0 = (is_h ? blockIdx.y : blockIdx.y - tiles_h) * kTile;
  const int n0 = blockIdx.x * kGemmCols;
  const int n_k = (d + kTile - 1) / kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) init_ring(full, empty, stages, 4);
  __syncthreads();
  launch_dependents();  // the lane GEMM may start its W2 loads

  if (warp == 4) {  // producer
    if (lane == 0) {
      const CUtensorMap* ma = is_h ? &mh : &mp;
      const CUtensorMap* mb = is_h ? &mw1h : &mw1p;
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = kt % stages;
        mbar_wait(empty + s, ((kt / stages) & 1) ^ 1);
        mbar_arrive_expect_tx(full + s, kGemmStage);
        uint8_t* st = ring + s * kGemmStage;
        tma_load_2d(st, ma, full + s, kt * kTile, m0);
        tma_load_2d(st + kBox, mb, full + s, kt * kTile, n0);
      }
    }
    return;
  }
  const int g = lane / 4, t = lane % 4;
  float acc[kGemmCols / 2];
  for (int kt = 0; kt < n_k; ++kt) {
    const int s = kt % stages;
    const uint8_t* st = ring + s * kGemmStage;
    mbar_wait(full + s, (kt / stages) & 1);
    wgmma_fence();
    const uint64_t ad = opaque(smem_desc(st, 0, 1024));
    const uint64_t bd = opaque(smem_desc(st + kBox, 0, 1024));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_n96(acc, desc_add(ad, kk * 32), desc_add(bd, kk * 32),
                   kt > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's wgmmas have retired
    if (kt > 0 && lane == 0) mbar_arrive(empty + (kt - 1) % stages);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  // acc n8-tile j: columns n0 + 8 j + 2 t, +1 of rows `row` (0, 1) and
  // `row + 8` (2, 3).
  float* c = is_h ? zh : zp;
  const int M = is_h ? rows_h : rows_p;
  const int row = m0 + warp * 16 + g;
#pragma unroll
  for (int j = 0; j < kGemmCols / 8; ++j) {
    const int col = n0 + 8 * j + 2 * t;
    if (col >= H) continue;
    float2 bv = make_float2(0.f, 0.f);
    if (!is_h)
      bv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(b1 + col));
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row + 8 * i;
      if (r < M)
        *reinterpret_cast<float2*>(c + (size_t)r * H + col) = make_float2(
            acc[4 * j + 2 * i] + bv.x, acc[4 * j + 2 * i + 1] + bv.y);
    }
  }
}

// ---------------------------------------------------------------------------
// Stage B: out = gelu_tanh(zh + zp) · W2ᵀ + b2 over flat rows, split over H
// ---------------------------------------------------------------------------

constexpr int kLaneThreads = 288;  // consumer warpgroups 0, 1; producer warp
constexpr int kLaneCols = 256;     // output columns, 128 per consumer
constexpr int kW2Box = kLaneCols * 128;  // W2 tile: 256 rows x 64 hidden
constexpr int kActBufs = 3;        // activation tiles in flight
constexpr int kRedPitch = kLaneCols + 4;  // floats per row of the partial
constexpr int kRedBytes = kTile * kRedPitch * 4;

// One stage: two 32-column f32 boxes each of zh (zh_rows rows) and zp
// (zp_rows rows), each box padded to the swizzle period, then the W2 tile.
struct LaneStage {
  int zh, zp, bytes;  // box strides and the stage's size, in bytes
  __host__ __device__ LaneStage(int zh_rows, int zp_rows)
      : zh((zh_rows * 128 + 1023) / 1024 * 1024),
        zp((zp_rows * 128 + 1023) / 1024 * 1024),
        bytes(2 * zh + 2 * zp + kW2Box) {}
};

// The ring, which the block's f32 partial reuses once it is drained, then
// the activation tiles and the barriers.
__host__ __device__ inline int ring_bytes(const LaneStage& ls, int stages) {
  const int ring = stages * ls.bytes;
  return ring > kRedBytes ? ring : kRedBytes;
}
inline size_t lane_smem(int zh_rows, int zp_rows, int stages) {
  return 1024 + (size_t)ring_bytes(LaneStage(zh_rows, zp_rows), stages) +
         kActBufs * kBox + 2 * stages * sizeof(uint64_t);
}

// grid: x = split of the hidden axis (a cluster of gridDim.x blocks),
// y = 256-column tile of d, z = 64-row tile of the M = B·N·C flat rows.
// Split x takes hidden steps [x k_per, x k_per + k_per) of 64 units; the
// cluster sums its blocks' partials through distributed shared memory.
// Tile z stages zh rows from (r0 / (N·C))·C and zp rows from r0 / C.
__global__ void __launch_bounds__(kLaneThreads, 1) decode_lane_kernel(
    const __grid_constant__ CUtensorMap mzh,
    const __grid_constant__ CUtensorMap mzp,
    const __grid_constant__ CUtensorMap mw2, const bf16* __restrict__ b2,
    bf16* __restrict__ out, int M, int N, int C, int d, int H, int zh_rows,
    int zp_rows, int stages, int k_per) {
  using namespace hopper;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ uint8_t smem_raw[];
  const LaneStage ls(zh_rows, zp_rows);
  uint8_t* ring = align1024(smem_raw);
  uint8_t* act = ring + ring_bytes(ls, stages);
  uint64_t* full = reinterpret_cast<uint64_t*>(act + kActBufs * kBox);
  uint64_t* empty = full + stages;
  float* red = reinterpret_cast<float*>(ring);  // after the main loop
  const int split = blockIdx.x, S = gridDim.x;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int c0 = blockIdx.y * kLaneCols, r0 = blockIdx.z * kTile;
  const int nc = N * C;
  const int zh0 = (r0 / nc) * C, zp0 = r0 / C;
  const int n_k = (H + kTile - 1) / kTile;
  const int kt0 = split * k_per;
  const int n_loc = min(k_per, n_k - kt0);  // >= 1 (the plan's rule)
  const int w2_off = 2 * ls.zh + 2 * ls.zp;

  if (threadIdx.x == 0) init_ring(full, empty, stages, 8);
  __syncthreads();

  if (wg == 2) {  // producer
    if (tid == 0) {
      // The first stages' W2 tiles do not depend on the zh / zp GEMM: they
      // are requested before waiting for it to complete.
      const uint32_t tx = 2 * 128 * (zh_rows + zp_rows) + kW2Box;
      const int early = min(stages, n_loc);
      for (int i = 0; i < early; ++i) {
        mbar_arrive_expect_tx(full + i, tx);
        tma_load_2d(ring + i * ls.bytes + w2_off, &mw2, full + i,
                    (kt0 + i) * kTile, c0);
      }
      grid_dependency_wait();
      for (int i = 0; i < n_loc; ++i) {
        const int s = i % stages, k = (kt0 + i) * kTile;
        uint8_t* st = ring + s * ls.bytes;
        if (i >= early) {
          mbar_wait(empty + s, ((i / stages) & 1) ^ 1);
          mbar_arrive_expect_tx(full + s, tx);
          tma_load_2d(st + w2_off, &mw2, full + s, k, c0);
        }
        tma_load_2d(st, &mzh, full + s, k, zh0);
        tma_load_2d(st + ls.zh, &mzh, full + s, k + 32, zh0);
        tma_load_2d(st + 2 * ls.zh, &mzp, full + s, k, zp0);
        tma_load_2d(st + 2 * ls.zh + ls.zp, &mzp, full + s, k + 32, zp0);
      }
    }
  } else {
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    // This thread forms rows wr and wr + 8 of each activation tile at its
    // warpgroup's 32 hidden units (k-steps 2 wg, 2 wg + 1), reading the zh
    // and zp rows of the staged boxes; rows past M are formed from row
    // M - 1's operands and never stored.
    const int wr = warp * 16 + g;
    int hrow[2], prow[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = min(r0 + wr + 8 * i, M - 1);
      hrow[i] = (r / nc) * C + r % C - zh0;
      prow[i] = r / C - zp0;
    }
    float acc[64];
    for (int i = 0; i < n_loc; ++i) {
      const int s = i % stages;
      const uint8_t* st = ring + s * ls.bytes;
      uint8_t* at = act + (i % kActBufs) * kBox;
      mbar_wait(full + s, (i / stages) & 1);
      // a = gelu(zh + zp), written K-major with the 128-byte swizzle
      // (wgmma's A operand): k-step kk's hidden units 16 kk + 2 t (+1) and
      // 16 kk + 8 + 2 t (+1), from 32-column box kk / 2.
#pragma unroll
      for (int k2 = 0; k2 < 2; ++k2) {
        const int kk = 2 * wg + k2;
        const uint8_t* zhb = st + wg * ls.zh;
        const uint8_t* zpb = st + 2 * ls.zh + wg * ls.zp;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int half = j % 2;  // row wr, else wr + 8
          const int col = k2 * 16 + 2 * t + (j / 2) * 8;
          const float2 x = ld_swizzled(zhb, hrow[half], col);
          const float2 y = ld_swizzled(zpb, prow[half], col);
          const int row = wr + 8 * half;
          const int chunk = kk * 2 + j / 2;  // 16-byte chunk of the row
          *reinterpret_cast<uint32_t*>(
              at + row * 128 + ((chunk ^ (row & 7)) << 4) + 4 * t) =
              pack_bf16(gelu_tanh_approx(x.x + y.x),
                        gelu_tanh_approx(x.y + y.y));
        }
      }
      fence_async_shared();
      // Both halves of the tile are written; and both consumers have
      // retired their wgmmas of step i - 2 (wait<1> at step i - 1), the
      // last to read the tile that step i + 1 writes.
      named_bar_sync(1, 256);
      wgmma_fence();
      const uint64_t ad = opaque(smem_desc(at, 0, 1024));
      const uint64_t wd =
          opaque(smem_desc(st + w2_off + wg * (kLaneCols / 2) * 128, 0,
                           1024));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_n128(acc, desc_add(ad, kk * 32), desc_add(wd, kk * 32),
                      i > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();  // step i - 1's wgmmas have retired
      if (i > 0 && lane == 0) mbar_arrive(empty + (i - 1) % stages);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    named_bar_sync(1, 256);  // every wgmma has retired: the ring is free
    // The f32 partial, row-major with a 4-float pad per row: acc n8-tile j
    // holds columns wg·128 + 8 j + 2 t, +1 of rows wr (0, 1), wr + 8 (2, 3).
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<float2*>(
            red + (wr + 8 * i) * kRedPitch + wg * 128 + 8 * j + 2 * t) =
            make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
  }
  cluster.sync();  // every split's partial is in its shared memory
  // The cluster's blocks share the tile's 64 x 64 groups of 4 columns,
  // summing the S partials in rank order, adding b2 and rounding to bf16;
  // d is a multiple of 8, so a group is in or out whole.
  for (int q = split * kLaneThreads + threadIdx.x;
       q < kTile * kLaneCols / 4; q += S * kLaneThreads) {
    const int row = q / (kLaneCols / 4), col = 4 * (q % (kLaneCols / 4));
    const int r = r0 + row, c = c0 + col;
    if (r >= M || c >= d) continue;
    float4* src = reinterpret_cast<float4*>(red + row * kRedPitch + col);
    float4 v[8];  // all S loads in flight before the sum
#pragma unroll
    for (int x = 0; x < 8; ++x)
      if (x < S) v[x] = *cluster.map_shared_rank(src, x);
    float4 sum = v[0];
#pragma unroll
    for (int x = 1; x < 8; ++x)
      if (x < S) {
        sum.x += v[x].x;
        sum.y += v[x].y;
        sum.z += v[x].z;
        sum.w += v[x].w;
      }
    const float2 ba = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(b2 + c));
    const float2 bb = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(b2 + c + 2));
    *reinterpret_cast<uint2*>(out + (size_t)r * d + c) =
        make_uint2(pack_bf16(sum.x + ba.x, sum.y + ba.y),
                   pack_bf16(sum.z + bb.x, sum.w + bb.y));
  }
  cluster.sync();  // no block leaves while another may still read it
}

// The zh and zp rows a 64-row tile of flat rows may need: the slots it
// spans (all C rows each) and its rows / C.  Mirrors `decode_plan`.
inline int zh_rows_needed(int B, int C, int N) {
  const int slots = (kTile - 1) / (N * C) + 2;
  return (slots < B ? slots : B) * C;
}
inline int zp_rows_needed(int B, int C, int N) {
  const int rows = (kTile - 1) / C + 2;
  return rows < B * N ? rows : B * N;
}

int launch_flat(const void* h, const void* p, const void* w1, const void* b1,
                const void* w2, const void* b2, void* out, float* zh,
                float* zp, int B, int C, int N, int d, int H, int zh_rows,
                int zp_rows, int stages_a, int stages_b, int splits,
                cudaStream_t stream) {
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  const int n_k = (H + kTile - 1) / kTile;
  const int k_per = splits > 0 ? (n_k + splits - 1) / splits : 0;
  if (zh_rows < zh_rows_needed(B, C, N) || zp_rows < zp_rows_needed(B, C, N) ||
      zh_rows > 256 || zp_rows > 256 || stages_a < 2 || stages_b < 2 ||
      splits < 1 || splits > 8 || (splits - 1) * k_per >= n_k ||
      gemm_smem(stages_a) > (size_t)limit ||
      lane_smem(zh_rows, zp_rows, stages_b) > (size_t)limit)
    return (int)cudaErrorInvalidValue;
  constexpr auto kBf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  constexpr auto kF32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const bf16* w1h = static_cast<const bf16*>(w1);
  CUtensorMap mh, mw1h, mp, mw1p, mzh, mzp, mw2;
  int err = hopper::map_2d(&mh, kBf16, 2, h, (long long)B * C, d, d, kTile,
                           kTile);
  if (!err)
    err = hopper::map_2d(&mp, kBf16, 2, p, (long long)B * N, d, d, kTile,
                         kTile);
  if (!err)
    err = hopper::map_2d(&mw1h, kBf16, 2, w1h, H, d, 2 * d, kGemmCols,
                         kTile);
  if (!err)
    err = hopper::map_2d(&mw1p, kBf16, 2, w1h + d, H, d, 2 * d, kGemmCols,
                         kTile);
  if (!err)
    err = hopper::map_2d(&mzh, kF32, 4, zh, (long long)B * C, H, H, zh_rows,
                         32);
  if (!err)
    err = hopper::map_2d(&mzp, kF32, 4, zp, (long long)B * N, H, H, zp_rows,
                         32);
  if (!err)
    err = hopper::map_2d(&mw2, kBf16, 2, w2, d, H, H, kLaneCols, kTile);
  if (err) return err;

  size_t smem = gemm_smem(stages_a);
  cudaError_t e = cudaFuncSetAttribute(
      decode_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int tiles_h = (B * C + kTile - 1) / kTile;
  const dim3 grid_a((H + kGemmCols - 1) / kGemmCols,
                    tiles_h + (B * N + kTile - 1) / kTile);
  decode_gemm_kernel<<<grid_a, kGemmThreads, smem, stream>>>(
      mh, mw1h, mp, mw1p, static_cast<const bf16*>(b1), zh, zp, B * C, B * N,
      H, d, tiles_h, stages_a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  smem = lane_smem(zh_rows, zp_rows, stages_b);
  e = cudaFuncSetAttribute(decode_lane_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int M = B * N * C;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (d + kLaneCols - 1) / kLaneCols,
                     (M + kTile - 1) / kTile);
  cfg.blockDim = dim3(kLaneThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  e = cudaLaunchKernelEx(&cfg, decode_lane_kernel, mzh, mzp, mw2,
                         static_cast<const bf16*>(b2),
                         static_cast<bf16*>(out), M, N, C, d, H, zh_rows,
                         zp_rows, stages_b, k_per);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// body 0: the CUDA-core cluster body (demux_tile.cuh) with rh = a rows of
// C and up to rp = b lanes per cluster, float32 or bf16; body 1: the bf16
// flat-row TMA + wgmma stages, staging a zh rows and b zp rows per lane
// tile, with the two rings' depths, zh (B·C, H) and zp (B·N, H) float32
// scratch.  The plan comes from Python; a plan this body cannot run is
// refused (cudaErrorInvalidValue), never replaced.  Returns a cudaError_t.
extern "C" int decode_demux_launch(const void* h, const void* p,
                                   const void* w1, const void* b1,
                                   const void* w2, const void* b2, void* out,
                                   void* zh, void* zp, int dtype, int B,
                                   int C, int N, int d, int H, int body,
                                   int a, int b, int stages_a, int stages_b,
                                   int splits, void* stream) {
  if (body == 0)
    return launch_dtype(dtype, h, p, w1, b1, w2, b2, out, B, C, N, d, H, a,
                        b, stream);
  if (body == 1 && dtype == 1 && d % 8 == 0 && H % 8 == 0)
    return launch_flat(h, p, w1, b1, w2, b2, out, static_cast<float*>(zh),
                       static_cast<float*>(zp), B, C, N, d, H, a, b,
                       stages_a, stages_b, splits,
                       static_cast<cudaStream_t>(stream));
  return (int)cudaErrorInvalidValue;
}
