// Fused decode-epilogue demultiplexer over a decode block of C rows:
//   out[b, n, c, :] = gelu_tanh(h[b, c]·W1h + p[b, n]·W1p + b1)·W2 + b2
// for h (B, C, d), p (B, N, d) -> out (B, N, C, d).
//
// Replaces the Pallas TPU kernel `decode_demux` (`_decode_demux_kernel`) in
// src/repro/kernels/demux/kernel.py.
//
// Bound on the H100: at decode (C = 1, N = 40, d = 768, H = 1536, bf16) the
// function reads ~7 MB of weights for ~1.5 GFLOP over B = 8 slots, so the
// bytes bound it; a design with one block per slot, as the TPU kernel's
// one program per slot would map, leaves 124 of 132 SMs idle.
//
// Design (demux_tile.cuh): the defining property of the TPU kernel is
// kept -- all N lanes and all C rows of a slot are demuxed together, so
// zh = h·W1h is computed once per slot and zp = p·W1p once per lane -- but
// the "program" is a cluster of 8 blocks: each block computes z and the
// activations for 1/8 of the hidden axis, then each block computes 1/8 of
// the output columns from all eight slices of the activations, read
// through distributed shared memory.  Nothing intermediate reaches device
// memory.  Where N·C exceeds the 64 rows a cluster's register tiles hold,
// lanes are tiled and zh is recomputed per lane tile.
#include "demux_tile.cuh"

extern "C" int decode_demux_launch(const void* h, const void* p,
                                   const void* w1, const void* b1,
                                   const void* w2, const void* b2, void* out,
                                   int dtype, int B, int C, int N, int d,
                                   int H, void* stream) {
  const int rh = C < 16 ? C : 16;
  return launch_dtype(dtype, h, p, w1, b1, w2, b2, out, B, C, N, d, H, rh,
                      /*rp=*/N, stream);
}
