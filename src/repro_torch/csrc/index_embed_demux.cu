// Index-embed demultiplexer over a hidden block of L rows:
//   out[b, n, l, :] = gelu_tanh(h[b, l]·W1h + p[b, n]·W1p + b1)·W2 + b2
// for h (B, L, d), p (B, N, d) -> out (B, N, L, d).
//
// Replaces the Pallas TPU kernel `index_embed_demux` (`_demux_kernel`) in
// src/repro/kernels/demux/kernel.py.
//
// Bound on the H100: at the serving prefill (L = 1) the ~7 MB of bf16
// weights bound it (the products are small); at full L the 2·d·H flops of
// each of the B·N·L output rows bound it.  The TPU kernel runs one lane and
// a tile of L per program and carries an f32 accumulator across a
// sequential hidden-axis grid dimension; blocks on the card run in
// parallel and in no order, so the hidden axis is split across the blocks
// of a thread-block cluster instead (demux_tile.cuh).
//
// Design: a cluster owns a tile of up to 16 rows of L and as many lanes as
// its register tiles hold (all 40 at L = 1), so each block streams W1 and W2
// for many output rows instead of one lane's; z for the L-tile is computed
// once per lane tile, the (rows x H) activations stay in shared memory,
// shared across the cluster, and never reach device memory.
#include "demux_tile.cuh"

extern "C" int index_embed_demux_launch(const void* h, const void* p,
                                        const void* w1, const void* b1,
                                        const void* w2, const void* b2,
                                        void* out, int dtype, int B, int L,
                                        int N, int d, int H, void* stream) {
  const int rh = L < 16 ? L : 16;
  return launch_dtype(dtype, h, p, w1, b1, w2, b2, out, B, L, N, d, H, rh,
                      /*rp=*/N, stream);
}
