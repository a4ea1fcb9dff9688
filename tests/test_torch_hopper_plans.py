"""Launch plans of the port's Hopper kernels, checked on the CPU.

The flash-attention, index-embed demux, decode demux and Hadamard mux
kernels take their tiling from a pure function in Python
(``repro_torch.kernels.{attention,demux,multiplex}.kernel.plan`` and
``demux.kernel.decode_plan``): body, tiles, grid, ring stages and shared
memory.  The kernels
themselves run only on a card (``tests/test_torch_cuda.py``); here the
coverage, fit, alignment and body-selection logic is held to its rules:
every output row or query row is written by exactly one block, a block's
shared memory fits the 232,448 bytes an H100 block may use, the TMA body
is taken only where every row stride is a multiple of 16 bytes, and the
wrappers refuse what no body takes."""
import itertools

import pytest
import torch

from repro_torch.kernels.attention import kernel as flash_kernel
from repro_torch.kernels.demux import kernel as demux_kernel
from repro_torch.kernels.multiplex import kernel as mux_kernel

SMEM_LIMIT = 232_448
BF16, F32 = torch.bfloat16, torch.float32

# (B, L, N, d, H): the evaluation slice (qwen1.5-4b), the lock-step
# prefill and its L=104 form (tmux-12l-768h), ragged shapes.
EVAL = (2, 1024, 8, 2560, 5120)
PREFILL = (8, 1, 40, 768, 1536)
DEMUX_SHAPES = [EVAL, PREFILL, (8, 104, 40, 768, 1536), (3, 17, 3, 96, 160),
                (3, 7, 5, 200, 300), (2, 70, 3, 64, 64), (1, 130, 5, 16, 24),
                (2, 1, 129, 8, 8), (1, 65, 1, 24, 40)]


def _demux_rows(plan, b, l, n):
    gx, gy, gz = plan.grid_b
    # In the wgmma body x is the column tile, which does not change the
    # rows; a cluster reports its rows at rank 0 (x % 8 == 0).
    xs = range(gx) if plan.body == "cluster" else [0]
    rows = []
    for x, y, z in itertools.product(xs, range(gy), range(gz)):
        rows += plan.output_rows((x, y, z), b, n, l)
    return rows


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("shape", DEMUX_SHAPES)
def test_demux_plan_writes_every_output_row_once(shape, dtype):
    b, l, n, d, hidden = shape
    plan = demux_kernel.plan(b, l, n, d, hidden, dtype)
    rows = _demux_rows(plan, b, l, n)
    assert len(rows) == len(set(rows)) == b * n * l
    assert set(rows) == set(itertools.product(range(b), range(n), range(l)))
    if plan.body == "wgmma":
        # columns: 256 per block, the last tile ragged; zh / zp GEMMs
        # cover B·L and B·N rows and all H hidden units
        assert (plan.grid_b[0] - 1) * 256 < d <= plan.grid_b[0] * 256
        assert plan.grid_a[0] * 256 >= hidden and plan.grid_p == (
            plan.grid_a[0], -(-(b * n) // 128))
        assert plan.grid_a[1] * 128 >= b * l
        assert plan.l_rows * plan.lanes <= 128


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("shape", DEMUX_SHAPES)
def test_demux_plan_fits_shared_memory(shape, dtype):
    plan = demux_kernel.plan(*shape, dtype)
    assert 0 < plan.smem_b <= SMEM_LIMIT
    assert plan.smem_a <= SMEM_LIMIT
    if plan.body == "wgmma":
        assert 2 <= plan.stages_b <= 4 and plan.stages_a == 4
        # the ring's tiles start on the 128-byte swizzle's 1024-byte period;
        # the two consumers' double-buffered 8 KB activation tiles follow
        stage = (plan.smem_b - 1024 - 4 * 8192 - 16 * plan.stages_b) \
            // plan.stages_b
        assert stage % 1024 == 0 and stage >= 256 * 128


@pytest.mark.parametrize("d,hidden,body", [
    (2560, 5120, "wgmma"), (768, 1536, "wgmma"), (96, 160, "wgmma"),
    (8, 8, "wgmma"),
    (200, 300, "cluster"),   # H * 2 = 600 bytes: not a multiple of 16
    (100, 64, "cluster"),    # d * 2 = 200 bytes
    (12, 64, "cluster"), (64, 36, "cluster")])
def test_demux_takes_tma_only_on_16_byte_strides(d, hidden, body):
    plan = demux_kernel.plan(2, 5, 3, d, hidden, BF16)
    assert plan.body == body
    if body == "wgmma":
        # h, p rows (2d bytes), w1 rows (4d), W1p's start (2d into w1),
        # w2 rows (2H) and the f32 scratch rows (4H)
        for nbytes in (2 * d, 4 * d, 2 * hidden, 4 * hidden):
            assert nbytes % 16 == 0


def test_demux_body_selection():
    assert demux_kernel.plan(*EVAL, BF16).body == "wgmma"
    assert demux_kernel.plan(*PREFILL, BF16).body == "wgmma"
    assert demux_kernel.plan(8, 104, 40, 768, 1536, BF16).body == "wgmma"
    assert demux_kernel.plan(3, 7, 5, 200, 300, BF16).body == "cluster"
    for shape in (EVAL, PREFILL, (3, 7, 5, 200, 300)):
        assert demux_kernel.plan(*shape, F32).body == "cluster"
    # the evaluation shape: one lane per consumer warpgroup, 64 rows of L
    plan = demux_kernel.plan(*EVAL, BF16)
    assert (plan.l_rows, plan.lanes) == (64, 2)
    assert plan.grid_b == (10, 4, 32) and plan.grid_a == (20, 16)


def test_demux_plan_matches_the_cluster_bodys_own_tiling():
    """demux_tile.cuh's pick_tiling narrows the lanes of a cluster until
    its shared memory fits; the plan computes the same (4 of 8 lanes at
    the evaluation shape in float32)."""
    plan = demux_kernel.plan(*EVAL, F32)
    assert (plan.l_rows, plan.lanes) == (16, 4)
    assert plan.grid_b == (64 * 8, 2, 2)
    plan = demux_kernel.plan(8, 1, 40, 768, 1536, F32)
    assert (plan.l_rows, plan.lanes) == (1, 40)


@pytest.mark.parametrize("bad", [dict(dtype=torch.float16),
                                 dict(l=0), dict(d=0)])
def test_demux_plan_raises_on_what_it_does_not_take(bad):
    args = dict(b=2, l=4, n=3, d=64, hidden=128, dtype=BF16) | bad
    with pytest.raises((TypeError, ValueError)):
        demux_kernel.plan(**args)


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("lq", [1, 37, 64, 127, 128, 129, 1032, 8192])
def test_flash_plan_covers_every_query_row_once(lq, dtype):
    plan = flash_kernel.plan(2, lq, lq, 4, 128, dtype)
    rows = [r for z in range(plan.grid[2]) for r in plan.query_rows(z, lq)]
    assert sorted(rows) == list(range(lq))
    # heaviest tile first: blockIdx.z == 0 holds the last query rows
    assert plan.query_rows(0, lq)[-1] == lq - 1


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_plan_fits_shared_memory(hd, dtype):
    plan = flash_kernel.plan(2, 1032, 1032, 20, hd, dtype)
    assert plan.smem_bytes <= SMEM_LIMIT
    if dtype == BF16:
        # Q (128 rows) and a 3-stage ring of 96-key K and V tiles, in
        # 128-byte rows of 64 columns, plus 1024 bytes of alignment slack
        # and 13 mbarriers
        assert plan.smem_bytes == 1024 + 128 * hd * 2 + 6 * 96 * hd * 2 \
            + 13 * 8
        assert (hd * 2) % 128 == 0      # whole 64-column TMA boxes


def test_flash_body_selection():
    plan = flash_kernel.plan(2, 1032, 1032, 20, 128, BF16)
    assert plan.body == "wgmma" and plan.threads == 384
    assert plan.grid == (20, 2, 9) and (plan.k_tile, plan.stages) == (96, 3)
    # the ragged tile (8 rows) is the first rows, launched last
    assert plan.query_rows(8, 1032) == range(0, 8)
    plan = flash_kernel.plan(2, 1032, 1032, 20, 128, F32)
    assert plan.body == "cuda_cores" and plan.threads == 256
    assert plan.grid == (20, 2, 17)


# Head dims beyond the earlier 64 and 128: 20 (not a multiple of 8), 32, 80,
# 96 (zero-padded to 64 / 128 columns), 192 (nemotron-4-340b) and 256
# (gemma); Lq ragged against both bodies' tiles.
NEW_HEAD_DIMS = [20, 32, 80, 96, 192, 256]


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("hd", NEW_HEAD_DIMS)
def test_flash_plan_takes_every_head_dim(hd, dtype):
    """Every hd up to 256 plans: bf16 multiples of 8 on the wgmma body
    (64-column boxes, the head padded to hdp; 96-key tiles to hdp 128,
    48-key tiles past it, 3 stages), the rest and f32
    on the CUDA-core body; every query row written once, shared memory
    within the card's."""
    plan = flash_kernel.plan(2, 1037, 1037, 8, hd, dtype)
    assert plan.hdp == -(-hd // 64) * 64 and plan.hdp % 64 == 0
    rows = [r for z in range(plan.grid[2])
            for r in plan.query_rows(z, 1037)]
    assert sorted(r for r in rows if r >= 0) == list(range(1037))
    assert plan.smem_bytes <= SMEM_LIMIT
    if dtype == BF16 and hd % 8 == 0:
        assert plan.body == "wgmma" and plan.q_tile == 128
        want = (96, 3) if plan.hdp <= 128 else (48, 3)
        assert (plan.k_tile, plan.stages) == want
        assert plan.smem_bytes == 1024 + 128 * plan.hdp * 2 \
            + 2 * plan.stages * plan.k_tile * plan.hdp * 2 \
            + (1 + 4 * plan.stages) * 8
    else:
        assert plan.body == "cuda_cores" and plan.q_tile == 64
        assert plan.smem_bytes == (64 * (plan.hdp + 4) * 3 + 64 * 68) * 4
    # tensors off 16 bytes cannot be TMA maps: the CUDA-core body
    assert flash_kernel.plan(2, 1037, 1037, 8, hd, dtype,
                             aligned=False).body == "cuda_cores"


@pytest.mark.parametrize("hd,dtype,exc,match", [
    (0, BF16, ValueError, "head_dim 0"),
    (300, F32, ValueError, "head_dim 300"),
    (64, torch.float16, TypeError, "float16")])
def test_flash_wrapper_raises_on_what_no_body_takes(hd, dtype, exc, match):
    q = torch.zeros((1, 16, 2, hd), dtype=dtype)
    with pytest.raises(exc, match=match):
        flash_kernel.flash_attention(q, q, q)
    with pytest.raises(exc, match=match):
        flash_kernel.plan(1, 16, 16, 2, hd, dtype)


@pytest.mark.parametrize("hd,dtype,body", [
    (32, BF16, "wgmma"), (96, F32, "cuda_cores")])
def test_flash_plan_takes_what_it_refused(hd, dtype, body):
    """The earlier refusals (bf16 hd 32, f32 hd 96) now plan, every query row
    once."""
    plan = flash_kernel.plan(1, 16, 16, 2, hd, dtype)
    assert plan.body == body
    rows = [r for z in range(plan.grid[2]) for r in plan.query_rows(z, 16)]
    assert sorted(r for r in rows if r >= 0) == list(range(16))


def test_demux_wrapper_raises_on_what_no_body_takes():
    h, p = torch.zeros((2, 4, 8), dtype=torch.float16), \
        torch.zeros((2, 3, 8), dtype=torch.float16)
    w1, b1, w2, b2 = (torch.zeros(s, dtype=torch.float16)
                      for s in ((16, 16), (16,), (8, 16), (8,)))
    with pytest.raises(TypeError, match="float16"):
        demux_kernel.index_embed_demux(h, p, w1, b1, w2, b2)


# (B, C, N, d, H) of the decode demux: the lock-step and paged slices
# (tmux-12l-768h, C 1) and their prefill_chunk=4 form, N 1 / 5 / 40 at C 1
# and 4, ragged N·C (neither a multiple nor a divisor of 64 rows).
DECODE_SHAPES = [(8, 1, 40, 768, 1536), (8, 4, 40, 768, 1536),
                 (3, 3, 3, 96, 160), (5, 1, 1, 64, 64), (5, 4, 1, 64, 64),
                 (2, 1, 5, 16, 24), (3, 4, 5, 16, 24), (70, 1, 1, 8, 8),
                 (2, 4, 40, 64, 128), (7, 3, 13, 24, 40), (1, 16, 3, 8, 8)]


@pytest.mark.parametrize("shape", DECODE_SHAPES)
def test_decode_plan_writes_every_output_row_once(shape):
    b, c, n, d, hidden = shape
    plan = demux_kernel.decode_plan(b, c, n, d, hidden, BF16)
    assert plan.body == "wgmma"
    gx, gy, gz = plan.grid_b
    rows = [r for x, z in itertools.product(range(gx), range(gz))
            for r in plan.output_rows((x, 0, z), b, n, c)]
    assert len(rows) == len(set(rows)) == b * n * c
    assert set(rows) == set(itertools.product(range(b), range(n), range(c)))
    # 256 columns per cluster, the last tile ragged; the zh / zp GEMM
    # covers all H hidden units in 96-column tiles and the B·C and B·N
    # rows in 64-row tiles
    assert (gy - 1) * 256 < d <= gy * 256
    assert plan.grid_a == (-(-hidden // 96),
                           -(-(b * c) // 64) + -(-(b * n) // 64))


@pytest.mark.parametrize("shape", DECODE_SHAPES)
def test_decode_plan_splits_the_hidden_axis_and_the_sum(shape):
    """The cluster's blocks take every 64-unit hidden step once (none
    empty, at most 8 blocks), and between them sum every group of 4 of the
    tile's 64 x 256 partial once."""
    b, c, n, d, hidden = shape
    plan = demux_kernel.decode_plan(b, c, n, d, hidden, BF16)
    n_k = -(-hidden // 64)
    steps = [k for x in range(plan.splits)
             for k in range(x * plan.k_per, min((x + 1) * plan.k_per, n_k))]
    assert sorted(steps) == list(range(n_k))
    assert 1 <= plan.splits <= 8 and (plan.splits - 1) * plan.k_per < n_k
    assert plan.grid_b[0] == plan.splits
    groups = [q for x in range(plan.splits) for q in plan.reduce_groups(x)]
    assert sorted(groups) == list(range(64 * 64))


@pytest.mark.parametrize("shape", DECODE_SHAPES)
def test_decode_plan_stages_every_rows_operands(shape):
    """Flat row r = (b·N + n)·C + c of tile y reads zh row b·C + c and zp
    row b·N + n; both lie inside the boxes the tile stages."""
    b, c, n, d, hidden = shape
    plan = demux_kernel.decode_plan(b, c, n, d, hidden, BF16)
    for z in range(plan.grid_b[2]):
        zh0, zp0 = plan.zh_start(z), plan.zp_start(z)
        for bi, ni, ci in plan.output_rows((0, 0, z), b, n, c):
            assert 0 <= bi * c + ci - zh0 < plan.zh_rows
            assert 0 <= bi * n + ni - zp0 < plan.zp_rows
    assert plan.zh_rows <= min(256, b * c) and plan.zp_rows <= min(256,
                                                                  b * n)


@pytest.mark.parametrize("shape", DECODE_SHAPES)
def test_decode_plan_fits_shared_memory(shape):
    plan = demux_kernel.decode_plan(*shape, BF16)
    assert plan.smem_a <= SMEM_LIMIT and plan.smem_b <= SMEM_LIMIT
    assert plan.stages_a == 4 and 2 <= plan.stages_b <= 4
    # ring stages start on the 128-byte swizzle's 1024-byte period: two
    # f32 boxes each of zh and zp rows (128-byte rows), then the 32 KB W2
    # tile (256 rows); the drained ring holds the f32 partial (64 rows of
    # 260 floats); three 8 KB activation tiles follow
    pad = lambda rows: -(-rows * 128 // 1024) * 1024   # noqa: E731
    stage = 2 * pad(plan.zh_rows) + 2 * pad(plan.zp_rows) + 32768
    ring = max(plan.stages_b * stage, 64 * 260 * 4)
    assert plan.smem_b == 1024 + ring + 3 * 8192 + 16 * plan.stages_b
    assert plan.smem_a == 1024 + 4 * (20480 + 16)   # 8 KB A, 12 KB W1


@pytest.mark.parametrize("dtype,d,hidden,aligned,body", [
    (BF16, 768, 1536, True, "wgmma"), (BF16, 96, 160, True, "wgmma"),
    (BF16, 8, 8, True, "wgmma"),
    (BF16, 768, 1536, False, "cluster"),   # an operand off 16 bytes
    (BF16, 200, 300, True, "cluster"),     # H * 2 bytes not a multiple of 16
    (BF16, 100, 64, True, "cluster"),      # d * 2 bytes
    (F32, 768, 1536, True, "cluster"), (F32, 96, 160, True, "cluster")])
def test_decode_body_selection(dtype, d, hidden, aligned, body):
    plan = demux_kernel.decode_plan(8, 1, 40, d, hidden, dtype, aligned)
    assert plan.body == body
    if body == "cluster":
        # the cluster body's own tiling: rh rows of C, all 40 lanes fit
        assert (plan.l_rows, plan.lanes) == (1, 40)
        assert plan.smem_b <= SMEM_LIMIT


def test_decode_plan_at_the_slices():
    """The slice's shapes: 5 x 3 lane tiles split 8 ways over the hidden
    axis at C 1 (120 blocks) and 20 x 3 tiles split 2 ways at C 4; the
    zh / zp GEMM 16 x (1 + 5) blocks; a card of fewer SMs splits less."""
    plan = demux_kernel.decode_plan(8, 1, 40, 768, 1536, BF16)
    assert plan.grid_b == (8, 3, 5) and plan.grid_a == (16, 6)
    assert (plan.zh_rows, plan.zp_rows, plan.k_per) == (3, 65, 3)
    plan = demux_kernel.decode_plan(8, 4, 40, 768, 1536, BF16)
    assert plan.grid_b == (2, 3, 20)
    assert (plan.zh_rows, plan.zp_rows) == (8, 17)
    assert demux_kernel.decode_plan(8, 1, 40, 768, 1536, BF16,
                                    sms=16).splits == 1


@pytest.mark.parametrize("bad,exc", [
    (dict(dtype=torch.float16), TypeError), (dict(c=0), ValueError),
    (dict(n=0), ValueError), (dict(d=0), ValueError),
    (dict(c=200, n=1), ValueError)])   # 400 zh rows per tile: > a TMA box
def test_decode_plan_raises_on_what_no_body_takes(bad, exc):
    args = dict(b=4, c=1, n=3, d=64, hidden=128, dtype=BF16) | bad
    with pytest.raises(exc):
        demux_kernel.decode_plan(**args)


def test_decode_wrapper_raises_on_what_no_body_takes():
    h, p = torch.zeros((2, 1, 8), dtype=torch.float16), \
        torch.zeros((2, 3, 8), dtype=torch.float16)
    w1, b1, w2, b2 = (torch.zeros(s, dtype=torch.float16)
                      for s in ((16, 16), (16,), (8, 16), (8,)))
    with pytest.raises(TypeError, match="float16"):
        demux_kernel.decode_demux(h, p, w1, b1, w2, b2)


# ---------------------------------------------------------------------------
# The Hadamard mux
# ---------------------------------------------------------------------------

# (B, N, L, d): the decode step (tmux-12l-768h, L 1), the lock-step
# prefill's L 104, the eval step (qwen1.5-4b, N 8), ragged shapes.
MUX_SHAPES = [(8, 40, 1, 768), (8, 40, 104, 768), (2, 8, 1032, 2560),
              (3, 5, 7, 200), (1, 1, 1, 8), (2, 3, 5, 96), (1, 64, 3, 24)]


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("shape", MUX_SHAPES)
def test_mux_plan_covers_every_output_once(shape, dtype, aligned):
    """Every output element belongs to exactly one block's vectors, every
    instance to exactly one slot; a block is cv x slots threads (powers of
    two, 64..256), slots <= min(N, 32), and the partials fit."""
    b, n, l, d = shape
    plan = mux_kernel.plan(b, n, l, d, dtype, aligned)
    per = 16 // dtype.itemsize
    assert plan.vec == (per if aligned and d % per == 0 else 1)
    total = b * l * (d // plan.vec)
    vecs = [f for blk in range(plan.blocks)
            for f in plan.vectors(blk, total)]
    assert vecs == list(range(total))
    # vector f is elements [f * vec, f * vec + vec) of the flat (B·L, d)
    # output: whole rows' worth, so every element once
    assert d % plan.vec == 0 and total * plan.vec == b * l * d
    inst = sorted(i for s in range(plan.slots)
                  for i in plan.instances(s, n))
    assert inst == list(range(n))
    assert plan.threads == plan.cv * plan.slots
    for x in (plan.cv, plan.slots, plan.threads):
        assert x & (x - 1) == 0
    assert 64 <= plan.threads <= 256 and plan.slots <= min(n, 32)
    assert plan.smem == (plan.threads * plan.vec * 4 if plan.slots > 1
                         else 0)


def test_mux_plan_at_the_slices():
    """The decode step: 32 slots of 4 vectors, 192 blocks of 128 threads
    on a 132-SM card (the first version had 3 blocks); the eval step
    streams, one slot per block of 256 vectors."""
    plan = mux_kernel.plan(8, 40, 1, 768, BF16)
    assert (plan.slots, plan.cv, plan.threads, plan.blocks) == (32, 4, 128,
                                                                192)
    plan = mux_kernel.plan(2, 8, 1032, 2560, BF16)
    assert (plan.slots, plan.cv, plan.blocks) == (1, 256, 2580)
    assert plan.smem == 0
    # fewer SMs, fewer blocks wanted: 16 slots of 16 vectors
    plan = mux_kernel.plan(8, 40, 1, 768, BF16, sms=16)
    assert plan.blocks >= 16 and plan.slots <= 32


@pytest.mark.parametrize("bad,exc", [(dict(dtype=torch.float16), TypeError),
                                     (dict(n=0), ValueError),
                                     (dict(d=0), ValueError)])
def test_mux_plan_raises_on_what_it_does_not_take(bad, exc):
    args = dict(b=2, n=3, l=4, d=64, dtype=BF16) | bad
    with pytest.raises(exc):
        mux_kernel.plan(**args)
