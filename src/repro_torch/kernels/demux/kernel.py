"""Launch plans and wrappers of the CUDA index-embed demultiplexers
(``repro_torch/csrc/index_embed_demux.cu`` and ``decode_demux.cu``).

Both take the 2-layer shared MLP as raw tensors in PyTorch's (out, in)
layout: w1 (H, 2d), b1 (H), w2 (d, H), b2 (d), all of h's dtype.

``plan`` chooses the index-embed demux's body before launch, by dtype and
shape: bf16 with d and H multiples of 8 (every row stride a multiple of
16 bytes, as TMA needs) takes the Hopper body -- a TMA + ``wgmma`` GEMM
for zh = h·W1hᵀ and zp = p·W1pᵀ + b1 into float32 scratch, then the lane
GEMM with the gelu prologue fused -- and everything else the CUDA-core
cluster body (``demux_tile.cuh``).  ``decode_plan`` does the same for the
decode demux, whose Hopper body tiles the B·N·C output rows flat, 64 at a
time across slot boundaries, in 64-column tiles.  A plan the body cannot
run raises here, before launch; nothing falls back."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import _build

SMEM_LIMIT = 232_448     # bytes of shared memory a block may use (H100)
MAX_GRID_YZ = 65535
BODIES = {"cluster": 0, "wgmma": 1}

# The wgmma body: 128 output rows x 256 columns per block, 64 hidden
# units per ring stage, at most MAX_STAGES stages; the lane GEMM's two
# consumers also hold two 8 KB activation tiles each.
ROWS, COLS, MAX_STAGES = 128, 256, 4
GEMM_STAGE = ROWS * 128 + COLS * 128          # bytes: A and B tiles
ACT_TILES = 4 * 64 * 128

# The cluster body (demux_tile.cuh): 8-block clusters, 64 register-tile
# rows, shared-memory tiles in floats.
CS, KROWS, KT, AS, WS, ZS = 8, 64, 16, 68, 132, 65


def _pad1024(n: int) -> int:
    return -(-n // 1024) * 1024


@dataclasses.dataclass(frozen=True)
class DemuxPlan:
    body: str          # "wgmma" or "cluster"
    l_rows: int        # rows of L per tile (cluster: rh)
    lanes: int         # lanes per tile (cluster: rp)
    stages_a: int      # ring depth of the zh / zp GEMM (wgmma)
    stages_b: int      # ring depth of the lane GEMM (wgmma)
    smem_a: int        # shared-memory bytes per block, zh / zp GEMM
    smem_b: int        # shared-memory bytes per block, lane GEMM / cluster
    grid_a: tuple      # zh GEMM grid (x, y); the zp GEMM's is grid_p
    grid_p: tuple
    grid_b: tuple      # lane GEMM grid / cluster grid (x, y, z)

    def output_rows(self, block: tuple, b: int, n: int, l: int) -> list:
        """(b, n, l) rows of the output that block (x, y, z) of grid_b
        writes, for B = b, N = n, L = l -- the kernels' own mapping."""
        x, y, z = block
        rows = []
        if self.body == "wgmma":
            n_lt = -(-l // self.l_rows)
            bi, l0 = z // n_lt, (z % n_lt) * self.l_rows
            for r in range(ROWS):
                ni, li = r // self.l_rows, r % self.l_rows
                if ni < self.lanes and y * self.lanes + ni < n \
                        and l0 + li < l:
                    rows.append((bi, y * self.lanes + ni, l0 + li))
        elif x % CS == 0:   # a cluster's rows, counted at its rank 0
            l0, n0 = (x // CS) * self.l_rows, y * self.lanes
            for r in range(self.l_rows * self.lanes):
                ni, li = n0 + r // self.l_rows, l0 + r % self.l_rows
                if ni < n and li < l:
                    rows.append((z, ni, li))
        return rows


def _cluster_plan(b, l, n, hidden, name="index_embed_demux") -> DemuxPlan:
    """demux_tile.cuh's tiling: rh rows of L (at most 16), as many lanes as
    the register tiles and shared memory hold (its pick_tiling)."""
    rh = min(l, 16)
    hs = -(-(-(-hidden // CS)) // KT) * KT
    rhp = -(-rh // 4) * 4
    rp = min(n, KROWS - rhp, KROWS // rh)
    while rp >= 1:
        floats = 3 * KT * AS + KROWS * ZS + rh * rp * hs + KT * AS + KT * WS
        if floats * 4 <= SMEM_LIMIT:
            break
        rp -= 1
    else:
        raise ValueError(f"{name}: H={hidden} does not fit the cluster "
                         f"body's shared memory")
    grid = (-(-l // rh) * CS, -(-n // rp), b)
    return DemuxPlan("cluster", rh, rp, 0, 0, 0, floats * 4, (), (), grid)


def _check_shape(name, dtype, b, l, n, d, hidden) -> None:
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: dtype {dtype} not supported; the kernel "
                        f"takes torch.float32 and torch.bfloat16")
    if min(b, l, n, d, hidden) < 1:
        raise ValueError(f"{name}: empty input B={b} L={l} N={n} d={d} "
                         f"H={hidden}")


def plan(b: int, l: int, n: int, d: int, hidden: int,
         dtype: torch.dtype) -> DemuxPlan:
    """The index-embed demux's launch for h (B, L, d), p (B, N, d), hidden
    width H; raises on what no body takes."""
    _check_shape("index_embed_demux", dtype, b, l, n, d, hidden)
    # TMA: every row stride (h, p: 2d; w1: 4d; w2: 2H; zh, zp: 4H bytes)
    # and W1p's start (2d bytes into w1) a multiple of 16.
    if dtype != torch.bfloat16 or d % 8 or hidden % 8:
        p = _cluster_plan(b, l, n, hidden)
    else:
        rl = min(l, 64)
        nl = min(n, ROWS // rl)
        lane_stage = 2 * _pad1024(rl * 128) + 2 * _pad1024(nl * 128) \
            + COLS * 128
        stages_b = min(MAX_STAGES,
                       (SMEM_LIMIT - 1024 - ACT_TILES - 64) // lane_stage)
        stages_a = MAX_STAGES
        p = DemuxPlan(
            "wgmma", rl, nl, stages_a, stages_b,
            1024 + stages_a * GEMM_STAGE + 16 * stages_a,
            1024 + stages_b * lane_stage + ACT_TILES + 16 * stages_b,
            (-(-hidden // COLS), -(-(b * l) // ROWS)),
            (-(-hidden // COLS), -(-(b * n) // ROWS)),
            (-(-d // COLS), -(-n // nl), b * -(-l // rl)))
    grids = [p.grid_a, p.grid_p, p.grid_b]
    if max(p.smem_a, p.smem_b) > SMEM_LIMIT or \
            any(max(g[1:], default=0) > MAX_GRID_YZ for g in grids):
        raise ValueError(f"index_embed_demux: B={b} L={l} N={n} d={d} "
                         f"H={hidden} exceeds the launch grid or shared "
                         f"memory")
    return p


# The decode demux's flat-row body (decode_demux.cu): zh / zp GEMM tiles
# of 64 rows x 96 hidden units; lane tiles of 64 flat rows x 256 columns,
# the hidden axis (64 units per ring stage) split over a cluster of at most
# 8 blocks; three 8 KB activation tiles; the f32 partial (64 rows of 256 + 4
# floats) reuses the drained ring.
FLAT, LANE_COLS, STAGES_A, MAX_STAGES_B, MIN_STAGES_B = 64, 256, 4, 4, 2
GEMM_ROWS, GEMM_COLS = 64, 96
FLAT_GEMM_STAGE = (GEMM_ROWS + GEMM_COLS) * 128  # bytes: A and W1 tiles
FLAT_ACT_TILES = 3 * FLAT * 128
FLAT_PARTIAL = FLAT * (LANE_COLS + 4) * 4
LANE_THREADS, MAX_CLUSTER, H100_SMS = 288, 8, 132
MAX_BOX_ROWS = 256                              # a TMA box's rows


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """The decode demux's flat-row launch: output row r = (b·N + n)·C + c of
    the B·N·C rows (out's own row order).  The cluster of blocks (x, y, z),
    x < splits, owns rows [64 z, 64 z + 64) at columns [256 y, 256 y +
    256); block x sums hidden steps [x k_per, x k_per + k_per) and stages
    zh rows from ``zh_start(z)`` (``zh_rows`` of them) and zp rows from
    ``zp_start(z)`` (``zp_rows``); the cluster's blocks then share the
    tile's 64 x 64 groups of 4 columns (``reduce_groups``)."""
    body: str          # "wgmma"
    b: int
    c: int
    n: int
    zh_rows: int
    zp_rows: int
    splits: int        # blocks per cluster along the hidden axis
    k_per: int         # hidden steps of 64 units per block
    stages_a: int      # ring depth of the zh / zp GEMM
    stages_b: int      # ring depth of the lane GEMM
    smem_a: int
    smem_b: int
    grid_a: tuple      # (H tiles of 96, zh + zp row tiles of 64)
    grid_b: tuple      # (splits, d tiles, flat row tiles)

    def zh_start(self, z: int) -> int:
        return (z * FLAT // (self.n * self.c)) * self.c

    def zp_start(self, z: int) -> int:
        return z * FLAT // self.c

    def output_rows(self, block: tuple, b: int, n: int, c: int) -> list:
        """(b, n, c) rows of the output that the cluster of block (x, y, z)
        writes, counted at its rank 0."""
        x, _, z = block
        if x:
            return []
        return [(r // (n * c), r // c % n, r % c)
                for r in range(z * FLAT, min((z + 1) * FLAT, b * n * c))]

    def reduce_groups(self, rank: int) -> list:
        """The tile's groups of 4 columns (row * 64 + column / 4) that rank
        ``rank`` of a cluster sums and writes: thread t takes rank * 288 + t
        and every splits * 288 after it."""
        start = rank * LANE_THREADS
        return [q for t in range(start, start + LANE_THREADS)
                for q in range(t, FLAT * LANE_COLS // 4,
                               self.splits * LANE_THREADS)]


def _flat_stage(zh_rows: int, zp_rows: int) -> int:
    return 2 * _pad1024(zh_rows * 128) + 2 * _pad1024(zp_rows * 128) \
        + LANE_COLS * 128


def decode_plan(b: int, c: int, n: int, d: int, hidden: int,
                dtype: torch.dtype, aligned: bool = True,
                sms: int = H100_SMS):
    """The decode demux's launch for h (B, C, d), p (B, N, d), hidden width
    H on a card of ``sms`` SMs: a ``DecodePlan`` (bf16, d and H multiples
    of 8, ``aligned`` operand addresses) or the cluster body's
    ``DemuxPlan`` (everything else); raises on what no body takes."""
    name = "decode_demux"
    _check_shape(name, dtype, b, c, n, d, hidden)
    if dtype != torch.bfloat16 or d % 8 or hidden % 8 or not aligned:
        p = _cluster_plan(b, c, n, hidden, name)
        smem, grids = p.smem_b, [p.grid_b]
    else:
        # A 64-row tile spans at most (63 // (N·C)) + 2 slots and
        # 63 // C + 2 rows of zp.
        zh_rows = min(b, (FLAT - 1) // (n * c) + 2) * c
        zp_rows = min(b * n, (FLAT - 1) // c + 2)
        if max(zh_rows, zp_rows) > MAX_BOX_ROWS:
            raise ValueError(f"{name}: C={c} needs {zh_rows} rows of zh per "
                             f"64-row tile; a TMA box takes "
                             f"{MAX_BOX_ROWS}")
        # Split the hidden axis into the largest power of two of blocks
        # that keeps the grid within one wave, none of them empty.
        tiles = -(-d // LANE_COLS) * -(-(b * n * c) // FLAT)
        n_k = -(-hidden // FLAT)
        splits = 1
        while splits * 2 <= min(MAX_CLUSTER, n_k) and \
                tiles * splits * 2 <= sms:
            splits *= 2
        k_per = -(-n_k // splits)
        splits = -(-n_k // k_per)
        stage = _flat_stage(zh_rows, zp_rows)
        fixed = 1024 + FLAT_ACT_TILES
        stages_b = min(MAX_STAGES_B, (SMEM_LIMIT - fixed) // (stage + 16))
        smem_a = 1024 + STAGES_A * (FLAT_GEMM_STAGE + 16)
        p = DecodePlan(
            "wgmma", b, c, n, zh_rows, zp_rows, splits, k_per, STAGES_A,
            stages_b, smem_a,
            fixed + max(stages_b * stage, FLAT_PARTIAL) + 16 * stages_b,
            (-(-hidden // GEMM_COLS),
             -(-(b * c) // GEMM_ROWS) + -(-(b * n) // GEMM_ROWS)),
            (splits, -(-d // LANE_COLS), -(-(b * n * c) // FLAT)))
        if stages_b < MIN_STAGES_B:
            raise ValueError(f"{name}: B={b} C={c} N={n} needs {stage} bytes "
                             f"per ring stage; {MIN_STAGES_B} stages do not "
                             f"fit {SMEM_LIMIT} bytes of shared memory")
        smem, grids = max(p.smem_a, p.smem_b), [p.grid_a, p.grid_b]
    if smem > SMEM_LIMIT or any(max(g[1:]) > MAX_GRID_YZ for g in grids):
        raise ValueError(f"{name}: B={b} C={c} N={n} d={d} H={hidden} "
                         f"exceeds the launch grid or shared memory")
    return p


def _check(name: str, h, p, w1, b1, w2, b2):
    b, _, d = h.shape
    n = p.shape[1]
    hidden = w1.shape[0]
    want = {"p": (b, n, d), "w1": (hidden, 2 * d), "b1": (hidden,),
            "w2": (d, hidden), "b2": (d,)}
    got = {"p": p, "w1": w1, "b1": b1, "w2": w2, "b2": b2}
    for arg, shape in want.items():
        if tuple(got[arg].shape) != shape:
            raise ValueError(f"{name}: {arg} is {tuple(got[arg].shape)}, "
                             f"expected {shape}")
    _build.check_inputs(name, h.dtype, h=h, **got)


def index_embed_demux(h, p, w1, b1, w2, b2) -> torch.Tensor:
    """h (B, L, d), p (B, N, d) -> (B, N, L, d)."""
    name = "index_embed_demux"
    _check(name, h, p, w1, b1, w2, b2)
    b, rows, d = h.shape
    n, hidden = p.shape[1], w1.shape[0]
    out = torch.empty((b, n, rows, d), dtype=h.dtype, device=h.device)
    if out.numel() == 0:
        return out
    pl = plan(b, rows, n, d, hidden, h.dtype)
    zh = zp = None
    if pl.body == "wgmma":   # float32 scratch of the shared products
        zh = torch.empty((b * rows, hidden), dtype=torch.float32,
                         device=h.device)
        zp = torch.empty((b * n, hidden), dtype=torch.float32,
                         device=h.device)
    err = _build.library().index_embed_demux_launch(
        h.data_ptr(), p.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
        zh.data_ptr() if zh is not None else None,
        zp.data_ptr() if zp is not None else None,
        _build.DTYPE_CODES[h.dtype], b, rows, n, d, hidden, BODIES[pl.body],
        pl.l_rows, pl.lanes, pl.stages_a, pl.stages_b, _build.stream_of(h))
    _build.raise_on_error(name, err)
    _build.LAUNCHES[name] += 1
    return out


def decode_demux(h, p, w1, b1, w2, b2) -> torch.Tensor:
    """h (B, C, d), p (B, N, d) -> (B, N, C, d); h·W1h computed once per
    (slot, row) and p·W1p once per (slot, lane)."""
    name = "decode_demux"
    _check(name, h, p, w1, b1, w2, b2)
    b, rows, d = h.shape
    n, hidden = p.shape[1], w1.shape[0]
    out = torch.empty((b, n, rows, d), dtype=h.dtype, device=h.device)
    if out.numel() == 0:
        return out
    # TMA reads each operand from a 16-byte-aligned address.
    aligned = all(t.data_ptr() % 16 == 0 for t in (h, p, w1, w2))
    pl = decode_plan(b, rows, n, d, hidden, h.dtype, aligned,
                     _build.sm_count(h.device))
    zh = zp = None
    if pl.body == "wgmma":   # float32 scratch of the shared products
        zh = torch.empty((b * rows, hidden), dtype=torch.float32,
                         device=h.device)
        zp = torch.empty((b * n, hidden), dtype=torch.float32,
                         device=h.device)
        tile = (pl.zh_rows, pl.zp_rows, pl.stages_a, pl.stages_b,
                pl.splits)
    else:
        tile = (pl.l_rows, pl.lanes, 0, 0, 0)
    err = _build.library().decode_demux_launch(
        h.data_ptr(), p.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
        zh.data_ptr() if zh is not None else None,
        zp.data_ptr() if zp is not None else None,
        _build.DTYPE_CODES[h.dtype], b, rows, n, d, hidden, BODIES[pl.body],
        *tile, _build.stream_of(h))
    _build.raise_on_error(name, err)
    _build.LAUNCHES[name] += 1
    return out
