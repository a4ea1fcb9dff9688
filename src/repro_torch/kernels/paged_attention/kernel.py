"""Launch plan and wrapper of the CUDA paged decode attention
(``repro_torch/csrc/paged_decode_attention.cu``), and the port's copy of
the reference's K-block check.

The block-table axis of each (slot, KV head, row group) is split over
``splits`` blocks of one thread-block cluster; each block streams the
mapped pages of its run of ``entries`` block-table entries through a ring
of ``stages`` stages in shared memory, one TMA box (up to 256 rows) of one
page per stage, and the cluster's blocks merge their partial softmax
states.  The query rows C * n_rep are cut into groups of at most 16, one
block each.  ``smem_bytes`` mirrors the source's layout and ``plan``
chooses the launch, so what no launch can take raises here instead of
failing at launch.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.kernels import _build

# Shared memory one block can use on Hopper (227 KB of the SM's 256 KB).
SMEM_LIMIT = 232448
# The reference's K-block budget (``repro.kernels.tiling.VMEM_BUDGET``, a
# TPU core's VMEM less headroom): ``validate_kblock`` keeps its arithmetic,
# so the port accepts exactly the kblock_pages the reference accepts.
# Shared memory does not depend on kblock_pages here.
KBLOCK_BUDGET = 12 * 2 ** 20
STAGE_CHOICES = (4, 3)          # ring depth: >= 3 keeps two loads ahead
MAX_SPLITS = 8                  # blocks per cluster (the portable maximum)
MAX_BOX_ROWS = 256              # rows of a TMA box
MAX_HEAD_DIM = 256
CONSUMER_WARPS = 4
H100_SMS = 132
MAX_GRID_YZ = 65535
DTYPES = (torch.float32, torch.bfloat16)


def kblock_claim(kblock_pages: int, page_size: int, head_dim: int,
                 itemsize: int = 2) -> int:
    """The reference's resident K-block claim: K and V tiles of
    ``kblock_pages`` pages plus their int32 position rows."""
    rows = kblock_pages * page_size
    return rows * head_dim * itemsize * 2 + rows * 4


def validate_kblock(kblock_pages: int, page_size: int, head_dim: int, *,
                    itemsize: int = 2) -> None:
    """Raise on a K-block the reference refuses (its claim above 12 MiB),
    naming the knob to turn; accept every other."""
    if kblock_pages < 1:
        raise ValueError(f"kblock_pages must be >= 1, got {kblock_pages}")
    claim = kblock_claim(kblock_pages, page_size, head_dim, itemsize)
    if claim > KBLOCK_BUDGET:
        fit = 1
        while kblock_claim(2 * fit, page_size, head_dim,
                           itemsize) <= KBLOCK_BUDGET:
            fit *= 2
        raise ValueError(
            f"paged decode K-block of kblock_pages={kblock_pages} x "
            f"page_size={page_size} x head_dim={head_dim} claims "
            f"{claim / 2 ** 20:.1f} MiB (budget "
            f"{KBLOCK_BUDGET / 2 ** 20:.1f} MiB, the reference's); lower "
            f"kblock_pages to <= {fit} or shrink page_size")


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def stage_bytes(box_rows: int, head_dim: int, itemsize: int) -> int:
    """One ring stage: a K and a V box of ``box_rows`` key rows (each row
    padded to 16 bytes) and the box's int32 key positions, each part
    rounded up to 128 bytes (a TMA destination's alignment)."""
    row = _round_up(head_dim * itemsize, 16)
    return (2 * _round_up(box_rows * row, 128)
            + _round_up(box_rows * 4, 128))


def smem_bytes(group_rows: int, head_dim: int, box_rows: int, itemsize: int,
               stages: int, table_entries: int) -> int:
    """The block's whole claim, as the source lays it out: 1024 bytes of
    alignment slack, the ring, q (f32), the consumer warps' partial
    accumulators, maxima and sums, the block's merged partial, the
    split's table entries (int32), the barriers.  q and the partials are
    ``hdp`` = head_dim padded to 16 bytes wide."""
    hdp = _round_up(head_dim * itemsize, 16) // itemsize
    gr = group_rows
    return (1024 + stages * stage_bytes(box_rows, head_dim, itemsize)
            + 4 * (gr * hdp + CONSUMER_WARPS * gr * (hdp + 2)
                   + gr * (hdp + 2) + table_entries)
            + 8 + 16 * stages)


@dataclasses.dataclass(frozen=True)
class PagedPlan:
    splits: int        # blocks per (slot, KV head, row group): one cluster
    entries: int       # block-table entries per split, a multiple of kblock
    stages: int        # ring depth
    rows: int          # R = C * n_rep query rows per (slot, KV head)
    groups: int        # row groups: blocks along z per slot
    group_rows: int    # rows per group (the last may hold fewer)
    reg_rows: int      # rows the kernel instantiation holds in registers
    box_rows: int      # key rows per ring stage (one TMA box of one page)
    lanes: int         # G: lanes holding one key row (a power of two)
    vpl: int           # 16-byte vectors of a key row per lane
    body: str          # "tma" or "copy" (16-byte-padded plain copies)
    smem: int          # shared-memory bytes per block
    grid: tuple        # (splits, KVH, B * groups)

    def split_entries(self, split: int, max_pages: int) -> range:
        """The block-table entries split ``split`` walks."""
        start = split * self.entries
        return range(start, min(start + self.entries, max_pages))

    def group_range(self, group: int) -> range:
        """The query rows r = c * n_rep + rep that row group ``group``
        computes."""
        start = group * self.group_rows
        return range(start, min(start + self.group_rows, self.rows))

    def boxes(self, page_size: int) -> list[range]:
        """The key rows of a page, one range per ring stage."""
        return [range(o, min(o + self.box_rows, page_size))
                for o in range(0, page_size, self.box_rows)]


def plan(b: int, c: int, h: int, kvh: int, hd: int, ps: int, max_pages: int,
         kblock: int, dtype: torch.dtype, aligned: bool = True,
         sms: int = H100_SMS) -> PagedPlan:
    """The paged kernel's launch for q (B, C, H, hd) over (P, ps, KVH, hd)
    pages and a (B, max_pages) block table, on a card of ``sms`` SMs.

    Rows: R = C * n_rep in ceil(R / 16) balanced groups (16 -> 8 where a
    lane holds two vectors).  Key rows: hd * itemsize bytes, ``vecs``
    16-byte vectors (padded), over a lane group of the next power of two
    of ceil(vecs / vpl) lanes, vpl = 2 only above 32 vectors.  Ring: a
    stage is one box of one page, the largest box of <= 256 rows that
    fits 4 (else 3) stages beside the rest.  Splits: up to ``MAX_SPLITS``
    per (slot, KV head, group), as many as give the card ~4 blocks per
    SM, none empty.  Body: TMA where the key row and both pools are on
    16-byte boundaries, else plain copies.  Raises on what no launch can
    take: another dtype, heads that do not group, hd outside 1..256, a
    table too long for a split's entries in shared memory."""
    name = "paged_decode_attention"
    if dtype not in DTYPES:
        raise TypeError(f"{name}: dtype {dtype} not supported; the kernel "
                        f"takes {sorted(map(str, DTYPES))}")
    if kvh < 1 or h % kvh:
        raise ValueError(f"{name}: {h} query heads do not group over {kvh} "
                         f"KV heads")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"{name}: head_dim {hd} outside 1..{MAX_HEAD_DIM}")
    if min(b, c, ps, max_pages) < 1:
        raise ValueError(f"{name}: empty input, B={b} C={c} page_size={ps} "
                         f"max_pages={max_pages}")
    itemsize = torch.empty((), dtype=dtype).element_size()
    validate_kblock(kblock, ps, hd, itemsize=itemsize)
    vecs = -(-hd * itemsize // 16)
    vpl = 1 if vecs <= 32 else 2
    lanes = 1 << (-(-vecs // vpl) - 1).bit_length()
    body = "tma" if aligned and hd * itemsize % 16 == 0 else "copy"

    rows = c * (h // kvh)
    max_group = 16 // vpl
    groups = -(-rows // max_group)
    group_rows = -(-rows // groups)
    if body == "copy":
        reg_rows = max_group
    else:
        reg_rows = next(r for r in (1, 4, max_group) if r >= group_rows)
    if b * groups > MAX_GRID_YZ or kvh > MAX_GRID_YZ:
        raise ValueError(f"{name}: B={b} x {groups} row groups or KVH="
                         f"{kvh} exceeds the launch grid")

    n_kblocks = -(-max_pages // kblock)
    want = max(1, -(-4 * sms // (b * kvh * groups)))
    splits = min(MAX_SPLITS, n_kblocks, want)
    per = -(-n_kblocks // splits)
    splits = -(-n_kblocks // per)            # no split without entries
    entries = per * kblock
    table = min(entries, max_pages)

    for n_boxes in range(-(-ps // MAX_BOX_ROWS), ps + 1):
        box_rows = -(-ps // n_boxes)
        for stages in STAGE_CHOICES:
            smem = smem_bytes(group_rows, hd, box_rows, itemsize, stages,
                              table)
            if smem <= SMEM_LIMIT:
                return PagedPlan(splits, entries, stages, rows, groups,
                                 group_rows, reg_rows, box_rows, lanes, vpl,
                                 body, smem, (splits, kvh, b * groups))
    raise ValueError(f"{name}: a split of {table} block-table entries does "
                     f"not fit shared memory beside a ring of one-row "
                     f"boxes; shorten the table")


def paged_decode_attention(q, k_pages, v_pages, pos_pages, block_table,
                           q_pos, *, scale: float, causal: bool = True,
                           window: Optional[int] = None,
                           kblock_pages: int = 1) -> torch.Tensor:
    """q: (B, C, H, hd); k_pages/v_pages: (P, ps, KVH, hd) of q's dtype;
    pos_pages: (P, ps), block_table: (B, max_pages) and q_pos: (B, C), all
    int32.  Returns (B, C, H, hd).  ``kblock_pages`` only sets where the
    block table is split between a cluster's blocks (entries per split are
    a multiple of it), so the output does not depend on it beyond float
    rounding."""
    name = "paged_decode_attention"
    b, c, h, hd = q.shape
    pool, ps, kvh, _ = k_pages.shape
    want = {"k_pages": (pool, ps, kvh, hd), "v_pages": (pool, ps, kvh, hd),
            "pos_pages": (pool, ps), "block_table": (b, block_table.shape[1]),
            "q_pos": (b, c)}
    got = {"k_pages": k_pages, "v_pages": v_pages, "pos_pages": pos_pages,
           "block_table": block_table, "q_pos": q_pos}
    for arg, shape in want.items():
        if tuple(got[arg].shape) != shape:
            raise ValueError(f"{name}: {arg} is {tuple(got[arg].shape)}, "
                             f"expected {shape}")
    if window is not None and window < 0:
        raise ValueError(f"{name}: window must be >= 0, got {window}")
    max_pages = block_table.shape[1]
    _build.check_inputs(name, q.dtype, q=q, k_pages=k_pages, v_pages=v_pages)
    _build.check_inputs(name, torch.int32, pos_pages=pos_pages,
                        block_table=block_table, q_pos=q_pos)
    if q.device != pos_pages.device:
        raise ValueError(f"{name}: float and index inputs are on "
                         f"{q.device} and {pos_pages.device}")
    out = torch.empty_like(q)
    if max_pages == 0:      # no key anywhere: every row is a dead row
        return out.zero_()
    if out.numel() == 0:
        return out
    aligned = (k_pages.data_ptr() | v_pages.data_ptr()) % 16 == 0
    pl = plan(b, c, h, kvh, hd, ps, max_pages, kblock_pages, q.dtype,
              aligned, sms=_build.sm_count(q.device))
    err = _build.library().paged_decode_attention_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        pos_pages.data_ptr(), block_table.data_ptr(), q_pos.data_ptr(),
        out.data_ptr(), _build.DTYPE_CODES[q.dtype], b, c, h, kvh, hd, ps,
        max_pages, scale, int(causal), -1 if window is None else window,
        pl.splits, pl.entries, pl.stages, pl.groups, pl.group_rows,
        pl.box_rows, pl.lanes, pl.vpl, pl.reg_rows,
        int(pl.body == "tma"), pl.smem, pool, _build.stream_of(q))
    _build.raise_on_error(name, err)
    _build.LAUNCHES[name] += 1
    return out
