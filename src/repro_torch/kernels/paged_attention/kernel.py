"""Launch plan and wrapper of the CUDA paged decode attention
(``repro_torch/csrc/paged_decode_attention.cu``), and the shared-memory
arithmetic that bounds its K-block.

The block-table axis of each (slot, KV head) is split over ``splits``
blocks of one thread-block cluster; each block streams its run of
``entries`` block-table entries, ``kblock_pages`` pages at a time, through
a ring of ``stages`` K+V stages in shared memory, and rank 0 merges the
blocks' partial softmax states.  ``smem_bytes`` mirrors the source's
layout and ``plan`` chooses the split before launch, so a shape the kernel
cannot take raises here instead of failing at launch.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.kernels import _build

# Shared memory one block can use on Hopper (227 KB of the SM's 256 KB).
SMEM_LIMIT = 232448
# The ring of K+V stages may take at most half of it; the query rows and
# the partial softmax states take the rest.
KBLOCK_STAGE_BUDGET = SMEM_LIMIT // 2
MIN_STAGES, MAX_STAGES = 3, 4   # ring depth: >= 3 keeps two loads ahead
MAX_SPLITS = 8                  # blocks per cluster (the portable maximum)
MAX_ROWS = 16                   # C * n_rep query rows a block holds
CONSUMER_WARPS = 4
H100_SMS = 132
DTYPES = (torch.float32, torch.bfloat16)


def page_tile_bytes(page_size: int, head_dim: int, itemsize: int) -> int:
    """One staged page of one KV head, rounded up to 128 bytes (a TMA
    destination's alignment)."""
    return -(-page_size * head_dim * itemsize // 128) * 128


def stage_bytes(kblock_pages: int, page_size: int, head_dim: int,
                itemsize: int) -> int:
    """Shared memory of one ring stage: the K and V pages of a K-block."""
    return 2 * kblock_pages * page_tile_bytes(page_size, head_dim, itemsize)


def smem_bytes(rows: int, head_dim: int, kblock_pages: int, page_size: int,
               itemsize: int, stages: int, entries: int) -> int:
    """The block's whole claim for ``rows`` = C * n_rep query rows and
    ``entries`` block-table entries per split: 1024 bytes of alignment
    slack, the ring, q (f32), the consumer warps' partial accumulators,
    maxima and sums, the block's merged partial, the split's entries and
    their key positions (int32), the barriers."""
    return (1024 + stages * stage_bytes(kblock_pages, page_size, head_dim,
                                        itemsize)
            + 4 * (rows * head_dim + CONSUMER_WARPS * rows * (head_dim + 2)
                   + rows * (head_dim + 2) + entries * (1 + page_size))
            + 8 + 16 * stages)


def validate_kblock(kblock_pages: int, page_size: int, head_dim: int, *,
                    itemsize: int = 2) -> None:
    """Raise when a ring of ``MIN_STAGES`` K+V stages of ``kblock_pages x
    page_size x head_dim`` does not fit the kernel's shared-memory budget,
    naming the knob to turn."""
    if kblock_pages < 1:
        raise ValueError(f"kblock_pages must be >= 1, got {kblock_pages}")
    claim = MIN_STAGES * stage_bytes(kblock_pages, page_size, head_dim,
                                     itemsize)
    if claim > KBLOCK_STAGE_BUDGET:
        fit = 0
        while MIN_STAGES * stage_bytes(fit + 1, page_size, head_dim,
                                       itemsize) <= KBLOCK_STAGE_BUDGET:
            fit += 1
        raise ValueError(
            f"paged decode K-block of kblock_pages={kblock_pages} x "
            f"page_size={page_size} x head_dim={head_dim} needs {claim} "
            f"bytes of shared memory for its {MIN_STAGES}-stage ring; the "
            f"kernel's budget for the ring is {KBLOCK_STAGE_BUDGET} bytes "
            f"(half of Hopper's {SMEM_LIMIT} per block); lower kblock_pages "
            f"to <= {fit} or shrink page_size")


@dataclasses.dataclass(frozen=True)
class PagedPlan:
    splits: int        # blocks per (slot, KV head): one cluster
    entries: int       # block-table entries per split, a multiple of kblock
    stages: int        # ring depth
    rows: int          # C * n_rep query rows per block
    smem: int          # shared-memory bytes per block
    grid: tuple        # (splits, KVH, B)

    def split_entries(self, split: int, max_pages: int) -> range:
        """The block-table entries split ``split`` walks."""
        start = split * self.entries
        return range(start, min(start + self.entries, max_pages))


def plan(b: int, c: int, h: int, kvh: int, hd: int, ps: int, max_pages: int,
         kblock: int, dtype: torch.dtype, sms: int = H100_SMS) -> PagedPlan:
    """The paged kernel's launch for q (B, C, H, hd) over (P, ps, KVH, hd)
    pages and a (B, max_pages) block table, on a card of ``sms`` SMs: up
    to ``MAX_SPLITS`` splits per (slot, KV head), as many as give the card
    ~4 blocks per SM, none of them empty.  Raises on what the kernel does
    not take (a table so long that a split's entries and positions
    overflow shared memory among it)."""
    name = "paged_decode_attention"
    if dtype not in DTYPES:
        raise TypeError(f"{name}: dtype {dtype} not supported; the kernel "
                        f"takes {sorted(map(str, DTYPES))}")
    if kvh < 1 or h % kvh:
        raise ValueError(f"{name}: {h} query heads do not group over {kvh} "
                         f"KV heads")
    itemsize = torch.empty((), dtype=dtype).element_size()
    per_vec = 16 // itemsize
    if hd % per_vec:
        raise ValueError(f"{name}: head_dim {hd} is not a multiple of "
                         f"{per_vec} ({dtype} elements per 16-byte load)")
    lanes = hd // per_vec   # lanes holding one key row, 16 bytes each
    if lanes > 32 or lanes & (lanes - 1):
        raise ValueError(f"{name}: head_dim {hd} in {dtype} is {lanes} "
                         f"16-byte loads per key row; the kernel takes a "
                         f"power of two up to 32")
    if not 1 <= ps <= 256:
        raise ValueError(f"{name}: page_size {ps} outside the TMA box's "
                         f"1..256 rows")
    rows = c * (h // kvh)
    if not 1 <= rows <= MAX_ROWS:
        raise ValueError(f"{name}: C={c} x n_rep={h // kvh} = {rows} query "
                         f"rows per block; the kernel holds 1..{MAX_ROWS}; "
                         f"lower prefill_chunk")
    validate_kblock(kblock, ps, hd, itemsize=itemsize)
    stages = MAX_STAGES if MAX_STAGES * stage_bytes(
        kblock, ps, hd, itemsize) <= KBLOCK_STAGE_BUDGET else MIN_STAGES
    n_kblocks = max(1, -(-max_pages // kblock))
    want = max(1, -(-4 * sms // (b * kvh)))
    splits = min(MAX_SPLITS, n_kblocks, want)
    per = -(-n_kblocks // splits)
    splits = -(-n_kblocks // per)            # no split without entries
    smem = smem_bytes(rows, hd, kblock, ps, itemsize, stages, per * kblock)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"{name}: C={c} x n_rep={h // kvh} query rows at head_dim={hd} "
            f"with kblock_pages={kblock} x page_size={ps} need {smem} bytes "
            f"of shared memory per block (limit {SMEM_LIMIT}); lower "
            f"prefill_chunk or kblock_pages")
    if max(kvh, b) > 65535:
        raise ValueError(f"{name}: B={b} or KVH={kvh} exceeds the launch "
                         f"grid")
    return PagedPlan(splits, per * kblock, stages, rows, smem,
                     (splits, kvh, b))


def paged_decode_attention(q, k_pages, v_pages, pos_pages, block_table,
                           q_pos, *, scale: float, causal: bool = True,
                           window: Optional[int] = None,
                           kblock_pages: int = 1) -> torch.Tensor:
    """q: (B, C, H, hd); k_pages/v_pages: (P, ps, KVH, hd) of q's dtype;
    pos_pages: (P, ps), block_table: (B, max_pages) and q_pos: (B, C), all
    int32.  Returns (B, C, H, hd).  ``kblock_pages`` only sets how many
    block-table entries are staged at a time."""
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
    pl = plan(b, c, h, kvh, hd, ps, max_pages, kblock_pages, q.dtype,
              sms=_build.sm_count(q.device) if q.is_cuda else H100_SMS)
    _build.check_inputs(name, q.dtype, q=q, k_pages=k_pages, v_pages=v_pages)
    _build.check_inputs(name, torch.int32, pos_pages=pos_pages,
                        block_table=block_table, q_pos=q_pos)
    if q.device != pos_pages.device:
        raise ValueError(f"{name}: float and index inputs are on "
                         f"{q.device} and {pos_pages.device}")
    if (k_pages.data_ptr() | v_pages.data_ptr()) % 16:
        raise ValueError(f"{name}: the page pools must start on 16-byte "
                         f"boundaries (TMA)")
    if max_pages == 0:      # no key anywhere: every row is a dead row
        return torch.zeros_like(q)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    err = _build.library().paged_decode_attention_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        pos_pages.data_ptr(), block_table.data_ptr(), q_pos.data_ptr(),
        out.data_ptr(), _build.DTYPE_CODES[q.dtype], b, c, h, kvh, hd, ps,
        max_pages, kblock_pages, scale, int(causal),
        -1 if window is None else window, pl.splits, pl.entries, pl.stages,
        pool, _build.stream_of(q))
    _build.raise_on_error(name, err)
    _build.LAUNCHES[name] += 1
    return out
