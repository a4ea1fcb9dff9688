"""Launch wrapper of the CUDA paged decode attention
(``repro_torch/csrc/paged_decode_attention.cu``), and the shared-memory
arithmetic that bounds its K-block.

One thread block per (slot, KV head) holds the slot's C * n_rep query rows
and stages ``kblock_pages`` pool pages of K and V at a time in shared
memory; ``smem_bytes`` mirrors the source's layout, so a shape the block
cannot hold raises here instead of failing at launch.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

# Shared memory one block can use on Hopper (227 KB of the SM's 256 KB).
SMEM_LIMIT = 232448
# The K+V stage may take at most half of it; the query rows, their scores
# and the f32 accumulator take the rest.
KBLOCK_STAGE_BUDGET = SMEM_LIMIT // 2


def stage_bytes(kblock_pages: int, page_size: int, head_dim: int,
                itemsize: int) -> int:
    """Shared memory of one staged K-block: K and V rows (each padded by
    16 bytes) and their int32 positions."""
    rows = kblock_pages * page_size
    return 2 * rows * (head_dim * itemsize + 16) + 4 * rows


def smem_bytes(rows: int, head_dim: int, kblock_pages: int, page_size: int,
               itemsize: int) -> int:
    """The block's whole claim for ``rows`` = C * n_rep query rows: the
    stage, q and acc (f32), the scores, the softmax state."""
    kb_rows = kblock_pages * page_size
    return stage_bytes(kblock_pages, page_size, head_dim, itemsize) + 4 * (
        2 * rows * head_dim + rows * kb_rows + 3 * rows)


def validate_kblock(kblock_pages: int, page_size: int, head_dim: int, *,
                    itemsize: int = 2) -> None:
    """Raise when a ``kblock_pages x page_size x head_dim`` K+V stage does
    not fit the kernel's shared-memory budget, naming the knob to turn."""
    if kblock_pages < 1:
        raise ValueError(f"kblock_pages must be >= 1, got {kblock_pages}")
    claim = stage_bytes(kblock_pages, page_size, head_dim, itemsize)
    if claim > KBLOCK_STAGE_BUDGET:
        fit = 1
        while stage_bytes(fit + 1, page_size, head_dim, itemsize) \
                <= KBLOCK_STAGE_BUDGET:
            fit += 1
        raise ValueError(
            f"paged decode K-block of kblock_pages={kblock_pages} x "
            f"page_size={page_size} x head_dim={head_dim} stages {claim} "
            f"bytes of shared memory; the kernel's budget for the K+V stage "
            f"is {KBLOCK_STAGE_BUDGET} bytes (half of Hopper's {SMEM_LIMIT} "
            f"per block); lower kblock_pages to <= {fit} or shrink "
            f"page_size")


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
    if kvh < 1 or h % kvh:
        raise ValueError(f"{name}: {h} query heads do not group over {kvh} "
                         f"KV heads")
    if window is not None and window < 0:
        raise ValueError(f"{name}: window must be >= 0, got {window}")
    _build.check_inputs(name, q.dtype, q=q, k_pages=k_pages, v_pages=v_pages)
    _build.check_inputs(name, torch.int32, pos_pages=pos_pages,
                        block_table=block_table, q_pos=q_pos)
    if q.device != pos_pages.device:
        raise ValueError(f"{name}: float and index inputs are on "
                         f"{q.device} and {pos_pages.device}")
    per_vec = 16 // q.element_size()
    if hd % per_vec:
        raise ValueError(f"{name}: head_dim {hd} is not a multiple of "
                         f"{per_vec} ({q.dtype} elements per 16-byte load)")
    validate_kblock(kblock_pages, ps, hd, itemsize=q.element_size())
    smem = smem_bytes(c * (h // kvh), hd, kblock_pages, ps,
                      q.element_size())
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"{name}: C={c} x n_rep={h // kvh} query rows at head_dim={hd} "
            f"with kblock_pages={kblock_pages} x page_size={ps} need {smem} "
            f"bytes of shared memory per block (limit {SMEM_LIMIT}); lower "
            f"prefill_chunk or kblock_pages")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    err = _build.library().paged_decode_attention_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        pos_pages.data_ptr(), block_table.data_ptr(), q_pos.data_ptr(),
        out.data_ptr(), _build.DTYPE_CODES[q.dtype], b, c, h, kvh, hd, ps,
        block_table.shape[1], kblock_pages, scale, int(causal),
        -1 if window is None else window, _build.stream_of(q))
    _build.raise_on_error(name, err)
    _build.LAUNCHES[name] += 1
    return out
