"""Plain PyTorch version of paged-attention decode: gather from the block
table, then the contiguous decode path's expressions.

Each slot's pages are reassembled into position order and then run through
exactly the expression sequence of the contiguous decode in
``repro_torch.nn.attention`` (einsum, f32 scale, ``NEG_INF`` fill, f32
softmax, cast to V's dtype, einsum), so on a pool that mirrors a contiguous
cache the output is bit-for-bit the contiguous result: masked (unwritten or
unmapped) entries contribute an exact 0 whatever stale values the pool
holds.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.nn.attention import NEG_INF, _repeat_kv


def gather_pages(pages, block_table):
    """pages: (P, ps, ...) pool; block_table: (B, max_pages) int (-1 =
    unmapped).  Returns (B, max_pages * ps, ...) in position order: entry
    j*ps+o of row b is position j*ps+o of slot b's stream."""
    g = pages[block_table.clamp(min=0).long()]       # (B, mp, ps, ...)
    return g.reshape((g.shape[0], -1) + tuple(g.shape[3:]))


def gather_positions(pos_pages, block_table):
    """Written-position array of the gathered view; unmapped pages read as
    -1 (never written), so stale pool contents cannot leak into the mask."""
    g = pos_pages[block_table.clamp(min=0).long()]   # (B, mp, ps)
    g = torch.where(block_table[:, :, None] >= 0, g, -1)
    return g.reshape(g.shape[0], -1)


def paged_attention(q, k_pages, v_pages, pos_pages, block_table, q_pos, *,
                    scale: float, causal: bool = True,
                    window: Optional[int] = None):
    """Decode attention over a paged KV pool for a C-row query block
    (C == 1: single-token decode; C > 1: chunked prefill).

    q: (B, C, H, hd) post-RoPE queries; k_pages/v_pages: (P, ps, KVH, hd);
    pos_pages: (P, ps) int32 written positions (-1 = unwritten);
    block_table: (B, max_pages) int32 pool-page ids (-1 = unmapped);
    q_pos: (B, C) int32 absolute query positions.  Returns (B, C, H, hd).

    Rows with zero valid keys (an emptied slot) are a uniform average of
    garbage; callers mask those lanes out, as on the contiguous path.
    """
    n_rep = q.shape[2] // k_pages.shape[2]
    k = _repeat_kv(gather_pages(k_pages, block_table).to(q.dtype), n_rep)
    v = _repeat_kv(gather_pages(v_pages, block_table).to(q.dtype), n_rep)
    k_pos = gather_positions(pos_pages, block_table)

    diff = q_pos[:, :, None] - k_pos[:, None, :]     # (B, C, S)
    mask = (k_pos >= 0)[:, None, :].expand_as(diff)
    if causal:
        mask = mask & (diff >= 0)
    if window is not None:
        mask = mask & (diff < window)
    mask = mask[:, None]                             # (B, 1, C, S)

    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)
