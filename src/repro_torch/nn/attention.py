"""Multi-head attention (MHA / GQA / MQA) with RoPE — the port of the
reference's ``Attention`` class (``repro.nn.attention``).

Modes, chosen by the arguments as in the reference:

  * full sequence (training / forward):   ``cache is None``
  * prefill:    a cache is given and L > 1 — full attention over x, and
                K/V/positions written to cache rows [0, L)
  * decode:     a cache is given and L == 1 — K/V written at
                ``cache_index`` (a scalar, or a (B,) vector of per-slot
                positions), then attention over the cache
  * paged decode: the cache is a page pool (``init_paged_cache``) and a
                ``block_table`` maps each slot's page index to a pool page;
                writes and the attention go through the table
  * chunked decode: ``chunk_lens`` (B,) is given — L == C rows per slot,
                of which the first ``chunk_lens[b]`` are real

Conventions kept from the reference: RoPE rotates split halves; query head
``kv * n_rep + r`` reads KV head ``kv``; masked scores are filled with
``NEG_INF`` (not ``-inf``, so a row with no valid key is a finite uniform
average), softmax runs in float32 and the probabilities are cast to V's
dtype before the PV product.

Caches are dicts of tensors {"k", "v": (B, S, KVH, hd), "pos": (B, S)
int32, -1 = unwritten}, or page pools {"k_pages", "v_pages": (P, ps, KVH,
hd), "pos": (P, ps)}.  Where the reference returns a new cache (and the
serving engine donates the old one), the port writes into the given cache
in place and returns that same dict.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.nn.layers import Linear

NEG_INF = -1e30

# Above this many keys the full (B, H, Lq, Lk) float32 score tensor
# dominates memory; attention switches to the chunked online-softmax form.
CHUNKED_ATTN_THRESHOLD = 8192
CHUNK_SIZE = 1024


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    dim: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    causal: bool = True
    paged_kernel: bool = False  # paged decode: CUDA kernel vs plain gather
    kblock_pages: int = 1       # pages the paged kernel stages at a time
    softmax_scale: float | None = None

    @property
    def scale(self) -> float:
        return self.softmax_scale if self.softmax_scale is not None \
            else self.head_dim ** -0.5


def paged_eligible(window: int | None, max_len: int) -> bool:
    """Whether an attention layer's decode cache is paged under
    ``cfg.serving.paged``: full attention always; a windowed layer only when
    its ring would not be smaller than ``max_len`` (paging a bounded ring
    gains nothing and would break its ``pos % slots`` layout)."""
    return window is None or window >= max_len


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x, positions, theta: float):
    """x: (B, L, H, head_dim); positions: broadcastable to (B, L)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # (half,)
    angles = positions.float()[..., None] * freqs              # (B, L, half)
    cos = torch.cos(angles)[..., None, :]                      # (B, L, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Core soft-max attention
# ---------------------------------------------------------------------------

def _repeat_kv(k, n_rep: int):
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d) \
        .reshape(b, s, h * n_rep, d)


def dot_product_attention(q, k, v, mask, scale: float):
    """q: (B, Lq, H, hd)  k,v: (B, Lk, H, hd)  mask: (B, 1, Lq, Lk) bool."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def chunked_dot_product_attention(q, k, v, q_pos, k_pos, scale: float, *,
                                  causal: bool, chunk: int = CHUNK_SIZE):
    """Online-softmax attention over KV chunks with a running (max, sum,
    acc) — O(Lq·chunk) live scores instead of O(Lq·Lk).

    q: (B, Lq, H, hd); k, v: (B, Lk, H, hd); q_pos (B, Lq); k_pos (B, Lk).
    """
    b, lq, h, _ = q.shape
    hd_v = v.shape[-1]
    qf = q.float()
    m_run = torch.full((b, h, lq, 1), NEG_INF, dtype=torch.float32,
                       device=q.device)
    l_run = torch.zeros((b, h, lq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, lq, h, hd_v), dtype=torch.float32, device=q.device)
    for start in range(0, k.shape[1], chunk):
        kb = k[:, start:start + chunk].float()
        vb = v[:, start:start + chunk].float()
        pb = k_pos[:, start:start + chunk]
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kb) * scale
        if causal:
            keep = (q_pos[:, None, :, None] - pb[:, None, None, :]) >= 0
            s = s.masked_fill(~keep, NEG_INF)
        m_new = torch.maximum(m_run, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m_run - m_new)
        p = torch.exp(s - m_new)
        l_run = l_run * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha.transpose(1, 2) + \
            torch.einsum("bhqk,bkhd->bqhd", p, vb)
        m_run = m_new
    denom = torch.clamp(l_run, min=1e-30).transpose(1, 2)     # (B, Lq, H, 1)
    return (acc / denom).to(v.dtype)


def masked_chunk_write(cache, idx, row_ok, values: dict, pos_q) -> None:
    """Row-masked chunk write, in place: C rows per slot at ``idx`` (B, C)
    into each ``cache[key]`` (B, S, ...), keeping the existing entry
    wherever ``row_ok`` (B, C) is False — the invalid row writes back the
    value already there (gather, where, scatter), so it is an exact no-op.
    The rows of ``idx`` are distinct because C <= S, so the scatter is
    deterministic.  ``pos`` is merged the same way from ``pos_q``."""
    rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
    for key, new in values.items():
        old = cache[key][rows, idx]
        keep = row_ok.reshape(row_ok.shape + (1,) * (new.ndim - 2))
        cache[key][rows, idx] = torch.where(keep, new.to(old.dtype), old)
    cache["pos"][rows, idx] = torch.where(row_ok, pos_q,
                                          cache["pos"][rows, idx])


def make_attention_mask(q_pos, k_pos, *, causal: bool, k_valid=None):
    """Boolean (B, 1, Lq, Lk) mask from query/key positions.
    q_pos: (B, Lq); k_pos: (B, Lk); k_valid: optional (B, Lk) bool."""
    m = torch.ones((q_pos.shape[0], q_pos.shape[1], k_pos.shape[1]),
                   dtype=torch.bool, device=q_pos.device)
    if causal:
        m = m & ((q_pos[:, :, None] - k_pos[:, None, :]) >= 0)
    if k_valid is not None:
        m = m & k_valid[:, None, :]
    return m[:, None]


def _attend(q, k, v, positions, cfg: AttnConfig, n_rep: int):
    """Full attention of a (B, L) block over itself."""
    k, v = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    if q.shape[1] >= CHUNKED_ATTN_THRESHOLD:
        return chunked_dot_product_attention(
            q, k, v, positions, positions, cfg.scale, causal=cfg.causal)
    mask = make_attention_mask(positions, positions, causal=cfg.causal)
    return dot_product_attention(q, k, v, mask, cfg.scale)


# ---------------------------------------------------------------------------
# GQA attention block
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    """GQA/MQA/MHA with RoPE."""

    def __init__(self, cfg: AttnConfig, *, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        kw = dict(generator=generator, device=device, dtype=dtype)
        qd, kvd = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
        self.wq = Linear(cfg.dim, qd, bias=cfg.qkv_bias, **kw)
        self.wk = Linear(cfg.dim, kvd, bias=cfg.qkv_bias, **kw)
        self.wv = Linear(cfg.dim, kvd, bias=cfg.qkv_bias, **kw)
        self.wo = Linear(qd, cfg.dim, bias=False, **kw)

    @staticmethod
    def init_cache(cfg: AttnConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16, device=None) -> dict:
        shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        return {
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.full((batch, max_len), -1, dtype=torch.int32,
                              device=device),
        }

    @staticmethod
    def init_paged_cache(cfg: AttnConfig, pool_pages: int, page_size: int,
                         dtype=torch.bfloat16, device=None) -> dict:
        """Pooled K/V for paged decode: ``pool_pages`` pages of
        ``page_size`` positions, shared by every slot through a per-slot
        block table (held by the ``PagedKVSlotAllocator``, identical across
        layers).  ``pos`` holds each entry's written position, -1 =
        unwritten.  Page 0 is the allocator's trash page."""
        shape = (pool_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
        return {
            "k_pages": torch.zeros(shape, dtype=dtype, device=device),
            "v_pages": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.full((pool_pages, page_size), -1,
                              dtype=torch.int32, device=device),
        }

    def forward(self, x, *, positions, cache=None, cache_index=None,
                block_table=None, chunk_lens=None):
        """x: (B, L, D); positions: (B, L).  Returns (out, cache).
        ``block_table`` (B, max_pages) int32 routes a paged cache;
        ``chunk_lens`` (B,) makes this a chunked decode of L == C rows."""
        cfg = self.cfg
        b, l, _ = x.shape
        q = self.wq(x).reshape(b, l, cfg.n_heads, cfg.head_dim)
        k = self.wk(x).reshape(b, l, cfg.n_kv_heads, cfg.head_dim)
        v = self.wv(x).reshape(b, l, cfg.n_kv_heads, cfg.head_dim)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        n_rep = cfg.n_heads // cfg.n_kv_heads

        if cache is None:
            out = _attend(q, k, v, positions, cfg, n_rep)
        elif chunk_lens is not None:
            out = self._chunked_decode(q, k, v, positions, cache,
                                       chunk_lens, block_table, n_rep)
        elif "k_pages" in cache:
            out = self._paged_decode(q, k, v, positions, cache, cache_index,
                                     block_table)
        elif l > 1:
            # Prefill: full attention over x, and rows [0, L) of the cache
            # filled (in place).
            if l > cache["k"].shape[1]:
                raise ValueError(
                    f"prefill of {l} positions exceeds the cache's "
                    f"{cache['k'].shape[1]} rows")
            cache["k"][:, :l] = k.to(cache["k"].dtype)
            cache["v"][:, :l] = v.to(cache["v"].dtype)
            cache["pos"][:, :l] = positions.to(torch.int32)
            out = _attend(q, k, v, positions, cfg, n_rep)
        else:
            out = self._decode(q, k, v, positions, cache, cache_index, n_rep)

        out = out.reshape(b, l, cfg.n_heads * cfg.head_dim)
        return self.wo(out), cache

    def _decode(self, q, k, v, positions, cache, cache_index, n_rep):
        """Single-token decode: write this token's K/V at ``cache_index``
        (in place: the reference's engine donates the cache to get the
        same effect), then attend over every written row."""
        b = q.shape[0]
        slots = cache["k"].shape[1]
        ci = torch.as_tensor(cache_index, dtype=torch.int64,
                             device=q.device)
        slot = ci % slots
        pos_q = torch.broadcast_to(positions, (b, 1)).to(torch.int32)
        if ci.ndim:
            rows = torch.arange(b, device=q.device)
            cache["k"][rows, slot] = k[:, 0].to(cache["k"].dtype)
            cache["v"][rows, slot] = v[:, 0].to(cache["v"].dtype)
            cache["pos"][rows, slot] = pos_q[:, 0]
        else:
            # index_copy_ keeps the index on the device (indexing with a
            # 0-d tensor would read it back to the host every layer).
            slot = slot.reshape(1)
            cache["k"].index_copy_(1, slot, k.to(cache["k"].dtype))
            cache["v"].index_copy_(1, slot, v.to(cache["v"].dtype))
            cache["pos"].index_copy_(1, slot, pos_q)
        pos = cache["pos"]
        mask = make_attention_mask(pos_q, pos, causal=self.cfg.causal,
                                   k_valid=pos >= 0)
        return dot_product_attention(
            q, _repeat_kv(cache["k"].to(q.dtype), n_rep),
            _repeat_kv(cache["v"].to(q.dtype), n_rep), mask, self.cfg.scale)

    def _paged_attend(self, q, cache, block_table, pos_q):
        from repro_torch.kernels.paged_attention import ops as paged_ops
        cfg = self.cfg
        return paged_ops.paged_attention(
            q, cache["k_pages"], cache["v_pages"], cache["pos"], block_table,
            pos_q, scale=cfg.scale, causal=cfg.causal,
            use_kernel=cfg.paged_kernel, kblock_pages=cfg.kblock_pages)

    def _paged_decode(self, q, k, v, positions, cache, cache_index,
                      block_table):
        """Single-token paged decode: write this token's K/V/pos through the
        block table to (page, offset) in place, then attend over the slot's
        pages.  The gather reassembles each slot's pages in position order,
        so the result is bitwise the contiguous cache's."""
        if block_table is None:
            raise ValueError("a paged cache needs a block_table")
        b, l = q.shape[:2]
        if l != 1:
            raise ValueError(f"a paged cache takes single-token or chunked "
                             f"decode, got {l} rows without chunk_lens")
        ps = cache["pos"].shape[1]
        ci = torch.as_tensor(cache_index, dtype=torch.int64,
                             device=q.device).expand(b)
        rows = torch.arange(b, device=q.device)
        page_idx = (ci // ps).clamp(0, block_table.shape[1] - 1)
        # Slots with no mapped page (emptied, masked out upstream by the
        # lane mask) write to the reserved trash page 0.  Several such slots
        # can write the same (page, offset), and on the card which write
        # lands is unspecified; that is harmless only because no block table
        # ever maps page 0.
        page_ids = block_table[rows, page_idx].clamp(min=0).long()
        off = ci % ps
        pos_q = torch.broadcast_to(positions, (b, 1)).to(torch.int32)
        cache["k_pages"][page_ids, off] = k[:, 0].to(cache["k_pages"].dtype)
        cache["v_pages"][page_ids, off] = v[:, 0].to(cache["v_pages"].dtype)
        cache["pos"][page_ids, off] = pos_q[:, 0]
        return self._paged_attend(q, cache, block_table, pos_q)

    def _chunked_decode(self, q, k, v, positions, cache, chunk_lens,
                        block_table, n_rep):
        """Multi-token decode: write up to C cache rows per slot, then
        attend each chunk row over the whole (updated) cache.

        q: (B, C, H, hd); k/v: (B, C, KVH, hd); positions: (B, C) absolute;
        chunk_lens: (B,) valid rows per slot.  Rows ``i >= chunk_lens[b]``
        must not disturb the cache: a contiguous cache takes a gather ->
        where -> scatter (``masked_chunk_write``); a paged cache sends them
        to the trash page.  Row i's causal mask covers rows <= i of the same
        chunk, which are written before the attention runs, so a C-wide
        ramp is exactly the C sequential single-token steps."""
        b, c = positions.shape
        row_ok = torch.arange(c, device=q.device)[None, :] < \
            torch.as_tensor(chunk_lens, device=q.device)[:, None]
        pos_q = positions.to(torch.int32)

        if "k_pages" in cache:
            if block_table is None:
                raise ValueError("a paged cache needs a block_table")
            ps = cache["pos"].shape[1]
            rows = torch.arange(b, device=q.device)[:, None]
            page_idx = (pos_q.long() // ps).clamp(0, block_table.shape[1] - 1)
            page_ids = block_table[rows, page_idx].clamp(min=0).long()
            # Invalid rows go to the trash page (duplicate writes there race
            # on the card; harmless, no block table maps page 0).
            page_ids = torch.where(row_ok, page_ids, 0)
            off = pos_q.long() % ps
            cache["k_pages"][page_ids, off] = k.to(cache["k_pages"].dtype)
            cache["v_pages"][page_ids, off] = v.to(cache["v_pages"].dtype)
            cache["pos"][page_ids, off] = torch.where(row_ok, pos_q, -1)
            return self._paged_attend(q, cache, block_table, pos_q)

        slots = cache["k"].shape[1]
        masked_chunk_write(cache, pos_q.long() % slots, row_ok,
                           {"k": k, "v": v}, pos_q)
        pos = cache["pos"]
        mask = make_attention_mask(pos_q, pos, causal=self.cfg.causal,
                                   k_valid=pos >= 0)
        return dot_product_attention(
            q, _repeat_kv(cache["k"].to(q.dtype), n_rep),
            _repeat_kv(cache["v"].to(q.dtype), n_rep), mask, self.cfg.scale)
