"""Multi-head attention (MHA / GQA / MQA) with RoPE, cross-attention over
a precomputed context, and DeepSeek's Multi-head Latent Attention — the
port of the reference's ``Attention``, ``CrossAttention`` and ``MLA``
classes (``repro.nn.attention``).

Modes, chosen by the arguments as in the reference:

  * full sequence (training / forward):   ``cache is None``; with
                ``use_flash``, ``causal`` and no window through the flash
                kernel
  * prefill:    a cache is given and L > 1 — full attention over x, and
                K/V/positions written to the cache: rows [0, L), or, when
                L exceeds a window ring, the last ``slots`` positions at
                row ``p % slots``
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

A layer with a sliding ``window`` masks keys at ``q_pos - k_pos >=
window`` and keeps a ring of ``min(window, max_len)`` cache rows, position
p at row ``p % slots``.

Caches are dicts of tensors {"k", "v": (B, S, KVH, hd), "pos": (B, S)
int32, -1 = unwritten}, or page pools {"k_pages", "v_pages": (P, ps, KVH,
hd), "pos": (P, ps)}.  Where the reference returns a new cache (and the
serving engine donates the old one), the port writes into the given cache
in place and returns that same dict.  ``MLA`` takes the same modes over a
latent cache {"ckv": (B, S, r), "krope": (B, S, rope), "pos"} or pool
{"ckv_pages", "krope_pages", "pos"} (see its docstring).
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.nn.layers import Linear, profiler_label

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
    window: int | None = None   # sliding-window size; None = full attention
    use_flash: bool = False     # cache-free causal full attention through
                                # the flash kernel
    paged_kernel: bool = False  # paged decode: CUDA kernel vs plain gather
    kblock_pages: int = 1       # pages the paged kernel stages at a time
    softmax_scale: float | None = None

    @property
    def scale(self) -> float:
        return self.softmax_scale if self.softmax_scale is not None \
            else self.head_dim ** -0.5


def cache_rows(window: int | None, max_len: int) -> int:
    """Rows of a layer's contiguous decode cache: a windowed layer keeps a
    ring of ``min(window, max_len)`` rows, any other ``max_len``."""
    return min(window, max_len) if window else max_len


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
                                  causal: bool, window: int | None = None,
                                  chunk: int = CHUNK_SIZE):
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
        diff = q_pos[:, None, :, None] - pb[:, None, None, :]
        keep = torch.ones_like(diff, dtype=torch.bool)
        if causal:
            keep = keep & (diff >= 0)
        if window is not None:
            keep = keep & (diff < window)
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


def make_attention_mask(q_pos, k_pos, *, causal: bool,
                        window: int | None = None, k_valid=None):
    """Boolean (B, 1, Lq, Lk) mask from query/key positions.
    q_pos: (B, Lq); k_pos: (B, Lk); k_valid: optional (B, Lk) bool (ring
    rows not written yet)."""
    diff = q_pos[:, :, None] - k_pos[:, None, :]
    m = torch.ones(diff.shape, dtype=torch.bool, device=q_pos.device)
    if causal:
        m = m & (diff >= 0)
    if window is not None:
        m = m & (diff < window)
    if k_valid is not None:
        m = m & k_valid[:, None, :]
    return m[:, None]


def _attend(q, k, v, positions, cfg: AttnConfig, n_rep: int):
    """Full attention of a (B, L) block over itself."""
    k, v = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    if q.shape[1] >= CHUNKED_ATTN_THRESHOLD:
        return chunked_dot_product_attention(
            q, k, v, positions, positions, cfg.scale, causal=cfg.causal,
            window=cfg.window)
    mask = make_attention_mask(positions, positions, causal=cfg.causal,
                               window=cfg.window)
    return dot_product_attention(q, k, v, mask, cfg.scale)


# ---------------------------------------------------------------------------
# GQA attention block
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    """GQA/MQA/MHA with RoPE and an optional sliding window."""

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

    def with_config(self, cfg: AttnConfig) -> "Attention":
        """This block's projections (shared, not copied) under ``cfg``,
        which must give them the same shapes."""
        shapes = (cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                  cfg.qkv_bias)
        c = self.cfg
        if shapes != (c.dim, c.n_heads, c.n_kv_heads, c.head_dim,
                      c.qkv_bias):
            raise ValueError("an attention view cannot change the shapes of "
                             "its projections")
        out = Attention.__new__(Attention)
        nn.Module.__init__(out)
        out.cfg = cfg
        out.wq, out.wk, out.wv, out.wo = self.wq, self.wk, self.wv, self.wo
        return out

    @staticmethod
    def init_cache(cfg: AttnConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16, device=None) -> dict:
        """A ring of ``min(window, max_len)`` rows for a windowed layer,
        else ``max_len`` rows."""
        slots = cache_rows(cfg.window, max_len)
        shape = (batch, slots, cfg.n_kv_heads, cfg.head_dim)
        return {
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.full((batch, slots), -1, dtype=torch.int32,
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

        if cache is None and cfg.use_flash and cfg.causal and \
                cfg.window is None:
            # As in the reference: only the cache-free causal branch without
            # a window, and before the chunked one; bidirectional and
            # windowed attention never go to the flash kernel.
            from repro_torch.kernels.attention import ops as flash_ops
            out = flash_ops.flash_attention(
                q, _repeat_kv(k, n_rep), _repeat_kv(v, n_rep), causal=True,
                scale=cfg.scale)
        elif cache is None:
            out = _attend(q, k, v, positions, cfg, n_rep)
        elif chunk_lens is not None:
            out = self._chunked_decode(q, k, v, positions, cache,
                                       chunk_lens, block_table, n_rep)
        elif "k_pages" in cache:
            out = self._paged_decode(q, k, v, positions, cache, cache_index,
                                     block_table)
        elif l > 1:
            self._prefill_write(k, v, positions, cache, cfg.window)
            out = _attend(q, k, v, positions, cfg, n_rep)
        else:
            out = self._decode(q, k, v, positions, cache, cache_index, n_rep)

        out = out.reshape(b, l, cfg.n_heads * cfg.head_dim)
        return self.wo(out), cache

    @staticmethod
    def _prefill_write(k, v, positions, cache, window) -> None:
        """Prefill's cache write, in place: the last ``min(L, slots)``
        positions, position p at row ``p % slots`` as decode addresses it
        — all L rows when they fit, the last ``slots`` when a window ring
        is shorter than the prompt.  A cache that holds fewer rows than
        the layer attends to (every position without a window) raises on
        a prompt longer than it."""
        b, l = positions.shape
        slots = cache["k"].shape[1]
        if l > slots and (window is None or window > slots):
            raise ValueError(f"prefill of {l} positions exceeds the cache's "
                             f"{slots} rows")
        keep = min(l, slots)
        pos = torch.broadcast_to(positions, (b, l))[:, l - keep:] \
            .to(torch.int32)
        rows = (pos[0] % slots).long()
        cache["k"][:, rows] = k[:, l - keep:].to(cache["k"].dtype)
        cache["v"][:, rows] = v[:, l - keep:].to(cache["v"].dtype)
        cache["pos"][:, rows] = pos

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
                                   window=self.cfg.window, k_valid=pos >= 0)
        return dot_product_attention(
            q, _repeat_kv(cache["k"].to(q.dtype), n_rep),
            _repeat_kv(cache["v"].to(q.dtype), n_rep), mask, self.cfg.scale)

    def _paged_attend(self, q, cache, block_table, pos_q):
        from repro_torch.kernels.paged_attention import ops as paged_ops
        cfg = self.cfg
        return paged_ops.paged_attention(
            q, cache["k_pages"], cache["v_pages"], cache["pos"], block_table,
            pos_q, scale=cfg.scale, causal=cfg.causal, window=cfg.window,
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
        window = self.cfg.window
        if window is not None:
            # Ring semantics: all C writes land before the attention runs,
            # so a later chunk row's write can evict an in-window key that
            # an earlier row still needs.  Attend over the pre-write ring
            # plus the chunk itself (as the reference does): the keys a row
            # i needs are never among those rows <= i overwrite, and chunk
            # positions are disjoint from the old ring's, so each position
            # counts once — bitwise the C sequential steps.  The chunk's
            # K/V round-trip through the cache dtype, as stored keys would.
            k_att = torch.cat([cache["k"], k.to(cache["k"].dtype)],
                              dim=1).to(q.dtype)
            v_att = torch.cat([cache["v"], v.to(cache["v"].dtype)],
                              dim=1).to(q.dtype)
            pos_att = torch.cat([cache["pos"],
                                 torch.where(row_ok, pos_q, -1)], dim=1)
        masked_chunk_write(cache, pos_q.long() % slots, row_ok,
                           {"k": k, "v": v}, pos_q)
        if window is None:
            k_att = cache["k"].to(q.dtype)
            v_att = cache["v"].to(q.dtype)
            pos_att = cache["pos"]
        mask = make_attention_mask(pos_q, pos_att, causal=self.cfg.causal,
                                   window=window, k_valid=pos_att >= 0)
        return dot_product_attention(
            q, _repeat_kv(k_att, n_rep), _repeat_kv(v_att, n_rep), mask,
            self.cfg.scale)


# ---------------------------------------------------------------------------
# Cross-attention (VLM image layers / enc-dec decoder)
# ---------------------------------------------------------------------------

class CrossAttention(nn.Module):
    """Attention of x over context K/V computed once per request
    (``precompute_kv``): no RoPE, no cache and no mask (every context row
    is valid).  ``kv_dim`` is the context's width.  As in the reference
    the softmax runs in float32 over ``cfg.scale``-scaled scores, query
    head ``kv * n_rep + r`` reads KV head ``kv``, and the probabilities
    are cast to V's dtype; it runs on the plain path (the reference's is
    plain jnp), inside the profiler label ``cross``."""

    def __init__(self, cfg: AttnConfig, *, kv_dim: int | None = None,
                 generator=None, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        kv_dim = kv_dim or cfg.dim
        kw = dict(generator=generator, device=device, dtype=dtype)
        qd, kvd = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
        self.wq = Linear(cfg.dim, qd, bias=cfg.qkv_bias, **kw)
        self.wk = Linear(kv_dim, kvd, bias=cfg.qkv_bias, **kw)
        self.wv = Linear(kv_dim, kvd, bias=cfg.qkv_bias, **kw)
        self.wo = Linear(qd, cfg.dim, bias=False, **kw)

    def precompute_kv(self, context) -> dict:
        """context (B, Lc, kv_dim) -> {"k", "v": (B, Lc, KVH, hd)}."""
        cfg = self.cfg
        b, lc, _ = context.shape
        with profiler_label("cross"):
            return {"k": self.wk(context).reshape(b, lc, cfg.n_kv_heads,
                                                  cfg.head_dim),
                    "v": self.wv(context).reshape(b, lc, cfg.n_kv_heads,
                                                  cfg.head_dim)}

    def forward(self, x, kv: dict):
        """x (B, L, dim) over ``kv`` from ``precompute_kv`` -> (B, L, dim)."""
        cfg = self.cfg
        b, l, _ = x.shape
        with profiler_label("cross"):
            q = self.wq(x).reshape(b, l, cfg.n_heads, cfg.head_dim)
            n_rep = cfg.n_heads // cfg.n_kv_heads
            mask = torch.ones((b, 1, l, kv["k"].shape[1]), dtype=torch.bool,
                              device=x.device)
            out = dot_product_attention(
                q, _repeat_kv(kv["k"].to(q.dtype), n_rep),
                _repeat_kv(kv["v"].to(q.dtype), n_rep), mask, cfg.scale)
            return self.wo(out.reshape(b, l, cfg.n_heads * cfg.head_dim))


# ---------------------------------------------------------------------------
# Multi-head Latent Attention (DeepSeek-V3, arXiv:2412.19437)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MLAConfig:
    dim: int
    n_heads: int
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 10000.0

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def scale(self) -> float:
        return self.qk_head_dim ** -0.5

    @property
    def cache_width(self) -> int:
        """Cache row per token: the latent and the shared rope key."""
        return self.kv_lora_rank + self.qk_rope_head_dim


class MLA(nn.Module):
    """DeepSeek MLA: low-rank compressed Q and KV.  The decode cache holds
    each token's (kv_lora_rank + rope) latent row instead of per-head K/V,
    and decode attends in the latent space (``_absorbed_attention``).

    As in the reference, the compressed latents are not normalised, RoPE
    rotates split halves of the rope part of each head and of the shared
    key, and the full-sequence forward and the prefill expand the latents
    to per-head K (nope + rope) and V and attend on the plain path: MLA
    never goes through the flash or the paged kernel."""

    def __init__(self, cfg: MLAConfig, *, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        kw = dict(generator=generator, device=device, dtype=dtype)
        h, r = cfg.n_heads, cfg.kv_lora_rank
        self.wq_a = Linear(cfg.dim, cfg.q_lora_rank, **kw)
        self.wq_b = Linear(cfg.q_lora_rank, h * cfg.qk_head_dim, **kw)
        self.wkv_a = Linear(cfg.dim, r + cfg.qk_rope_head_dim, **kw)
        self.wk_b = Linear(r, h * cfg.qk_nope_head_dim, **kw)
        self.wv_b = Linear(r, h * cfg.v_head_dim, **kw)
        self.wo = Linear(h * cfg.v_head_dim, cfg.dim, **kw)

    @staticmethod
    def init_cache(cfg: MLAConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16, device=None) -> dict:
        return {
            "ckv": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                               dtype=dtype, device=device),
            "krope": torch.zeros((batch, max_len, cfg.qk_rope_head_dim),
                                 dtype=dtype, device=device),
            "pos": torch.full((batch, max_len), -1, dtype=torch.int32,
                              device=device),
        }

    @staticmethod
    def init_paged_cache(cfg: MLAConfig, pool_pages: int, page_size: int,
                         dtype=torch.bfloat16, device=None) -> dict:
        """Pooled latent rows for paged decode: position-indexed like K/V,
        so they share the page pool and block table of
        ``Attention.init_paged_cache`` (trash page 0, ``pos`` -1 =
        unwritten)."""
        return {
            "ckv_pages": torch.zeros((pool_pages, page_size,
                                      cfg.kv_lora_rank), dtype=dtype,
                                     device=device),
            "krope_pages": torch.zeros((pool_pages, page_size,
                                        cfg.qk_rope_head_dim), dtype=dtype,
                                       device=device),
            "pos": torch.full((pool_pages, page_size), -1,
                              dtype=torch.int32, device=device),
        }

    @staticmethod
    def _gather_paged_latents(cache, block_table):
        """Each slot's latent rows from the pool in position order: page j
        of a slot's table covers positions [j*ps, (j+1)*ps), the index
        layout of the contiguous cache.  Unmapped entries read the trash
        page with ``pos`` forced to -1, an exact zero in the softmax, so
        the absorbed attention over the gathered block is bitwise the
        contiguous one."""
        safe = block_table.clamp(min=0).long()         # (B, P)
        ckv = cache["ckv_pages"][safe]                 # (B, P, ps, r)
        krope = cache["krope_pages"][safe]
        pos = torch.where(block_table[:, :, None] >= 0, cache["pos"][safe],
                          -1)
        b, p, ps = pos.shape
        return (ckv.reshape(b, p * ps, ckv.shape[-1]),
                krope.reshape(b, p * ps, krope.shape[-1]),
                pos.reshape(b, p * ps))

    def _queries(self, x, positions):
        cfg = self.cfg
        b, l, _ = x.shape
        q = self.wq_b(self.wq_a(x)).reshape(b, l, cfg.n_heads,
                                            cfg.qk_head_dim)
        nope = cfg.qk_nope_head_dim
        q_rope = apply_rope(q[..., nope:], positions, cfg.rope_theta)
        return torch.cat([q[..., :nope], q_rope], dim=-1)

    def _expand_kv(self, ckv, krope):
        """Latent (B, S, r) + shared rope key (B, S, rope) -> per-head K
        (nope + rope) and V."""
        cfg = self.cfg
        b, s, _ = ckv.shape
        k_nope = self.wk_b(ckv).reshape(b, s, cfg.n_heads,
                                        cfg.qk_nope_head_dim)
        v = self.wv_b(ckv).reshape(b, s, cfg.n_heads, cfg.v_head_dim)
        k_rope = krope[:, :, None, :].expand(b, s, cfg.n_heads,
                                             cfg.qk_rope_head_dim)
        return torch.cat([k_nope, k_rope], dim=-1), v

    def forward(self, x, *, positions, cache=None, cache_index=None,
                block_table=None, chunk_lens=None):
        """The modes of ``Attention.forward``; the cache is a latent cache
        (``init_cache``) or a latent pool (``init_paged_cache``), written
        in place.  Returns (out, cache).  Under a profiler the call runs
        inside the label ``mla``."""
        with profiler_label("mla"):
            return self._forward(x, positions, cache, cache_index,
                                 block_table, chunk_lens)

    def _forward(self, x, positions, cache, cache_index, block_table,
                 chunk_lens):
        cfg = self.cfg
        b, l, _ = x.shape
        q = self._queries(x, positions)
        ckv, krope_raw = self.wkv_a(x).split(
            [cfg.kv_lora_rank, cfg.qk_rope_head_dim], dim=-1)
        krope = apply_rope(krope_raw[:, :, None, :], positions,
                           cfg.rope_theta)[:, :, 0, :]

        if cache is not None and chunk_lens is not None:
            out = self._chunked_decode(q, ckv, krope, positions, cache,
                                       chunk_lens, block_table)
        elif cache is None or l > 1:
            if cache is not None:
                self._prefill_write(ckv, krope, positions, cache)
            k, v = self._expand_kv(ckv, krope)
            if l >= CHUNKED_ATTN_THRESHOLD:
                out = chunked_dot_product_attention(
                    q, k, v, positions, positions, cfg.scale, causal=True)
            else:
                mask = make_attention_mask(positions, positions, causal=True)
                out = dot_product_attention(q, k, v, mask, cfg.scale)
        else:
            out = self._decode(q, ckv, krope, positions, cache, cache_index,
                               block_table)
        out = out.reshape(b, l, cfg.n_heads * cfg.v_head_dim)
        return self.wo(out), cache

    @staticmethod
    def _prefill_write(ckv, krope, positions, cache) -> None:
        """Prefill's latent write, in place: rows [0, L)."""
        if "ckv_pages" in cache:
            raise ValueError("a paged latent cache takes single-token or "
                             "chunked decode, not a prefill")
        b, l, _ = ckv.shape
        if l > cache["ckv"].shape[1]:
            raise ValueError(f"prefill of {l} positions exceeds the cache's "
                             f"{cache['ckv'].shape[1]} rows")
        cache["ckv"][:, :l] = ckv.to(cache["ckv"].dtype)
        cache["krope"][:, :l] = krope.to(cache["krope"].dtype)
        cache["pos"][:, :l] = torch.broadcast_to(positions, (b, l)) \
            .to(torch.int32)

    def _decode(self, q, ckv, krope, positions, cache, cache_index,
                block_table):
        """Single-token decode: this token's latent row written at
        ``cache_index`` (a scalar or a (B,) vector), or through the block
        table to (page, offset) in a pool (slots with no mapped page write
        the trash page), then the absorbed attention over the cache."""
        b = q.shape[0]
        ci = torch.as_tensor(cache_index, dtype=torch.int64,
                             device=q.device)
        pos_q = torch.broadcast_to(positions, (b, 1)).to(torch.int32)
        if "ckv_pages" in cache:
            if block_table is None:
                raise ValueError("a paged latent cache needs a block_table")
            ps = cache["pos"].shape[1]
            ci = ci.expand(b)
            rows = torch.arange(b, device=q.device)
            page_idx = (ci // ps).clamp(0, block_table.shape[1] - 1)
            page_ids = block_table[rows, page_idx].clamp(min=0).long()
            off = ci % ps
            cache["ckv_pages"][page_ids, off] = \
                ckv[:, 0].to(cache["ckv_pages"].dtype)
            cache["krope_pages"][page_ids, off] = \
                krope[:, 0].to(cache["krope_pages"].dtype)
            cache["pos"][page_ids, off] = pos_q[:, 0]
            ckv_c, krope_c, pos = self._gather_paged_latents(cache,
                                                             block_table)
            return self._absorbed_attention(q, ckv_c, krope_c, pos, pos_q)
        # An empty slot's position may run past the cache (the scheduler
        # rewinds it on its next admission); its write wraps, as
        # ``Attention._decode``'s does, into its own rows, which are reset
        # before they are read.
        ci = ci % cache["ckv"].shape[1]
        if ci.ndim:
            rows = torch.arange(b, device=q.device)
            cache["ckv"][rows, ci] = ckv[:, 0].to(cache["ckv"].dtype)
            cache["krope"][rows, ci] = krope[:, 0].to(cache["krope"].dtype)
            cache["pos"][rows, ci] = pos_q[:, 0]
        else:
            # index_copy_ keeps the index on the device (see
            # ``Attention._decode``).
            ci = ci.reshape(1)
            cache["ckv"].index_copy_(1, ci, ckv.to(cache["ckv"].dtype))
            cache["krope"].index_copy_(1, ci,
                                       krope.to(cache["krope"].dtype))
            cache["pos"].index_copy_(1, ci, pos_q)
        return self._absorbed_attention(q, cache["ckv"], cache["krope"],
                                        cache["pos"], pos_q)

    def _chunked_decode(self, q, ckv, krope, positions, cache, chunk_lens,
                        block_table):
        """Up to C latent rows written per slot, rows ``i >=
        chunk_lens[b]`` leaving the cache as it was (a pool sends them to
        the trash page with ``pos`` -1; a contiguous cache takes
        ``masked_chunk_write``), then the absorbed attention of the (B, C)
        query block over the updated cache."""
        b, c = positions.shape
        row_ok = torch.arange(c, device=q.device)[None, :] < \
            torch.as_tensor(chunk_lens, device=q.device)[:, None]
        pos_q = positions.to(torch.int32)
        if "ckv_pages" in cache:
            if block_table is None:
                raise ValueError("a paged latent cache needs a block_table")
            ps = cache["pos"].shape[1]
            rows = torch.arange(b, device=q.device)[:, None]
            page_idx = (pos_q.long() // ps).clamp(0, block_table.shape[1] - 1)
            page_ids = block_table[rows, page_idx].clamp(min=0).long()
            page_ids = torch.where(row_ok, page_ids, 0)
            off = pos_q.long() % ps
            cache["ckv_pages"][page_ids, off] = \
                ckv.to(cache["ckv_pages"].dtype)
            cache["krope_pages"][page_ids, off] = \
                krope.to(cache["krope_pages"].dtype)
            cache["pos"][page_ids, off] = torch.where(row_ok, pos_q, -1)
            ckv_c, krope_c, pos = self._gather_paged_latents(cache,
                                                             block_table)
            return self._absorbed_attention(q, ckv_c, krope_c, pos, pos_q)
        idx = pos_q.long() % cache["ckv"].shape[1]
        masked_chunk_write(cache, idx, row_ok, {"ckv": ckv, "krope": krope},
                           pos_q)
        return self._absorbed_attention(q, cache["ckv"], cache["krope"],
                                        cache["pos"], pos_q)

    def _absorbed_attention(self, q, ckv_c, krope_c, pos, q_pos):
        """Decode attention of a (B, Lq) query block over the latent cache,
        entirely in the latent space: W_uk absorbed into the query, W_uv
        applied to the latent output, per-head K/V never built.  The
        reference's dtypes: the einsums in q's dtype, their sum cast to
        float32 and scaled, masked logits NEG_INF, softmax in float32, the
        probabilities cast to q's dtype."""
        cfg = self.cfg
        h, r = cfg.n_heads, cfg.kv_lora_rank
        nope = cfg.qk_nope_head_dim
        q_nope, q_rope = q[..., :nope], q[..., nope:]
        # weights are stored (out, in): (h * d, r) -> (r, h, d)
        w_uk = self.wk_b.weight.to(q.dtype).t().reshape(r, h, nope)
        q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope, w_uk)
        ckv_f = ckv_c.to(q.dtype)
        logits = (torch.einsum("bqhr,bsr->bhqs", q_lat, ckv_f) +
                  torch.einsum("bqhd,bsd->bhqs", q_rope,
                               krope_c.to(q.dtype)))
        logits = logits.float() * cfg.scale
        mask = make_attention_mask(q_pos, pos, causal=True, k_valid=pos >= 0)
        logits = logits.masked_fill(~mask, NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        o_lat = torch.einsum("bhqs,bsr->bqhr", probs, ckv_f)
        w_uv = self.wv_b.weight.to(q.dtype).t().reshape(r, h, cfg.v_head_dim)
        return torch.einsum("bqhr,rhv->bqhv", o_lat, w_uv)
