"""Multi-head attention (MHA / GQA / MQA) with RoPE — the port of the
reference's ``Attention`` class (``repro.nn.attention``).

Modes, chosen by the arguments as in the reference:

  * full sequence (training / forward):   ``cache is None``
  * prefill:    a cache is given and L > 1 — full attention over x, and
                K/V/positions written to cache rows [0, L)
  * decode:     a cache is given and L == 1 — K/V written at
                ``cache_index`` (a scalar, or a (B,) vector of per-slot
                positions), then attention over the cache

Conventions kept from the reference: RoPE rotates split halves; query head
``kv * n_rep + r`` reads KV head ``kv``; masked scores are filled with
``NEG_INF`` (not ``-inf``, so a row with no valid key is a finite uniform
average), softmax runs in float32 and the probabilities are cast to V's
dtype before the PV product.

Caches are dicts of tensors {"k", "v": (B, S, KVH, hd), "pos": (B, S)
int32, -1 = unwritten}.  Where the reference returns a new cache (and the
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
    softmax_scale: float | None = None

    @property
    def scale(self) -> float:
        return self.softmax_scale if self.softmax_scale is not None \
            else self.head_dim ** -0.5


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

    def forward(self, x, *, positions, cache=None, cache_index=None):
        """x: (B, L, D); positions: (B, L).  Returns (out, cache)."""
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
