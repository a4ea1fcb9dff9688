"""Dense multiplexed backbone — the port of ``repro.models.backbone`` for
the dense family.

DataMUX is integrated as in the reference: token embedding → prefix
protocol → mux strategy → attention + MLP blocks → demux strategy →
per-instance logits.  Mux/demux schemes resolve by name from the port's
strategy registry; ``cfg.mux.n == 1`` degrades to a plain LM.  Where the
reference compiles its layers into a head / scanned / tail pattern, the
port runs a plain loop over ``layers``.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.strategies import get_demux, get_mux
from repro_torch.device import resolve_device
from repro_torch.nn.attention import Attention, paged_eligible
from repro_torch.nn.layers import MLP, Embedding, Linear, make_norm


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device,
               dtype=None, page_pool=None) -> list[dict]:
    """One K/V cache per layer: contiguous, ``max_len`` rows per slot; or,
    with ``page_pool`` = (pool_pages, page_size), a page pool shared by
    every slot (see ``serving/paging.py``) for each layer that
    ``paged_eligible`` admits."""
    dtype = dtype or cfg.compute_dtype
    acfg = cfg.attn_config()
    caches = []
    for kind in cfg.layer_kinds():
        if page_pool is not None and paged_eligible(kind["window"], max_len):
            caches.append(Attention.init_paged_cache(acfg, *page_pool, dtype,
                                                     device))
        else:
            caches.append(Attention.init_cache(acfg, batch, max_len, dtype,
                                               device))
    return caches


class Block(nn.Module):
    """Pre-norm attention + MLP residual block."""

    def __init__(self, cfg: ModelConfig, kind: dict, *, generator, device,
                 dtype):
        super().__init__()
        norm = make_norm(cfg.norm)
        self.norm1 = norm(cfg.d_model, device=device, dtype=dtype)
        self.attn = Attention(cfg.attn_config(), generator=generator,
                              device=device, dtype=dtype)
        self.norm2 = self.mlp = None
        if kind["mlp"] == "dense":
            self.norm2 = norm(cfg.d_model, device=device, dtype=dtype)
            self.mlp = MLP(cfg.d_model, cfg.d_ff, gated=cfg.gated_mlp,
                           activation=cfg.activation, generator=generator,
                           device=device, dtype=dtype)

    def forward(self, x, *, positions, cache=None, cache_index=None,
                block_table=None, chunk_lens=None):
        out, cache = self.attn(self.norm1(x), positions=positions,
                               cache=cache, cache_index=cache_index,
                               block_table=block_table,
                               chunk_lens=chunk_lens)
        x = x + out
        if self.mlp is not None:
            x = x + self.mlp(self.norm2(x))
        return x, cache


class Backbone(nn.Module):
    """Weights are drawn from ``seed`` with a ``torch.Generator`` on
    ``device`` (the GPU unless the caller asks for another device)."""

    def __init__(self, cfg: ModelConfig, *, seed: int = 0, device=None):
        super().__init__()
        device = resolve_device(device)
        g = torch.Generator(device=device).manual_seed(seed)
        kw = dict(generator=g, device=device, dtype=cfg.pdtype)
        self.cfg = cfg
        self.embed = Embedding(cfg.vocab, cfg.d_model, **kw)
        self.final_norm = make_norm(cfg.norm)(cfg.d_model, device=device,
                                              dtype=cfg.pdtype)
        self.lm_head = None if cfg.tie_embeddings else \
            Linear(cfg.d_model, cfg.vocab, **kw)
        self.mux = self.demux = None
        if cfg.mux.active:
            self.mux = get_mux(cfg.mux.strategy).init(cfg.mux, cfg.d_model,
                                                      **kw)
            self.demux = get_demux(cfg.mux.demux).init(cfg.mux, cfg.d_model,
                                                       **kw)
        self.layers = nn.ModuleList(
            Block(cfg, kind, **kw) for kind in cfg.layer_kinds())

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    # -- caches -----------------------------------------------------------------

    def init_cache(self, batch: int, max_len: int, dtype=None, *,
                   page_pool=None) -> list[dict]:
        """``init_cache`` on this model's device."""
        return init_cache(self.cfg, batch, max_len, device=self.device,
                          dtype=dtype, page_pool=page_pool)

    def narrowed(self, width: int) -> "Backbone":
        """The same model served at mux width ``width`` <= cfg.mux.n: every
        backbone weight is shared, the mux/demux params are the strategies'
        ``narrow`` of this model's, and width 1 drops them (a true unmuxed
        baseline).  The config's ``width_set`` is cleared: the narrowed
        model serves one class."""
        cfg = self.cfg
        if not 1 <= width <= cfg.mux.n:
            raise ValueError(f"width must satisfy 1 <= w <= mux.n="
                             f"{cfg.mux.n}, got {width}")
        out = Backbone.__new__(Backbone)
        nn.Module.__init__(out)
        out.cfg = dataclasses.replace(
            cfg, mux=dataclasses.replace(cfg.mux, n=width),
            serving=dataclasses.replace(cfg.serving, width_set=()))
        out.embed, out.final_norm = self.embed, self.final_norm
        out.lm_head, out.layers = self.lm_head, self.layers
        out.mux = out.demux = None
        if width > 1:
            out.mux = get_mux(cfg.mux.strategy).narrow(self.mux, cfg.mux,
                                                       width)
            out.demux = get_demux(cfg.mux.demux).narrow(self.demux, cfg.mux,
                                                        width)
        return out

    # -- pieces ---------------------------------------------------------------------

    def embed_tokens(self, tokens):
        return self.embed(tokens, dtype=self.cfg.compute_dtype)

    def logits(self, h):
        if self.lm_head is None:
            return self.embed.attend(h)
        return self.lm_head(h)

    def _run_blocks(self, x, *, positions, cache=None, cache_index=None,
                    block_table=None, chunk_lens=None):
        for i, layer in enumerate(self.layers):
            x, _ = layer(x, positions=positions,
                         cache=None if cache is None else cache[i],
                         cache_index=cache_index, block_table=block_table,
                         chunk_lens=chunk_lens)
        return self.final_norm(x)

    def _demux_decode(self, h, index_embeds):
        """Decode-step demux of the (B, C, d) final hidden block ->
        (B, N, C, d): ``serving.fuse_demux`` routes strategies with a fused
        decode epilogue through ``decode_apply``, everything else takes the
        ordinary ``apply``."""
        mux = self.cfg.mux
        demux_s = get_demux(mux.demux)
        if self.cfg.serving.fuse_demux and demux_s.fused_decode:
            return demux_s.decode_apply(self.demux, h, mux,
                                        index_embeds=index_embeds)
        return demux_s.apply(self.demux, h, mux, index_embeds=index_embeds)

    # -- full-sequence forward (train / prefill) ----------------------------------

    def forward(self, tokens, *, cache=None, last_only: bool = False):
        """The reference's ``Backbone.apply`` (``nn.Module.apply`` is taken).
        tokens: (B, N, L) when mux active else (B, L).

        Returns dict(hidden, demuxed, logits, index_embeds, cache);
        ``demuxed``/``logits`` are (B, N, L, ·) when mux active else
        (B, L, ·).  Passing a fresh ``cache`` (``init_cache``) makes this a
        prefill: the cache is filled in place, ready for ``decode_step``.
        ``last_only``: demux + logits for the final position only (serving
        prefill never needs the N-fold demuxed tensor).
        """
        mux = self.cfg.mux
        if mux.active:
            demux_s = get_demux(mux.demux)
            b, n, _ = tokens.shape
            emb = self.embed_tokens(tokens)                     # (B, N, L, d)
            p = mux.prefix_len
            if p:
                pre = demux_s.prefix_embeddings(self.demux, mux, emb.dtype)
                emb = torch.cat([pre[None].expand(b, n, p, emb.shape[-1]),
                                 emb], dim=2)
            x = get_mux(mux.strategy).apply(self.mux, emb, mux)  # (B, P+L, d)
        else:
            b = tokens.shape[0]
            p = 0
            x = self.embed_tokens(tokens)

        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device).expand(b, x.shape[1])
        h = self._run_blocks(x, positions=positions, cache=cache)

        out = {"hidden": h, "index_embeds": None, "cache": cache}
        if mux.active:
            if demux_s.uses_prefix:
                index_embeds = h[:, :mux.n]      # p^i = h at prefix pos i
                h_rest = h[:, p:]                # drop padding positions too
            else:
                index_embeds = None
                h_rest = h
            if last_only:
                h_rest = h_rest[:, -1:]
            demuxed = demux_s.apply(self.demux, h_rest, mux,
                                    index_embeds=index_embeds)
            out["demuxed"] = demuxed
            out["index_embeds"] = index_embeds
        else:
            out["demuxed"] = h[:, -1:] if last_only else h
        out["logits"] = self.logits(out["demuxed"])
        return out

    # -- single-token decode (serving) ---------------------------------------------

    def decode_step(self, tokens, cache, cache_index, *, index_embeds=None,
                    lane_mask=None, block_table=None, chunk_lens=None):
        """One decode step.

        tokens: (B, N) last generated token per stream when mux active,
        else (B,).  cache_index: absolute position (prefix included) being
        written — a scalar (all slots in lock-step) or a (B,) vector (each
        slot at its own position).  lane_mask: optional (B, N) 0/1 —
        retired lanes contribute nothing to the mixed stream and their
        logits are zeroed.  block_table: (B, max_pages) int32 when the
        cache is paged.  The cache is updated in place.
        Returns (logits, cache): logits (B, N, vocab) when mux active else
        (B, vocab).

        Chunked decode (``chunk_lens`` (B,) given): tokens carry a trailing
        chunk axis — (B, N, C) / (B, C) — and ``cache_index`` is the (B,)
        base position of each slot's chunk; slot b writes cache rows
        ``[cache_index[b], cache_index[b] + chunk_lens[b])``.  ``lane_mask``
        is then (B, N, C): a lane that is not ramping contributes its token
        at row 0 only.  Returns logits (B, N, C, vocab) / (B, C, vocab).
        """
        mux = self.cfg.mux
        ci = torch.as_tensor(cache_index, dtype=torch.int32,
                             device=self.device)
        if chunk_lens is not None:
            return self._chunked_decode_step(
                tokens, cache, ci,
                torch.as_tensor(chunk_lens, dtype=torch.int32,
                                device=self.device),
                index_embeds=index_embeds, lane_mask=lane_mask,
                block_table=block_table)
        if mux.active:
            b = tokens.shape[0]
            emb = self.embed_tokens(tokens[:, :, None])         # (B, N, 1, d)
            if lane_mask is not None:
                emb = emb * lane_mask[:, :, None, None].to(emb.dtype)
            x = get_mux(mux.strategy).apply(self.mux, emb, mux)  # (B, 1, d)
        else:
            b = tokens.shape[0]
            x = self.embed_tokens(tokens[:, None])               # (B, 1, d)
            if lane_mask is not None:
                x = x * lane_mask[:, :1, None].to(x.dtype)

        positions = torch.broadcast_to(ci[:, None] if ci.ndim else ci, (b, 1))
        h = self._run_blocks(x, positions=positions, cache=cache,
                             cache_index=ci, block_table=block_table)

        if mux.active:
            demuxed = self._demux_decode(h, index_embeds)
            logits = self.logits(demuxed[:, :, 0])               # (B, N, V)
            if lane_mask is not None:
                logits = torch.where(lane_mask[:, :, None].bool(), logits,
                                     0.0)
        else:
            logits = self.logits(h[:, 0])                        # (B, V)
            if lane_mask is not None:
                logits = torch.where(lane_mask[:, :1].bool(), logits, 0.0)
        return logits, cache

    def _chunked_decode_step(self, tokens, cache, ci, chunk_lens, *,
                             index_embeds=None, lane_mask=None,
                             block_table=None):
        """Chunked-prefill decode step (see ``decode_step``): a (B, ., C)
        token chunk advances slot b by ``chunk_lens[b]`` positions."""
        mux = self.cfg.mux
        if mux.active:
            b, _, c = tokens.shape
            emb = self.embed_tokens(tokens)                     # (B, N, C, d)
            if lane_mask is not None:
                emb = emb * lane_mask[..., None].to(emb.dtype)
            x = get_mux(mux.strategy).apply(self.mux, emb, mux)  # (B, C, d)
        else:
            b, c = tokens.shape
            x = self.embed_tokens(tokens)                        # (B, C, d)
            if lane_mask is not None:
                x = x * lane_mask[:, 0, :, None].to(x.dtype)

        positions = ci[:, None] + torch.arange(c, dtype=torch.int32,
                                               device=x.device)[None, :]
        h = self._run_blocks(x, positions=positions, cache=cache,
                             cache_index=ci, block_table=block_table,
                             chunk_lens=chunk_lens)

        if mux.active:
            demuxed = self._demux_decode(h, index_embeds)
            logits = self.logits(demuxed)                        # (B,N,C,V)
            if lane_mask is not None:
                logits = torch.where(lane_mask[..., None].bool(), logits,
                                     0.0)
        else:
            logits = self.logits(h)                              # (B, C, V)
            if lane_mask is not None:
                logits = torch.where(lane_mask[:, 0, :, None].bool(), logits,
                                     0.0)
        return logits, cache
