"""Multiplexed backbone — the port of ``repro.models.backbone`` for the
dense, MoE, hybrid, ssm, vlm and audio families (attention, MLA, Mamba,
mLSTM or sLSTM mixers; gated cross-attention sublayers over a context,
which an encoder stack may run over first).

DataMUX is integrated as in the reference: token embedding → prefix
protocol → mux strategy → attention + MLP blocks → demux strategy →
per-instance logits.  Mux/demux schemes resolve by name from the port's
strategy registry; ``cfg.mux.n == 1`` degrades to a plain LM.  Where the
reference compiles its layers into a head / scanned / tail pattern, the
port runs a plain loop over ``layers`` (under autograd, ``cfg.remat``
checkpoints each scanned group as the reference's ``jax.checkpoint``
does), and keys the context's cross-attention K/V (``encode_context``) by
absolute layer index.  ``Backbone(cfg, device="meta")`` builds the
shapes alone, the counterpart of ``jax.eval_shape(Backbone.init)``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.strategies import get_demux, get_mux
from repro_torch.device import resolve_device
from repro_torch.nn.attention import (MLA, Attention, CrossAttention,
                                      paged_eligible)
from repro_torch.nn.layers import (MLP, Embedding, Linear, make_norm,
                                   profiler_label)
from repro_torch.nn.moe import MoE, OnMesh
from repro_torch.nn.ssm import MLSTM, SLSTM, Mamba


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device,
               dtype=None, page_pool=None) -> list[dict]:
    """One cache per layer (K/V for attention, latent rows for MLA, the
    recurrent state for Mamba, mLSTM and sLSTM): contiguous, ``max_len``
    rows per slot (a windowed layer: its ring of ``min(window, max_len)``
    rows); or, with ``page_pool`` = (pool_pages, page_size), a page pool
    shared by every slot (see ``serving/paging.py``) for each attention or
    MLA layer that ``paged_eligible`` admits, the others keeping their
    contiguous caches.  A recurrent layer's state is O(1) per slot (an
    xLSTM state float32 whatever ``dtype``) and stays contiguous whatever
    ``page_pool`` and ``max_len`` say."""
    dtype = dtype or cfg.compute_dtype
    caches = []
    for kind in cfg.layer_kinds():
        if kind["mixer"] == "mamba":
            caches.append(Mamba.init_cache(cfg.mamba, batch, dtype, device))
            continue
        if kind["mixer"] in ("mlstm", "slstm"):
            mixer = MLSTM if kind["mixer"] == "mlstm" else SLSTM
            caches.append(mixer.init_cache(cfg.xlstm, batch, device))
            continue
        paged = page_pool is not None and paged_eligible(kind["window"],
                                                         max_len)
        if kind["mixer"] == "mla":
            caches.append(
                MLA.init_paged_cache(cfg.mla, *page_pool, dtype, device)
                if paged else
                MLA.init_cache(cfg.mla, batch, max_len, dtype, device))
            continue
        acfg = cfg.attn_config(window=kind["window"])
        if paged:
            caches.append(Attention.init_paged_cache(acfg, *page_pool, dtype,
                                                     device))
        else:
            caches.append(Attention.init_cache(acfg, batch, max_len, dtype,
                                               device))
    return caches


def _checkpoint(fn, *args, remat: str):
    """``fn(*args)`` under activation checkpointing: ``"full"`` recomputes
    everything in the backward, ``"dots"`` saves the matmuls without batch
    dims (the reference's ``dots_with_no_batch_dims_saveable``)."""
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)
    if remat == "full":
        return checkpoint(fn, *args, use_reentrant=False)
    dots = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default]
    return checkpoint(
        fn, *args, use_reentrant=False,
        context_fn=lambda: create_selective_checkpoint_contexts(dots))


class Block(nn.Module):
    """Pre-norm attention (or MLA, Mamba, mLSTM or sLSTM) + MLP (dense or
    MoE) residual block.  An attention or MLA mixer is ``attn``; a Mamba,
    mLSTM or sLSTM mixer is ``mamba``, ``mlstm`` or ``slstm`` (as in the
    reference's param tree), and ``attn`` is then None.  An xLSTM block
    has no MLP.  A layer whose kind has ``cross`` adds, after the mixer,
    ``tanh(cross_gate) * cross(norm_x(x), cross_kv)`` (the gate a scalar
    that starts at 0, so a fresh layer adds nothing); the others have
    ``cross`` None."""

    def __init__(self, cfg: ModelConfig, kind: dict, *, generator, device,
                 dtype, use_flash: bool = False):
        super().__init__()
        norm = make_norm(cfg.norm)
        self.norm1 = norm(cfg.d_model, device=device, dtype=dtype)
        self.attn = self.mamba = self.mlstm = self.slstm = None
        kw = dict(generator=generator, device=device, dtype=dtype)
        if kind["mixer"] == "mamba":
            self.mamba = Mamba(cfg.mamba, **kw)
        elif kind["mixer"] == "mlstm":
            self.mlstm = MLSTM(cfg.xlstm, **kw)
        elif kind["mixer"] == "slstm":
            self.slstm = SLSTM(cfg.xlstm, **kw)
        elif kind["mixer"] == "mla":
            # MLA never goes through the flash kernel (as in the reference)
            self.attn = MLA(cfg.mla, generator=generator, device=device,
                            dtype=dtype)
        else:
            self.attn = Attention(cfg.attn_config(window=kind["window"],
                                                  use_flash=use_flash),
                                  generator=generator, device=device,
                                  dtype=dtype)
        self.norm_x = self.cross = self.cross_gate = None
        if kind["cross"]:
            self.norm_x = norm(cfg.d_model, device=device, dtype=dtype)
            self.cross = CrossAttention(
                cfg.attn_config(), kv_dim=cfg.context_dim or cfg.d_model,
                **kw)
            self.cross_gate = nn.Parameter(torch.zeros((), device=device,
                                                       dtype=dtype))
        self.norm2 = self.mlp = self.moe = None
        if kind["mlp"] is not None:
            self.norm2 = norm(cfg.d_model, device=device, dtype=dtype)
        if kind["mlp"] == "dense":
            self.mlp = MLP(cfg.d_model, cfg.d_ff, gated=cfg.gated_mlp,
                           activation=cfg.activation, generator=generator,
                           device=device, dtype=dtype)
        elif kind["mlp"] == "moe":
            self.moe = MoE(cfg.moe, generator=generator, device=device,
                           dtype=dtype)

    def with_attn_config(self, acfg) -> "Block":
        """This block's weights (shared) with its attention under ``acfg``;
        an MLA, Mamba or xLSTM mixer and the cross sublayer, which no
        attention setting reaches, are shared as they are."""
        out = Block.__new__(Block)
        nn.Module.__init__(out)
        out.norm1, out.norm2 = self.norm1, self.norm2
        out.norm_x, out.cross = self.norm_x, self.cross
        out.cross_gate = self.cross_gate
        out.mlp, out.moe, out.mamba = self.mlp, self.moe, self.mamba
        out.mlstm, out.slstm = self.mlstm, self.slstm
        out.attn = self.attn if self.attn is None or isinstance(
            self.attn, MLA) else self.attn.with_config(acfg)
        return out

    def forward(self, x, *, positions, cache=None, cache_index=None,
                block_table=None, chunk_lens=None, row_mask=None,
                cross_kv=None, on_mesh: Optional[OnMesh] = None):
        """-> (x, cache, aux): ``aux`` is the MoE load-balance loss, None
        for a dense block.  ``cross_kv`` is this layer's context K/V
        (``CrossAttention.precompute_kv``), which a cross layer needs.
        ``row_mask`` (B, L) marks the rows the MoE dispatch counts (None:
        all).  ``on_mesh`` goes to the MoE layer (``MoE.forward``).  A
        Mamba mixer takes the cache and ``chunk_lens`` only: it has no
        positions, cache index or block table; an mLSTM or sLSTM mixer the
        cache only, and it refuses ``chunk_lens`` as the reference does."""
        xlstm = self.mlstm if self.mlstm is not None else self.slstm
        if xlstm is not None:
            if chunk_lens is not None:
                mixer = "mlstm" if self.mlstm is not None else "slstm"
                raise ValueError(
                    f"chunked decode (serving.prefill_chunk > 1) is not "
                    f"supported for {mixer!r} mixers — xLSTM state updates "
                    f"have no row-masked form yet; set prefill_chunk=1 for "
                    f"xLSTM archs")
            out, cache = xlstm(self.norm1(x), cache=cache)
        elif self.mamba is not None:
            out, cache = self.mamba(self.norm1(x), cache=cache,
                                    chunk_lens=chunk_lens)
        else:
            out, cache = self.attn(self.norm1(x), positions=positions,
                                   cache=cache, cache_index=cache_index,
                                   block_table=block_table,
                                   chunk_lens=chunk_lens)
        x = x + out
        if self.cross is not None:
            if cross_kv is None:
                raise ValueError("cross-attn layer needs context kv")
            out = self.cross(self.norm_x(x), cross_kv)
            x = x + torch.tanh(self.cross_gate.to(x.dtype)) * out
        aux = None
        if self.mlp is not None:
            x = x + self.mlp(self.norm2(x))
        elif self.moe is not None:
            out, aux = self.moe(self.norm2(x), row_mask, on_mesh=on_mesh)
            x = x + out
        return x, cache, aux


class Backbone(nn.Module):
    """Weights are drawn from ``seed`` with a ``torch.Generator`` on
    ``device`` (the GPU unless the caller asks for another device); on
    ``meta`` they are shapes only, drawn from nothing.  A
    config with an ``encoder`` gets ``encoder.layers`` and
    ``encoder.final_norm``, in the encoder's param dtype.
    ``use_flash`` routes each layer's cache-free causal attention through
    the flash kernel (``cfg.attn_config(use_flash=True)``); prefill and
    decode, which write a cache, bidirectional attention, windowed
    (local) layers and MLA, Mamba and xLSTM layers are unaffected."""

    def __init__(self, cfg: ModelConfig, *, seed: int = 0, device=None,
                 use_flash: bool = False):
        super().__init__()
        device = resolve_device(device)
        # On ``meta`` (the dry-run's shapes) nothing is drawn: no generator.
        g = None if device.type == "meta" else \
            torch.Generator(device=device).manual_seed(seed)
        kw = dict(generator=g, device=device, dtype=cfg.pdtype)
        self.cfg = cfg
        self.use_flash = use_flash
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
            Block(cfg, kind, use_flash=use_flash, **kw)
            for kind in cfg.layer_kinds())
        self.encoder = None
        if cfg.encoder is not None:
            # Bidirectional: never the flash path (causal attention only).
            ecfg = cfg.encoder
            ekw = dict(kw, dtype=ecfg.pdtype)
            self.encoder = nn.Module()
            self.encoder.layers = nn.ModuleList(
                Block(ecfg, kind, **ekw) for kind in ecfg.layer_kinds())
            self.encoder.final_norm = make_norm(ecfg.norm)(
                ecfg.d_model, device=device, dtype=ecfg.pdtype)

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
        out.use_flash = self.use_flash
        out.embed, out.final_norm = self.embed, self.final_norm
        out.lm_head, out.layers = self.lm_head, self.layers
        out.encoder = self.encoder
        out.mux = out.demux = None
        if width > 1:
            out.mux = get_mux(cfg.mux.strategy).narrow(self.mux, cfg.mux,
                                                       width)
            out.demux = get_demux(cfg.mux.demux).narrow(self.demux, cfg.mux,
                                                        width)
        return out

    def with_config(self, cfg: ModelConfig, *,
                    use_flash: bool | None = None) -> "Backbone":
        """This model under ``cfg``: every parameter shared, none copied.
        ``cfg`` may differ from this model's config only in ``serving`` and
        ``mux.use_kernel`` (a replica's serving stack; the kernels on or
        off); any other change raises, since it would shape the weights or
        change the function they compute.  Each layer's attention takes
        ``cfg``'s paged-kernel settings, and ``use_flash`` (None: this
        model's)."""
        same = dataclasses.replace(
            cfg, serving=self.cfg.serving,
            mux=dataclasses.replace(cfg.mux,
                                    use_kernel=self.cfg.mux.use_kernel))
        if same != self.cfg:
            changed = [f.name for f in dataclasses.fields(cfg)
                       if getattr(same, f.name) != getattr(self.cfg, f.name)]
            raise ValueError(f"a view of {self.cfg.name!r} may change only "
                             f"serving and mux.use_kernel; {changed} differ")
        out = Backbone.__new__(Backbone)
        nn.Module.__init__(out)
        out.cfg = cfg
        out.use_flash = self.use_flash if use_flash is None else use_flash
        out.embed, out.final_norm = self.embed, self.final_norm
        out.lm_head, out.mux, out.demux = self.lm_head, self.mux, self.demux
        out.encoder = self.encoder
        out.layers = nn.ModuleList(
            b.with_attn_config(cfg.attn_config(window=kind["window"],
                                               use_flash=out.use_flash))
            for b, kind in zip(self.layers, cfg.layer_kinds()))
        return out

    # -- pieces ---------------------------------------------------------------------

    def embed_tokens(self, tokens):
        return self.embed(tokens, dtype=self.cfg.compute_dtype)

    def logits(self, h):
        if self.lm_head is None:
            return self.embed.attend(h)
        return self.lm_head(h)

    def encode_context(self, context, *,
                       on_mesh: Optional[OnMesh] = None) -> dict:
        """context (B, Lc, context_dim) -> {layer index: {"k", "v"}} for
        each cross layer: the context cast to the compute dtype, through
        the encoder stack (bidirectional, profiler label ``encoder``) when
        the config has one, then each cross layer's K/V projections.
        ``on_mesh``: as ``forward``."""
        ctx = context.to(self.cfg.compute_dtype)
        if self.encoder is not None:
            with profiler_label("encoder"):
                x = ctx
                pos = torch.arange(x.shape[1], dtype=torch.int32,
                                   device=x.device).expand(x.shape[:2])
                for layer in self.encoder.layers:
                    x, _, _ = layer(x, positions=pos, on_mesh=on_mesh)
                ctx = self.encoder.final_norm(x)
        return {i: layer.cross.precompute_kv(ctx)
                for i, layer in enumerate(self.layers)
                if layer.cross is not None}

    def _run_blocks(self, x, *, positions, cache=None, cache_index=None,
                    block_table=None, chunk_lens=None, row_mask=None,
                    cross_kv=None, on_mesh: Optional[OnMesh] = None):
        """-> (final-normed hidden, the MoE layers' aux losses summed in
        layer order as a float32 scalar).

        Under autograd with no cache, ``cfg.remat`` checkpoints each group
        of the reference's scanned layer pattern (``cfg.layer_pattern()``;
        its head and tail layers are not): ``"full"`` recomputes the whole
        group in the backward, ``"dots"`` saves the outputs of the
        matmuls without batch dims (``aten.mm`` / ``aten.addmm``, what a
        Linear reaches) and recomputes the rest.  The numbers are those of
        ``"none"``; only the memory held for the backward changes."""
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        cross_kv = cross_kv or {}

        def run(lo: int, hi: int, x):
            auxes = []
            for i in range(lo, hi):
                x, _, aux = self.layers[i](
                    x, positions=positions,
                    cache=None if cache is None else cache[i],
                    cache_index=cache_index, block_table=block_table,
                    chunk_lens=chunk_lens, row_mask=row_mask,
                    cross_kv=cross_kv.get(i), on_mesh=on_mesh)
                if aux is not None:
                    auxes.append(aux)
            return x, auxes

        remat = self.cfg.remat if cache is None and \
            torch.is_grad_enabled() else "none"
        head, period, groups = self.cfg.layer_pattern() \
            if remat != "none" else (0, 1, 0)
        i = 0
        while i < len(self.layers):
            if remat != "none" and head <= i < head + period * groups:
                x, auxes = _checkpoint(run, i, i + period, x, remat=remat)
                i += period
            else:
                x, auxes = run(i, i + 1, x)
                i += 1
            for aux in auxes:
                aux_total = aux_total + aux
        return self.final_norm(x), aux_total

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

    def forward(self, tokens, *, context=None, cross_kv=None, cache=None,
                last_only: bool = False, on_mesh: Optional[OnMesh] = None):
        """The reference's ``Backbone.apply`` (``nn.Module.apply`` is taken).
        tokens: (B, N, L) when mux active else (B, L).

        Returns dict(hidden, demuxed, logits, index_embeds, aux, cache);
        ``aux`` is the MoE layers' load-balance loss summed (a float32
        zero for the dense family);
        ``demuxed``/``logits`` are (B, N, L, ·) when mux active else
        (B, L, ·).  Passing a fresh ``cache`` (``init_cache``) makes this a
        prefill: the cache is filled in place, ready for ``decode_step``.
        ``last_only``: demux + logits for the final position only (serving
        prefill never needs the N-fold demuxed tensor).
        ``context`` (B, Lc, context_dim) is encoded here
        (``encode_context``) unless ``cross_kv`` gives it encoded already
        (the serving engine encodes once per request).
        ``on_mesh`` (an ``OnMesh``) runs every MoE layer's expert-parallel
        path; the batch rows are this rank's over its ``row_axes``
        (``MoE.forward``).
        """
        mux = self.cfg.mux
        if cross_kv is None and context is not None:
            cross_kv = self.encode_context(context, on_mesh=on_mesh)
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
        h, aux = self._run_blocks(x, positions=positions, cache=cache,
                                  cross_kv=cross_kv, on_mesh=on_mesh)

        out = {"hidden": h, "index_embeds": None, "cache": cache,
               "aux": aux}
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
                    cross_kv=None, lane_mask=None, block_table=None,
                    chunk_lens=None, on_mesh: Optional[OnMesh] = None):
        """One decode step.

        tokens: (B, N) last generated token per stream when mux active,
        else (B,).  cache_index: absolute position (prefix included) being
        written — a scalar (all slots in lock-step) or a (B,) vector (each
        slot at its own position).  lane_mask: optional (B, N) 0/1 —
        retired lanes contribute nothing to the mixed stream and their
        logits are zeroed.  block_table: (B, max_pages) int32 when the
        cache is paged.  ``cross_kv``: the context K/V of
        ``encode_context``.  The cache is updated in place.
        Returns (logits, cache): logits (B, N, vocab) when mux active else
        (B, vocab).

        Chunked decode (``chunk_lens`` (B,) given): tokens carry a trailing
        chunk axis — (B, N, C) / (B, C) — and ``cache_index`` is the (B,)
        base position of each slot's chunk; slot b writes cache rows
        ``[cache_index[b], cache_index[b] + chunk_lens[b])``.  ``lane_mask``
        is then (B, N, C): a lane that is not ramping contributes its token
        at row 0 only.  Returns logits (B, N, C, vocab) / (B, C, vocab).

        ``on_mesh``: as ``forward``.
        """
        mux = self.cfg.mux
        ci = torch.as_tensor(cache_index, dtype=torch.int32,
                             device=self.device)
        if chunk_lens is not None:
            return self._chunked_decode_step(
                tokens, cache, ci,
                torch.as_tensor(chunk_lens, dtype=torch.int32,
                                device=self.device),
                index_embeds=index_embeds, cross_kv=cross_kv,
                lane_mask=lane_mask, block_table=block_table, on_mesh=on_mesh)
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
        # Row validity for the MoE dispatch: a slot with no live lane
        # carries a garbage row that must not take an expert's capacity.
        # Lock-step ``generate`` passes no lane_mask: every row is real.
        row_mask = None
        if lane_mask is not None:
            row_mask = lane_mask.bool().any(dim=1)[:, None]      # (B, 1)
        h, _ = self._run_blocks(x, positions=positions, cache=cache,
                                cache_index=ci, block_table=block_table,
                                row_mask=row_mask, cross_kv=cross_kv,
                                on_mesh=on_mesh)

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
                             index_embeds=None, cross_kv=None,
                             lane_mask=None, block_table=None,
                             on_mesh: Optional[OnMesh] = None):
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
        # Row validity for the MoE dispatch: rows at or past a slot's
        # chunk_lens are padding, and a row of a slot with no live lane at
        # that chunk position is a garbage superposition.
        row_mask = torch.arange(c, device=x.device)[None, :] < \
            chunk_lens[:, None]                                   # (B, C)
        if lane_mask is not None:
            row_mask = row_mask & lane_mask.bool().any(dim=1)
        h, _ = self._run_blocks(x, positions=positions, cache=cache,
                                cache_index=ci, block_table=block_table,
                                chunk_lens=chunk_lens, row_mask=row_mask,
                                cross_kv=cross_kv, on_mesh=on_mesh)

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
