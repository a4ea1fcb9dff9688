"""Demultiplexer (paper Sec 3.2): recover N per-instance hidden states from
the backbone's mixed output h^{1:N} — the port of
``repro.core.demultiplexer``.

A compatibility shim over the strategy registry
(``repro_torch.core.strategies``): each demux family is a registered
``DemuxStrategy`` resolved by ``cfg.demux`` ("index_embed", the paper's
prefix-protocol shared MLP, or "mlp", N independent MLPs).  New code
resolves strategies with ``get_demux``.
"""
from __future__ import annotations

import torch

from repro_torch.core.strategies import get_demux


class Demultiplexer:
    @staticmethod
    def init(cfg, d: int, *, generator, device=None, dtype=torch.float32):
        return get_demux(cfg.demux).init(cfg, d, generator=generator,
                                         device=device, dtype=dtype)

    @staticmethod
    def prefix_embeddings(params, cfg, dtype):
        """Prefix embeddings (prefix-protocol demuxers only)."""
        return get_demux(cfg.demux).prefix_embeddings(params, cfg, dtype)

    @staticmethod
    def apply(params, h, cfg, *, index_embeds=None,
              use_kernel: bool | None = None):
        """h: (B, L, d) mixed output (prefix already stripped) ->
        (B, N, L, d)."""
        return get_demux(cfg.demux).apply(params, h, cfg,
                                          index_embeds=index_embeds,
                                          use_kernel=use_kernel)
