"""Strategy protocol for the DataMUX mux/demux layer (port of
``repro.core.strategies.base``).

  * ``MuxStrategy`` — the paper's fixed per-index transform φ^i plus the
    position-wise average (Eq. 1).  Implementations override ``init``
    (-> an ``nn.Module`` of parameters), ``transform`` (φ^i per index,
    (B, N, L, d) -> same), optionally ``combine``, ``kernel_apply`` (with
    ``uses_kernel = True``), ``validate`` and ``narrow``.
  * ``DemuxStrategy`` — recovers N per-instance states from the backbone's
    mixed output (paper Sec 3.2).  Implementations override ``init`` and
    ``separate``; prefix-protocol demuxers set ``uses_prefix = True`` and
    implement ``prefix_embeddings``; a fused decode epilogue sets
    ``fused_decode = True`` and overrides ``decode_apply``.

Transforms are fixed (detached) unless ``cfg.learned``.
"""
from __future__ import annotations

import torch
from torch import nn


class ParamModule(nn.Module):
    """A strategy's parameters: each tensor becomes an ``nn.Parameter`` and
    each module a submodule, under the given name."""

    def __init__(self, **items):
        super().__init__()
        for name, item in items.items():
            if isinstance(item, nn.Module):
                self.add_module(name, item)
            else:
                self.register_parameter(name, nn.Parameter(item))


class MuxStrategy:
    """Base class: φ^i per-index transform + mean combine (paper Sec 3.1)."""

    name: str = ""             # set by @register_mux
    uses_kernel: bool = False  # True -> kernel_apply implements the fused path

    # -- construction ---------------------------------------------------------

    def init(self, cfg, d: int, *, generator, device=None,
             dtype=torch.float32) -> nn.Module:
        """Build the (fixed or learned) transform params for width ``d``."""
        del cfg, d, generator, device, dtype
        return ParamModule()

    def validate(self, cfg, d: int) -> None:
        """Raise ValueError if the strategy cannot run at width ``d``."""
        del cfg, d

    def narrow(self, params, cfg, w: int):
        """Params for serving the same model at mux width ``w`` <= cfg.n.
        The base class passes params through; per-index strategies slice
        their leading N axis."""
        del cfg, w
        return params

    # -- forward --------------------------------------------------------------

    def transform(self, params, x, cfg):
        """Apply φ^i per index WITHOUT averaging: (B, N, L, d) -> same."""
        raise NotImplementedError(type(self).__name__)

    def combine(self, params, x, cfg):
        """Mixed stream (B, L, d) = (1/N) Σ_i φ^i(x^i).  Paper Eq. (1)."""
        return torch.mean(self.transform(params, x, cfg), dim=1)

    def kernel_apply(self, params, x, cfg):
        """Fused combine.  Only valid when ``uses_kernel``."""
        raise NotImplementedError(
            f"mux strategy {self.name!r} has no fused kernel path")

    def apply(self, params, x, cfg, *, use_kernel: bool | None = None):
        """combine(), routed through kernel_apply() when requested+available."""
        if use_kernel is None:
            use_kernel = getattr(cfg, "use_kernel", False)
        if use_kernel and self.uses_kernel:
            return self.kernel_apply(params, x, cfg)
        return self.combine(params, x, cfg)

    # -- helpers --------------------------------------------------------------

    @staticmethod
    def _maybe_freeze(p, cfg):
        """Detach unless the config unfreezes φ (paper A.5 'Learned')."""
        return p if getattr(cfg, "learned", False) else p.detach()


class DemuxStrategy:
    """Base class: recover (B, N, L, d) instance states from (B, L, d)."""

    name: str = ""              # set by @register_demux
    uses_kernel: bool = False
    uses_prefix: bool = False   # True -> prefix protocol + index_embeds input
    fused_decode: bool = False  # True -> decode_apply is a fused decode
                                # epilogue (ServingConfig.fuse_demux)

    # -- construction ---------------------------------------------------------

    def init(self, cfg, d: int, *, generator, device=None,
             dtype=torch.float32) -> nn.Module:
        raise NotImplementedError(type(self).__name__)

    def narrow(self, params, cfg, w: int):
        """Demux params for width ``w`` <= cfg.n (see MuxStrategy.narrow)."""
        del cfg, w
        return params

    # -- prefix protocol (only for uses_prefix strategies) ---------------------

    def prefix_embeddings(self, params, cfg, dtype):
        """(N, P, d) prefix rows prepended to each instance (paper Sec 3.2)."""
        raise NotImplementedError(
            f"demux strategy {self.name!r} has no prefix protocol")

    # -- forward --------------------------------------------------------------

    def separate(self, params, h, cfg, *, index_embeds=None):
        """h: (B, L, d) mixed output -> (B, N, L, d) per-instance states."""
        raise NotImplementedError(type(self).__name__)

    def kernel_apply(self, params, h, cfg, *, index_embeds=None):
        raise NotImplementedError(
            f"demux strategy {self.name!r} has no fused kernel path")

    def apply(self, params, h, cfg, *, index_embeds=None,
              use_kernel: bool | None = None):
        if use_kernel is None:
            use_kernel = getattr(cfg, "use_kernel", False)
        if use_kernel and self.uses_kernel:
            return self.kernel_apply(params, h, cfg,
                                     index_embeds=index_embeds)
        return self.separate(params, h, cfg, index_embeds=index_embeds)

    def decode_apply(self, params, h, cfg, *, index_embeds=None):
        """Decode-epilogue demux for a (B, C, d) hidden block.  The base
        class falls back to the ordinary ``apply``."""
        return self.apply(params, h, cfg, index_embeds=index_embeds)
