"""Multiplexer Φ (paper Sec 3.1):  x^{1:N} = (1/N) Σ_i φ^i(x^i) — the port
of ``repro.core.multiplexer``.

A compatibility shim over the strategy registry
(``repro_torch.core.strategies``): each φ^i family is a registered
``MuxStrategy`` resolved by ``cfg.strategy``.  Kept for static-method call
sites; new code resolves strategies with ``get_mux``.
"""
from __future__ import annotations

import torch

from repro_torch.core.strategies import get_mux


class Multiplexer:
    @staticmethod
    def init(cfg, d: int, *, generator, device=None, dtype=torch.float32):
        return get_mux(cfg.strategy).init(cfg, d, generator=generator,
                                          device=device, dtype=dtype)

    @staticmethod
    def transform(params, x, cfg):
        """Apply φ^i per index WITHOUT averaging.  x: (B, N, L, d) -> same."""
        return get_mux(cfg.strategy).transform(params, x, cfg)

    @staticmethod
    def apply(params, x, cfg, *, use_kernel: bool | None = None):
        """x: (B, N, L, d) -> mixed (B, L, d).  Paper Eq. (1)."""
        return get_mux(cfg.strategy).apply(params, x, cfg,
                                           use_kernel=use_kernel)
