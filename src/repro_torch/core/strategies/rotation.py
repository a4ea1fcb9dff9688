"""Rotation binding: parameter-free circular-shift φ^i — the port of
``repro.core.strategies.rotation``.

φ^i = S^{r_i}, the cyclic permutation rolling the feature axis by
r_i = ⌊i·d/N⌋: maximally spread shifts, so any two instances differ by at
least ⌊d/N⌋ positions.  An exact isometry with nothing stored; φ^0 = id.
It has no kernel: ``apply`` takes the plain ``combine`` whatever
``use_kernel`` says.
"""
from __future__ import annotations

import torch

from repro_torch.core.strategies.base import MuxStrategy, ParamModule
from repro_torch.core.strategies.registry import register_mux


@register_mux("rotation")
class RotationMux(MuxStrategy):

    def validate(self, cfg, d):
        if cfg.n > 1 and d < cfg.n:
            raise ValueError(
                f"rotation mux needs d >= n for distinct shifts; "
                f"got d={d}, n={cfg.n}")

    def init(self, cfg, d, *, generator=None, device=None,
             dtype=torch.float32):
        self.validate(cfg, d)          # parameter-free: only the width
        return ParamModule()

    def transform(self, params, x, cfg):
        n, d = cfg.n, x.shape[-1]
        return torch.stack([torch.roll(x[:, i], (i * d) // n, dims=-1)
                            for i in range(n)], dim=1)
