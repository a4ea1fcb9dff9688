"""Nonlinear conv multiplexer (paper A.11, the CNN's best strategy) — the
port of ``repro.core.strategies.nonlinear``.

φ^i is a small two-layer 3x3 conv net with tanh; the mixture is the mean
of the per-index activation maps.  The paper trains the mux nets jointly,
so ``cfg.learned`` defaults to True when the config has no such field
(the image configs); a text ``MuxConfig`` carries the flag, and
``learned=False`` freezes the conv weights.

Each d-vector is viewed as a √d × √d map (d must be a perfect square);
``cfg.conv_maps`` (default 16) sets the hidden channels.  The weights keep
the reference's HWIO layouts, ``w1`` (N, 3, 3, 1, c) and ``w2`` (N, 3, 3,
c, 1), so the bridge carries names and values over; ``transform``
permutes them to OIHW for ``conv2d``.  It has no kernel: ``apply`` takes
the plain ``combine`` whatever ``use_kernel`` says.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.strategies.base import MuxStrategy, ParamModule
from repro_torch.core.strategies.registry import register_mux
from repro_torch.nn import initializers


def _side(d: int) -> int:
    s = math.isqrt(d)
    if s * s != d:
        raise ValueError(
            f"nonlinear mux views features as a square map; d={d} is not a "
            f"perfect square")
    return s


@register_mux("nonlinear")
class NonlinearConvMux(MuxStrategy):

    def validate(self, cfg, d):
        _side(d)

    def init(self, cfg, d, *, generator, device=None, dtype=torch.float32):
        self.validate(cfg, d)
        n, c = cfg.n, getattr(cfg, "conv_maps", 16)
        kw = dict(generator=generator, device=device, dtype=dtype)
        return ParamModule(
            w1=initializers.normal((n, 3, 3, 1, c), 0.3, **kw),
            w2=initializers.normal((n, 3, 3, c, 1), 0.3, **kw))

    def narrow(self, params, cfg, w):
        return ParamModule(w1=params.w1[:w], w2=params.w2[:w])

    def transform(self, params, x, cfg):
        b, n, length, d = x.shape
        s = _side(d)
        w1, w2 = params.w1.to(x.dtype), params.w2.to(x.dtype)
        if not getattr(cfg, "learned", True):   # image configs: learned
            w1, w2 = w1.detach(), w2.detach()
        outs = []
        for i in range(n):
            img = x[:, i].reshape(b * length, 1, s, s)
            z = torch.tanh(F.conv2d(img, w1[i].permute(3, 2, 0, 1),
                                    padding=1))
            z = torch.tanh(F.conv2d(z, w2[i].permute(3, 2, 0, 1),
                                    padding=1))
            outs.append(z.reshape(b, length, d))
        return torch.stack(outs, dim=1)
