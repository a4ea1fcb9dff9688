"""MLP / CNN multiplexing on image classification (paper Sec 5, A.10,
A.11) — the port of ``repro.models.image``.

  * ``MuxMLP``: a 100-hidden-unit net; the demux layer maps hidden -> N
    groups of ``group`` units; a SHARED linear readout maps each group to
    n_classes.
  * ``MuxCNN``: LeNet-style (10@3x3 -> pool -> 16@4x4 -> pool -> 120@3x3)
    -> 84 hidden; the same demux and shared-readout structure.

Multiplexing resolves through the port's strategy registry: any
registered mux strategy whose ``validate`` passes at d = size² (identity,
ortho, lowrank, binary, hadamard, rotation, nonlinear).  Images are
flattened to one d-wide token and mixed by the strategy's plain
``combine``, as in the reference (no kernel).

Parameters keep the reference's names and layouts: raw ``(in, out)``
matrices, convolutions HWIO; ``bridge.image_params_from_jax`` carries a
reference param tree over.  The convolutions run NCHW with the weights
permuted to OIHW at use; the reference's "SAME" padding (a 4x4 kernel
padded 1 before and 2 after) and 2x2 VALID max-pooling are matched, and
the (120, 5, 5) map is flattened in H, W, C order, the reference's NHWC
order, before ``w``.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.strategies import get_mux
from repro_torch.core.strategies.base import ParamModule
from repro_torch.device import resolve_device
from repro_torch.nn import initializers


@dataclasses.dataclass(frozen=True)
class ImageMuxConfig:
    n: int = 1
    strategy: str = "ortho"      # any registered mux strategy
    size: int = 20               # image side (paper crops to 20x20)
    n_classes: int = 10
    hidden: int = 100            # MLP hidden width
    group: int = 20              # per-index demux group width (MLP; CNN: 84)
    conv_maps: int = 16          # nonlinear-mux conv channels

    @property
    def d(self) -> int:
        return self.size * self.size

    def __post_init__(self):
        if self.n < 1:
            raise ValueError(f"mux width n must be >= 1, got n={self.n}")
        strat = get_mux(self.strategy)  # raises listing registered names
        if self.n > 1:
            strat.validate(self, self.d)


# ---------------------------------------------------------------------------
# multiplexing transforms on images (registry-backed)
# ---------------------------------------------------------------------------

def init_image_mux(cfg: ImageMuxConfig, *, generator, device=None,
                   dtype=torch.float32) -> nn.Module:
    if cfg.n == 1:
        return ParamModule()
    return get_mux(cfg.strategy).init(cfg, cfg.d, generator=generator,
                                      device=device, dtype=dtype)


def apply_image_mux(params, x, cfg: ImageMuxConfig):
    """x: (B, N, H, W) -> mixed (B, H*W): one d-wide token per instance
    through the registered strategy's ``combine``."""
    b, n = x.shape[:2]
    flat = x.reshape(b, n, 1, -1)        # (B, N, L=1, d)
    if n == 1:
        return flat[:, 0, 0]
    return get_mux(cfg.strategy).combine(params, flat, cfg)[:, 0]


class _ImageModel(nn.Module):
    """Weights drawn from ``seed`` on ``device`` (the GPU unless the
    caller asks for another device), the mux's under ``mux``."""

    def __init__(self, cfg: ImageMuxConfig, *, seed: int, device):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self._kw = dict(generator=torch.Generator(device=device)
                        .manual_seed(seed), device=device)
        self.mux = init_image_mux(cfg, **self._kw)

    def _normal(self, shape, stddev):
        return nn.Parameter(initializers.normal(shape, stddev, **self._kw))

    def _zeros(self, n):
        return nn.Parameter(torch.zeros(n, device=self._kw["device"]))

    def _demux(self, h, group):
        """tanh demux to (B, N, group), then the shared readout."""
        n = self.cfg.n
        z = torch.tanh(h @ self.demux + self.bdemux)
        return z.reshape(h.shape[0], n, group) @ self.readout


# ---------------------------------------------------------------------------
# MLP (paper A.10)
# ---------------------------------------------------------------------------

class MuxMLP(_ImageModel):
    def __init__(self, cfg: ImageMuxConfig, *, seed: int = 0, device=None):
        super().__init__(cfg, seed=seed, device=device)
        h, g, n = cfg.hidden, cfg.group, cfg.n
        self.w1 = self._normal((cfg.d, h), 0.05)
        self.b1 = self._zeros(h)
        self.demux = self._normal((h, n * g), 0.05)
        self.bdemux = self._zeros(n * g)
        self.readout = self._normal((g, cfg.n_classes), 0.05)

    def forward(self, images):
        """images: (B, N, H, W) -> logits (B, N, n_classes)."""
        x = apply_image_mux(self.mux, images, self.cfg)      # (B, d)
        return self._demux(torch.tanh(x @ self.w1 + self.b1), self.cfg.group)


# ---------------------------------------------------------------------------
# CNN (paper A.10: LeNet-ish)
# ---------------------------------------------------------------------------

def _conv_same(x, w_hwio):
    """XLA's "SAME" stride-1 convolution of NCHW ``x`` by an HWIO kernel:
    each spatial axis padded (k - 1) // 2 before and the rest after."""
    kh, kw = w_hwio.shape[:2]
    x = F.pad(x, ((kw - 1) // 2, kw // 2, (kh - 1) // 2, kh // 2))
    return F.conv2d(x, w_hwio.permute(3, 2, 0, 1))


class MuxCNN(_ImageModel):
    GROUP = 84

    def __init__(self, cfg: ImageMuxConfig, *, seed: int = 0, device=None):
        super().__init__(cfg, seed=seed, device=device)
        n, g = cfg.n, self.GROUP
        self.c1 = self._normal((3, 3, 1, 10), 0.3)
        self.c2 = self._normal((4, 4, 10, 16), 0.3)
        self.c3 = self._normal((3, 3, 16, 120), 0.3)
        self.w = self._normal((120 * 25, g), 0.05)            # 5x5 tail
        self.b = self._zeros(g)
        self.demux = self._normal((g, n * g), 0.05)
        self.bdemux = self._zeros(n * g)
        self.readout = self._normal((g, cfg.n_classes), 0.05)

    def forward(self, images):
        """images: (B, N, H, W) -> logits (B, N, n_classes)."""
        b, s = images.shape[0], self.cfg.size
        x = apply_image_mux(self.mux, images, self.cfg).reshape(b, 1, s, s)
        z = F.max_pool2d(torch.tanh(_conv_same(x, self.c1)), 2)   # 10x10
        z = F.max_pool2d(torch.tanh(_conv_same(z, self.c2)), 2)   # 5x5
        z = torch.tanh(_conv_same(z, self.c3))                    # 120x5x5
        z = z.permute(0, 2, 3, 1).reshape(b, -1)                  # H, W, C
        return self._demux(torch.tanh(z @ self.w + self.b), self.GROUP)


def image_loss(logits, labels):
    """(mean cross-entropy, accuracy).  The paper (A.10) trains with tanh
    targets and MSE; the reference uses cross-entropy, and so does the
    port."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    acc = (logits.argmax(-1) == labels).float().mean()
    return nll.mean(), acc
