"""Parameter initializers.  Each draws from an explicit ``torch.Generator``
on the tensor's device.  They follow the reference's distributions but not
its random bits: parity with the JAX package goes through
``repro_torch.bridge``, not through matched RNG."""
from __future__ import annotations

import math

import torch


def normal(shape, stddev: float, *, generator, device=None,
           dtype=torch.float32):
    x = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return (stddev * x).to(dtype)


def scaled_normal(shape, fan_in: int, *, generator, device=None,
                  dtype=torch.float32):
    """1/sqrt(fan_in) normal — standard transformer projection init."""
    return normal(shape, 1.0 / math.sqrt(fan_in), generator=generator,
                  device=device, dtype=dtype)


def random_orthogonal(d: int, *, generator, device=None,
                      dtype=torch.float32):
    """A d x d random orthogonal matrix (QR of a Gaussian, sign-fixed so the
    distribution is Haar-uniform).  Used by the "ortho" and "lowrank" mux
    strategies (paper Sec 3.1, A.10)."""
    g = torch.randn((d, d), generator=generator, device=device,
                    dtype=torch.float32)
    q, r = torch.linalg.qr(g)
    q = q * torch.sign(torch.diagonal(r))[None, :]
    return q.to(dtype)
