"""The paper's linear φ^i strategies (Sec 3.1, A.5, A.10).

  * "hadamard" — elementwise product with a fixed Gaussian vector v^i
  * "ortho"    — fixed random orthogonal matrix O^i
  * "lowrank"  — N low-rank independent-subspace maps φ^i = Q U_iᵀ U_i
  * "binary"   — binary mask selecting the i-th d/N chunk
  * "identity" — φ^i = id (order-unidentifiable baseline)
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.strategies.base import MuxStrategy, ParamModule
from repro_torch.core.strategies.registry import register_mux
from repro_torch.nn import initializers


@register_mux("identity")
class IdentityMux(MuxStrategy):
    """φ^i = id: plain averaging, cannot recover instance order."""

    def transform(self, params, x, cfg):
        return x


@register_mux("hadamard")
class HadamardMux(MuxStrategy):
    """Fixed Gaussian vectors v^i, φ^i(x) = v^i ⊙ x (paper's main config)."""

    uses_kernel = True

    def init(self, cfg, d, *, generator, device=None, dtype=torch.float32):
        return ParamModule(v=initializers.normal(
            (cfg.n, d), 1.0, generator=generator, device=device, dtype=dtype))

    def narrow(self, params, cfg, w):
        return ParamModule(v=params.v[:w])

    def transform(self, params, x, cfg):
        v = self._maybe_freeze(params.v.to(x.dtype), cfg)
        return x * v[None, :, None, :]

    def kernel_apply(self, params, x, cfg):
        from repro_torch.kernels.multiplex import ops as mux_ops
        v = self._maybe_freeze(params.v.to(x.dtype), cfg)
        return mux_ops.hadamard_mux(x, v)


@register_mux("ortho")
class OrthoMux(MuxStrategy):
    """Fixed random orthogonal matrices O^i — isometric per-index binding."""

    def init(self, cfg, d, *, generator, device=None, dtype=torch.float32):
        mats = torch.stack([
            initializers.random_orthogonal(d, generator=generator,
                                           device=device)
            for _ in range(cfg.n)])
        return ParamModule(o=mats.to(dtype))

    def narrow(self, params, cfg, w):
        return ParamModule(o=params.o[:w])

    def transform(self, params, x, cfg):
        o = self._maybe_freeze(params.o.to(x.dtype), cfg)
        return torch.einsum("bnld,nde->bnle", x, o)


@register_mux("lowrank")
class LowRankMux(MuxStrategy):
    """Independent-subspace maps φ^i = Q U_iᵀ U_i (paper A.10).  When
    d % n != 0 the trailing orthonormal rows are dropped."""

    def validate(self, cfg, d):
        if d // cfg.n == 0:
            raise ValueError(
                f"lowrank mux needs d >= n so each instance gets a non-empty "
                f"subspace; got d={d}, n={cfg.n}")

    def init(self, cfg, d, *, generator, device=None, dtype=torch.float32):
        self.validate(cfg, d)
        u = initializers.random_orthogonal(d, generator=generator,
                                           device=device)
        q = initializers.random_orthogonal(d, generator=generator,
                                           device=device)
        return ParamModule(u=u.to(dtype), q=q.to(dtype))

    def narrow(self, params, cfg, w):
        # Keep the native subspace rank r = d // n and the first w subspaces.
        r = params.u.shape[0] // cfg.n
        return ParamModule(u=params.u[: w * r], q=params.q)

    def transform(self, params, x, cfg):
        u = self._maybe_freeze(params.u.to(x.dtype), cfg)
        q = self._maybe_freeze(params.q.to(x.dtype), cfg)
        n = cfg.n
        r = u.shape[0] // n
        ui = u[: n * r].reshape(n, r, -1)                 # (N, r, d)
        proj = torch.einsum("bnld,nrd->bnlr", x, ui)      # subspace coords
        back = torch.einsum("bnlr,nrd->bnld", proj, ui)   # U_iᵀ U_i x
        return torch.einsum("bnld,de->bnle", back, q)


@register_mux("binary")
class BinaryMux(MuxStrategy):
    """Binary mask keeping the i-th d/N chunk — lossless concat (paper A.5)."""

    def validate(self, cfg, d):
        if d % cfg.n:
            raise ValueError(
                f"binary mux needs d % n == 0 so the chunks partition the "
                f"width; got d={d}, n={cfg.n}")

    def init(self, cfg, d, *, generator=None, device=None,
             dtype=torch.float32):
        self.validate(cfg, d)
        r = d // cfg.n
        mask = torch.zeros((cfg.n, d), device=device, dtype=dtype)
        for i in range(cfg.n):
            mask[i, i * r:(i + 1) * r] = 1.0
        return ParamModule(mask=mask)

    def narrow(self, params, cfg, w):
        # Rebuild at d/w so the w lanes partition the full width.
        mask = params.mask
        return self.init(dataclasses.replace(cfg, n=w), mask.shape[-1],
                         device=mask.device, dtype=mask.dtype)

    def transform(self, params, x, cfg):
        m = self._maybe_freeze(params.mask.to(x.dtype), cfg)
        return x * m[None, :, None, :]
