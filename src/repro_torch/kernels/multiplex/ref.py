"""Plain PyTorch version of the fused Hadamard multiplexer (paper Eq. 1)."""
from __future__ import annotations

import torch


def hadamard_mux(x, v):
    """x: (B, N, L, d); v: (N, d) fixed Gaussian vectors.

    Returns (B, L, d) = (1/N) Σ_i v^i ⊙ x^i  — token-wise Hadamard mux.
    """
    return torch.mean(x * v[None, :, None, :].to(x.dtype), dim=1)
