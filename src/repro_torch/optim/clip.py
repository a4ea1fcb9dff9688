"""Gradient clipping by global norm — the port of ``repro.optim.clip``,
over a dict of tensors."""
from __future__ import annotations

import torch


def global_norm(tree: dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in float32 (0-d)."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree.values()))


def clip_by_global_norm(tree: dict[str, torch.Tensor], max_norm: float):
    """(clipped, norm): every tensor scaled by min(1, max_norm / (norm +
    1e-6)) in float32 and cast back to its dtype."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return {k: (g.float() * scale).to(g.dtype) for k, g in tree.items()}, \
        norm
