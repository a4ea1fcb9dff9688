"""The numbers that decide ``correct``: gaps between what the program
produced and what the plain reference computes from the same inputs.

Every gap is relative: a scalar's |p - r| / |r|, a tensor's
||p - r|| / ||r|| (2-norms, in float64) over one instance's slab, and a
batch of instances reads its widest.  A gap that is not a number (NaN,
or a shape that differs) reads infinity, which no limit passes.
"""
from __future__ import annotations

import math

import torch


def scalar_gap(prog: float, ref: float) -> float:
    gap = abs(prog - ref) / abs(ref)
    return gap if math.isfinite(gap) else math.inf


def tensor_gap(prog, ref) -> float:
    if tuple(prog.shape) != tuple(ref.shape):
        return math.inf
    p, r = prog.double(), ref.double()
    gap = float(torch.linalg.vector_norm(p - r) /
                torch.linalg.vector_norm(r))
    return gap if math.isfinite(gap) else math.inf


def widest_instance_gap(prog, ref) -> float:
    """prog, ref (B, N, ...): the widest ``tensor_gap`` over the B·N
    instances."""
    if tuple(prog.shape) != tuple(ref.shape):
        return math.inf
    p, r = prog.double(), ref.double()
    dims = tuple(range(2, r.ndim))
    gaps = torch.linalg.vector_norm(p - r, dim=dims) / \
        torch.linalg.vector_norm(r, dim=dims)
    gap = float(gaps.max())
    return gap if math.isfinite(gap) else math.inf


def verdict(numbers: dict, limits: dict) -> tuple[bool, list]:
    """(all within their limits, [(name, value, limit), ...]) for every
    limit; a limit with no number reads infinity."""
    rows = [(name, numbers.get(name, math.inf), limit)
            for name, limit in limits.items()]
    return all(value <= limit for _, value, limit in rows), rows
