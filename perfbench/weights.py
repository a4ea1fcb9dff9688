"""The weights of a cell, made from ``--seed`` on the device.

One draw of N(0, 1) in the served dtype fills a flat buffer for every
weight the reference's ``param_specs`` names; each weight is a view of
it, at an offset aligned to 128 bytes (the kernels' TMA loads want 16),
scaled in place to its init.  The same dict goes to the program (loaded
into its modules by name) and to the reference.
"""
from __future__ import annotations

import math

import torch

ALIGN = 64        # elements: 128 bytes of bfloat16


def make(specs: list[tuple], seed: int, device, dtype) -> dict:
    sizes = [math.prod(shape) for _, shape, _ in specs]
    offsets, total = [], 0
    for n in sizes:
        offsets.append(total)
        total += -(-n // ALIGN) * ALIGN
    gen = torch.Generator(device=device).manual_seed(seed)
    buf = torch.randn(total, generator=gen, device=device, dtype=dtype)
    out = {}
    with torch.no_grad():
        for (name, shape, (kind, std)), off, n in zip(specs, offsets, sizes):
            t = buf[off:off + n].view(shape)
            t.mul_(std)
            if kind == "one":
                t.add_(1.0)
            elif kind != "normal":
                raise ValueError(f"{name}: unknown init {kind!r}")
            out[name] = t
    return out
